"""Stacked dynamic-LSTM sentiment model.

Counterpart of ``paddle_tpu/models/stacked_lstm.py``, line for line.
Reference parity: ``benchmark/fluid/models/stacked_dynamic_lstm.py`` (IMDB
sentiment: embedding -> fc -> stacked LSTM layers -> pooled -> softmax).
Dense-padded regime: input is [batch, seq_len] token ids + [batch] lengths
instead of an LoD tensor.
"""

import paddle_tpu_torch as fluid


def build(
    seq_len=80,
    dict_size=5000,
    emb_dim=64,
    hid_dim=64,
    stacked_num=3,
    class_num=2,
):
    data = fluid.layers.data(name="words", shape=[seq_len], dtype="int64")
    length = fluid.layers.data(name="length", shape=[1], dtype="int64")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")

    emb = fluid.layers.embedding(
        input=data, size=[dict_size, emb_dim], is_sparse=False
    )

    fc1 = fluid.layers.fc(input=emb, size=hid_dim * 4, num_flatten_dims=2)
    lstm1, _ = fluid.layers.dynamic_lstm(
        input=fc1, size=hid_dim * 4, length=length
    )

    inputs = [fc1, lstm1]
    for _ in range(2, stacked_num + 1):
        fc = fluid.layers.fc(
            input=inputs, size=hid_dim * 4, num_flatten_dims=2
        )
        lstm, _ = fluid.layers.dynamic_lstm(
            input=fc, size=hid_dim * 4, length=length, is_reverse=False
        )
        inputs = [fc, lstm]

    fc_last = fluid.layers.sequence_pool(
        input=inputs[0], pool_type="max", length=length
    )
    lstm_last = fluid.layers.sequence_pool(
        input=inputs[1], pool_type="max", length=length
    )

    prediction = fluid.layers.fc(
        input=[fc_last, lstm_last], size=class_num, act="softmax"
    )
    cost = fluid.layers.cross_entropy(input=prediction, label=label)
    avg_cost = fluid.layers.mean(cost)
    acc = fluid.layers.accuracy(input=prediction, label=label)
    return avg_cost, [data, length, label], {
        "accuracy": acc,
        "predict": prediction,
    }
