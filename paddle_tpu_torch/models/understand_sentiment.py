"""The sentiment classifiers of the PaddlePaddle book, chapter 6
(``understand_sentiment``): ``convolution_net`` (an embedding, two
``nets.sequence_conv_pool`` branches, windows 3 and 4, tanh, sqrt
pooling, a softmax ``fc`` over both) and ``dyn_rnn_lstm`` (the book
test's LSTM written out of ``fc`` gates inside a ``DynamicRNN`` step,
``python/paddle/fluid/tests/book/test_understand_sentiment.py``: an
embedding of 32, a tanh ``fc`` of 128, the step, the last step, a
softmax ``fc``); cross entropy, Adagrad.

The JAX package has no such model file. ``build`` (the CNN) and
``build_lstm`` take the framework module (``paddle_tpu_torch`` by
default), so that the same network is built through either package.
Padded layout: the words are ``[batch, max_len]`` ids plus ``[batch, 1]``
lengths instead of an LoD tensor. The book's widths: the IMDB
``word_dict()`` at its cutoff of 150 (5,148 ids with ``<unk>``),
embedding 128, ``hid_dim`` 512, 2 classes, batch 128,
``Adagrad(0.002)``.
"""

WORD_DICT, EMB_DIM, HID_DIM, CLASS_DIM = 5148, 128, 512, 2
LEARNING_RATE = 0.002
# dyn_rnn_lstm's widths in the book test
LSTM_EMB_DIM, LSTM_SIZE = 32, 128


def convolution_net(fluid, data, length, input_dim=WORD_DICT,
                    class_dim=CLASS_DIM, emb_dim=EMB_DIM, hid_dim=HID_DIM):
    """The book's ``convolution_net``: the class probabilities
    ``[B, class_dim]``."""
    emb = fluid.layers.embedding(input=data, size=[input_dim, emb_dim],
                                 is_sparse=True)
    conv_3 = fluid.nets.sequence_conv_pool(
        input=emb, num_filters=hid_dim, filter_size=3, act="tanh",
        pool_type="sqrt", length=length)
    conv_4 = fluid.nets.sequence_conv_pool(
        input=emb, num_filters=hid_dim, filter_size=4, act="tanh",
        pool_type="sqrt", length=length)
    return fluid.layers.fc(input=[conv_3, conv_4], size=class_dim,
                           act="softmax")


def dyn_rnn_lstm(fluid, data, length, input_dim=WORD_DICT,
                 class_dim=CLASS_DIM, emb_dim=LSTM_EMB_DIM,
                 lstm_size=LSTM_SIZE):
    """The book test's ``dyn_rnn_lstm``: the class probabilities
    ``[B, class_dim]``. Each of the four gates is the sum of two ``fc``s
    (the word's, with a bias, and the previous hidden state's, without);
    the cell and hidden states are the step's memories. The padded words
    ``[B, T, E]`` go through ``fc(num_flatten_dims=2)``; ``DynamicRNN``
    masks every step past a sentence's ``length``, so the last step is
    taken at each sentence's length. The upstream ``memory(value=...)``
    keyword is ``init_value`` in both packages."""
    L = fluid.layers
    emb = L.embedding(input=data, size=[input_dim, emb_dim], is_sparse=True)
    sentence = L.fc(input=emb, size=lstm_size, act="tanh",
                    num_flatten_dims=2)
    rnn = L.DynamicRNN(lengths=length)
    with rnn.block():
        word = rnn.step_input(sentence)
        prev_hidden = rnn.memory(shape=[-1, lstm_size], batch_ref=sentence,
                                 init_value=0.0)
        prev_cell = rnn.memory(shape=[-1, lstm_size], batch_ref=sentence,
                               init_value=0.0)

        def gate_common(ipt, hidden, size):
            gate0 = L.fc(input=ipt, size=size, bias_attr=True)
            gate1 = L.fc(input=hidden, size=size, bias_attr=False)
            return gate0 + gate1

        forget_gate = L.sigmoid(x=gate_common(word, prev_hidden, lstm_size))
        input_gate = L.sigmoid(x=gate_common(word, prev_hidden, lstm_size))
        output_gate = L.sigmoid(x=gate_common(word, prev_hidden, lstm_size))
        cell_gate = L.sigmoid(x=gate_common(word, prev_hidden, lstm_size))
        cell = forget_gate * prev_cell + input_gate * cell_gate
        hidden = output_gate * L.tanh(x=cell)
        rnn.update_memory(prev_cell, cell)
        rnn.update_memory(prev_hidden, hidden)
        rnn.output(hidden)
    last = L.sequence_last_step(rnn(), length=length)
    return L.fc(input=last, size=class_dim, act="softmax")


def _classifier(fluid, max_len, network):
    """Data layers (``words``, ``length``, ``label``), ``network(words,
    length)``'s class probabilities, their mean cross entropy and
    accuracy: (avg_cost, accuracy, prediction)."""
    if fluid is None:
        import paddle_tpu_torch as fluid
    L = fluid.layers
    words = L.data(name="words", shape=[max_len], dtype="int64")
    length = L.data(name="length", shape=[1], dtype="int64")
    label = L.data(name="label", shape=[1], dtype="int64")
    prediction = network(fluid, words, length)
    cost = L.cross_entropy(input=prediction, label=label)
    avg_cost = L.mean(cost)
    accuracy = L.accuracy(input=prediction, label=label)
    return avg_cost, accuracy, prediction


def build(fluid=None, max_len=600, input_dim=WORD_DICT, class_dim=CLASS_DIM,
          emb_dim=EMB_DIM, hid_dim=HID_DIM):
    """``convolution_net``'s classifier: (avg_cost, accuracy,
    prediction); the caller clones for test and minimizes."""
    return _classifier(fluid, max_len, lambda fluid, words, length:
                       convolution_net(fluid, words, length, input_dim,
                                       class_dim, emb_dim, hid_dim))


def build_lstm(fluid=None, max_len=600, input_dim=WORD_DICT,
               class_dim=CLASS_DIM, emb_dim=LSTM_EMB_DIM,
               lstm_size=LSTM_SIZE):
    """``dyn_rnn_lstm``'s classifier: (avg_cost, accuracy, prediction);
    the caller clones for test and minimizes."""
    return _classifier(fluid, max_len, lambda fluid, words, length:
                       dyn_rnn_lstm(fluid, words, length, input_dim,
                                    class_dim, emb_dim, lstm_size))


def batch(np, rng, size, max_len, min_len, input_dim=WORD_DICT,
          class_dim=CLASS_DIM):
    """One padded batch drawn from ``rng``: lengths ``min_len..max_len``,
    ids uniform over the dictionary (0 past each length), labels uniform
    over the classes."""
    lens = rng.randint(min_len, max_len + 1, size)
    words = rng.randint(0, input_dim, (size, max_len))
    words[np.arange(max_len)[None, :] >= lens[:, None]] = 0
    return {"words": words.astype("int64"),
            "length": lens.reshape(size, 1).astype("int64"),
            "label": rng.randint(0, class_dim, (size, 1)).astype("int64")}
