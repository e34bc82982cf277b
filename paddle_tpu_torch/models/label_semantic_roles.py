"""The semantic role labeller of the PaddlePaddle book, chapter 7
(``label_semantic_roles``, the ``db_lstm`` network): a deep
bidirectional LSTM over eight embeddings, a linear-chain CRF on top,
Viterbi decoding and IOB chunk evaluation.

The JAX package has no such model file; its capability is tested at toy
size in ``tests/test_book.py``. ``build`` takes the framework module
(``paddle_tpu_torch`` by default), so that the same network is built
through either package. Dense-padded regime: every input is ``[batch,
max_len]`` ids plus ``[batch, 1]`` lengths instead of an LoD tensor.
The book's CoNLL-2005 dictionaries: 44,068 words, 3,162 predicates, 59
labels (29 chunk types in IOB, and O); word_dim 32, mark_dim 5,
hidden_dim 512, depth 8.
"""

import math

WORD_DICT, PRED_DICT, LABEL_DICT, MARK_DICT = 44068, 3162, 59, 2
WORD_INPUTS = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2")


def db_lstm(fluid, ids, length, word_dict_len=WORD_DICT,
            pred_dict_len=PRED_DICT, label_dict_len=LABEL_DICT, word_dim=32,
            mark_dim=5, hidden_dim=512, depth=8):
    """The book's ``db_lstm``: the emissions ``[B, T, label_dict_len]``.
    ``ids`` maps the six word inputs, ``predicate`` and ``mark`` to
    their data variables. Each LSTM has ``size=hidden_dim`` (so
    ``hidden_dim / 4`` hidden units), a relu candidate and a sigmoid
    cell activation; from the second on they alternate direction."""
    L = fluid.layers
    pred_emb = L.embedding(input=ids["predicate"],
                           size=[pred_dict_len, word_dim], dtype="float32",
                           param_attr="vemb")
    mark_emb = L.embedding(input=ids["mark"], size=[MARK_DICT, mark_dim],
                           dtype="float32")
    emb_layers = [L.embedding(size=[word_dict_len, word_dim],
                              input=ids[name],
                              param_attr=fluid.ParamAttr(name="emb",
                                                         trainable=False))
                  for name in WORD_INPUTS]
    emb_layers += [pred_emb, mark_emb]
    hidden_0 = L.fc(input=emb_layers, size=hidden_dim, act="tanh",
                    num_flatten_dims=2)
    lstm_0, _ = L.dynamic_lstm(input=hidden_0, size=hidden_dim,
                               length=length, candidate_activation="relu",
                               gate_activation="sigmoid",
                               cell_activation="sigmoid")
    input_tmp = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix_hidden = L.sums(input=[
            L.fc(input=input_tmp[0], size=hidden_dim, act="tanh",
                 num_flatten_dims=2),
            L.fc(input=input_tmp[1], size=hidden_dim, act="tanh",
                 num_flatten_dims=2)])
        lstm, _ = L.dynamic_lstm(input=mix_hidden, size=hidden_dim,
                                 length=length,
                                 candidate_activation="relu",
                                 gate_activation="sigmoid",
                                 cell_activation="sigmoid",
                                 is_reverse=(i % 2) == 1)
        input_tmp = [mix_hidden, lstm]
    return L.sums(input=[
        L.fc(input=input_tmp[0], size=label_dict_len, act="tanh",
             num_flatten_dims=2),
        L.fc(input=input_tmp[1], size=label_dict_len, act="tanh",
             num_flatten_dims=2)])


def build(fluid=None, max_len=80, word_dict_len=WORD_DICT,
          pred_dict_len=PRED_DICT, label_dict_len=LABEL_DICT, word_dim=32,
          mark_dim=5, hidden_dim=512, depth=8, crf_lr=1e-3):
    """Data layers, ``db_lstm``, the CRF cost and its mean, the Viterbi
    path and ``chunk_eval`` (IOB, ``ceil((labels - 1) / 2)`` chunk
    types). Returns (avg_cost, feeds: name -> variable, extras: feature,
    decode, chunk metrics)."""
    if fluid is None:
        import paddle_tpu_torch as fluid
    L = fluid.layers
    feeds = {name: L.data(name=name, shape=[max_len], dtype="int64")
             for name in WORD_INPUTS + ("predicate", "mark", "target")}
    length = L.data(name="length", shape=[1], dtype="int64")
    feeds["length"] = length
    feature = db_lstm(fluid, feeds, length, word_dict_len, pred_dict_len,
                      label_dict_len, word_dim, mark_dim, hidden_dim, depth)
    crf_cost = L.linear_chain_crf(
        input=feature, label=feeds["target"], length=length,
        param_attr=fluid.ParamAttr(name="crfw", learning_rate=crf_lr))
    avg_cost = L.mean(crf_cost)
    decode = L.crf_decoding(input=feature,
                            param_attr=fluid.ParamAttr(name="crfw"),
                            length=length)
    chunks = L.chunk_eval(
        input=decode, label=feeds["target"], chunk_scheme="IOB",
        num_chunk_types=int(math.ceil((label_dict_len - 1) / 2.0)),
        length=length)
    return avg_cost, feeds, dict(feature=feature, decode=decode,
                                 chunk=chunks)


def iob_batch(np, rng, batch, max_len, min_len, word_dict_len=WORD_DICT,
              pred_dict_len=PRED_DICT, label_dict_len=LABEL_DICT):
    """One padded batch drawn from ``rng``: lengths ``min_len..max_len``,
    ids uniform over the dictionaries (the context words of a row its
    word ids shifted, the predicate one id a row, the mark 1 on a window
    around the predicate), targets valid IOB sequences (tag 2 c begins a
    chunk of type c, 2 c + 1 continues it, ``label_dict_len - 1`` is O).
    Past each length every id is 0."""
    n_types = (label_dict_len - 1) // 2
    lens = rng.randint(min_len, max_len + 1, batch)
    word = rng.randint(0, word_dict_len, (batch, max_len))
    pred_pos = (rng.rand(batch) * lens).astype("int64")
    feed = {}
    for k, name in enumerate(WORD_INPUTS[1:]):
        shift = k - 2
        ctx = word[np.arange(batch), np.clip(pred_pos + shift, 0,
                                             max_len - 1)]
        feed[name] = np.repeat(ctx[:, None], max_len, 1)
    feed["word"] = word
    feed["predicate"] = np.repeat(rng.randint(0, pred_dict_len, batch)[
        :, None], max_len, 1)
    pos = np.arange(max_len)[None, :]
    feed["mark"] = (np.abs(pos - pred_pos[:, None]) <= 2).astype("int64")
    target = np.full((batch, max_len), label_dict_len - 1)
    for i in range(batch):
        t = 0
        while t < lens[i]:
            if rng.rand() < 0.4:
                c = rng.randint(n_types)
                n = min(rng.randint(1, 6), lens[i] - t)
                target[i, t] = 2 * c
                target[i, t + 1:t + n] = 2 * c + 1
                t += n
            else:
                t += 1
    feed["target"] = target
    live = pos < lens[:, None]
    feed = {k: np.where(live, v, 0).astype("int64") for k, v in feed.items()}
    feed["length"] = lens.reshape(-1, 1).astype("int64")
    return feed
