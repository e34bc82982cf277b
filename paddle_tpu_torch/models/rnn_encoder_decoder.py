"""The RNN encoder-decoder of the PaddlePaddle book's machine translation
test (``python/paddle/fluid/tests/book/test_machine_translation.py``:
``encoder`` and ``decoder_train``).

The encoder is a tanh ``fc`` over the source embedding, ``dynamic_lstm``
(B6 on the card) and the last step. The decoder is a ``DynamicRNN``
whose memory starts at the encoder's output (``memory(init=context)``);
its step is ``fc([word, state], decoder_size, tanh)`` and a softmax
``fc`` over the target dictionary. Source and target share the embedding
``vemb``, as upstream. The book's widths: ``dict_size`` 30,000,
``word_dim`` 16, ``hidden_dim`` = ``decoder_size`` 32, ``Adagrad(1e-4)``
with ``L2Decay(0.1)``.

The JAX package has no such model file: ``build`` takes the framework
module, so the same network is built through either package. Padded
layout: source and target are ``[batch, max_len]`` ids with ``[batch,
1]`` lengths instead of LoD tensors. Upstream's LoD batch holds no
padded position, so its mean cross entropy is over real tokens; here the
per-token ``cross_entropy`` is weighted by ``sequence_mask(target
length)`` and divided by the token count, the same mean. Beam decode
(``decoder_decode``: ``While`` and ``beam_search``) is not built here.
"""

DICT_SIZE, WORD_DIM, HIDDEN_DIM = 30000, 16, 32
DECODER_SIZE = HIDDEN_DIM
LEARNING_RATE, L2_COEFF = 1e-4, 0.1


def encoder(fluid, src, src_len, dict_size=DICT_SIZE, word_dim=WORD_DIM,
            hidden_dim=HIDDEN_DIM, is_sparse=False):
    """The encoder's context ``[B, hidden_dim]``: the LSTM's hidden state
    at each source sentence's last word."""
    L = fluid.layers
    src_embedding = L.embedding(
        input=src, size=[dict_size, word_dim], dtype="float32",
        is_sparse=is_sparse, param_attr=fluid.ParamAttr(name="vemb"))
    fc1 = L.fc(input=src_embedding, size=hidden_dim * 4, act="tanh",
               num_flatten_dims=2)
    lstm_hidden0, _ = L.dynamic_lstm(input=fc1, size=hidden_dim * 4,
                                     length=src_len)
    return L.sequence_last_step(input=lstm_hidden0, length=src_len)


def decoder_train(fluid, context, trg, trg_len, dict_size=DICT_SIZE,
                  word_dim=WORD_DIM, decoder_size=DECODER_SIZE,
                  is_sparse=False):
    """The training decoder: the target dictionary's probabilities
    ``[B, T, dict_size]`` at every target position (0 past each
    sentence's length)."""
    L = fluid.layers
    trg_embedding = L.embedding(
        input=trg, size=[dict_size, word_dim], dtype="float32",
        is_sparse=is_sparse, param_attr=fluid.ParamAttr(name="vemb"))
    rnn = L.DynamicRNN(lengths=trg_len)
    with rnn.block():
        current_word = rnn.step_input(trg_embedding)
        pre_state = rnn.memory(init=context)
        current_state = L.fc(input=[current_word, pre_state],
                             size=decoder_size, act="tanh")
        current_score = L.fc(input=current_state, size=dict_size,
                             act="softmax")
        rnn.update_memory(pre_state, current_state)
        rnn.output(current_score)
    return rnn()


def build(fluid=None, max_src_len=50, max_trg_len=50, dict_size=DICT_SIZE,
          word_dim=WORD_DIM, hidden_dim=HIDDEN_DIM, is_sparse=False):
    """Data layers (``src_word_id``, ``src_length``,
    ``target_language_word``, ``target_length``,
    ``target_language_next_word``), the network and its mean per-token
    cross entropy. Returns (avg_cost, prediction); the caller
    minimizes."""
    if fluid is None:
        import paddle_tpu_torch as fluid
    L = fluid.layers
    src = L.data(name="src_word_id", shape=[max_src_len], dtype="int64")
    src_len = L.data(name="src_length", shape=[1], dtype="int64")
    trg = L.data(name="target_language_word", shape=[max_trg_len],
                 dtype="int64")
    trg_len = L.data(name="target_length", shape=[1], dtype="int64")
    label = L.data(name="target_language_next_word",
                   shape=[max_trg_len, 1], dtype="int64")
    context = encoder(fluid, src, src_len, dict_size, word_dim, hidden_dim,
                      is_sparse)
    rnn_out = decoder_train(fluid, context, trg, trg_len, dict_size,
                            word_dim, hidden_dim, is_sparse)
    cost = L.cross_entropy(input=rnn_out, label=label)
    mask = L.sequence_mask(trg_len, maxlen=max_trg_len, dtype="float32")
    tokens = L.reduce_sum(mask)
    avg_cost = L.reduce_sum(L.reshape(cost, shape=[-1, max_trg_len]) * mask
                            ) / tokens
    return avg_cost, rnn_out


def optimizer(fluid):
    """The book test's optimizer: ``Adagrad(1e-4)`` with
    ``L2Decay(0.1)``."""
    return fluid.optimizer.Adagrad(
        learning_rate=LEARNING_RATE,
        regularization=fluid.regularizer.L2Decay(L2_COEFF))


def batch(np, rng, size, max_len, min_len, dict_size=DICT_SIZE):
    """One padded batch drawn from ``rng``: source and target lengths
    ``min_len..max_len``, ids uniform over the dictionary (0 past each
    length), the next word the target shifted by one."""
    def ids(lens):
        out = rng.randint(1, dict_size, (size, max_len + 1))
        out[np.arange(max_len + 1)[None, :] >= lens[:, None] + 1] = 0
        return out

    src_lens = rng.randint(min_len, max_len + 1, size)
    trg_lens = rng.randint(min_len, max_len + 1, size)
    src = ids(src_lens)[:, :max_len]
    trg = ids(trg_lens)
    return {"src_word_id": src.astype("int64"),
            "src_length": src_lens.reshape(size, 1).astype("int64"),
            "target_language_word": trg[:, :max_len].astype("int64"),
            "target_length": trg_lens.reshape(size, 1).astype("int64"),
            "target_language_next_word": trg[:, 1:, None].astype("int64")}
