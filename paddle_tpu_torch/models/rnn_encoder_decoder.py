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
length)`` and divided by the token count, the same mean.

``decoder_decode`` is the book's beam decoder, written to the dense
beam API: a ``While`` bounded at ``max_length`` steps (so that
``run_multi_step`` captures it on a card) that reads the previous ids,
scores and state from tensor arrays, embeds the ids (``vemb``), updates
the state with ``fc(tanh)``, scores the dictionary with a softmax ``fc``
reshaped to ``[B, K, V]``, selects with ``beam_search(is_accumulated=
False)``, gathers the state by parent, and writes ids, parents, scores
and state back; ``beam_search_decode`` backtracks after the loop.
Upstream's LoD ``topk`` pre-selection before ``beam_search`` (which keeps
the LoD candidate lists short) has no counterpart in the dense op, which
ranks the whole ``[K * V]`` row, and the dense loop runs all
``max_length`` steps where upstream stops once every candidate list is
empty (a finished beam is frozen at ``end_id`` instead).
"""

DICT_SIZE, WORD_DIM, HIDDEN_DIM = 30000, 16, 32
DECODER_SIZE = HIDDEN_DIM
LEARNING_RATE, L2_COEFF = 1e-4, 0.1
BEAM_SIZE, MAX_LENGTH, END_ID = 2, 8, 10


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


def _read(L, array, i, shape):
    """``array[i]``, with the element's shape declared: a tensor array has
    no build-time shape, and ``fc`` sizes its weight from its input's."""
    out = L.array_read(array=array, i=i)
    out.shape = tuple(shape)
    return out


def decoder_decode(fluid, context, src_len, batch_size, dict_size=DICT_SIZE,
                   word_dim=WORD_DIM, decoder_size=DECODER_SIZE,
                   beam_size=BEAM_SIZE, max_length=MAX_LENGTH, end_id=END_ID,
                   is_sparse=False):
    """The beam decoder over the encoder's ``context`` ``[batch_size,
    decoder_size]``, fed ``init_ids`` / ``init_scores`` ``[B, K]`` (see
    ``init_beams``). Returns (translation_ids, translation_scores), each
    ``[B, K, max_length + 1]``: each hypothesis's ids from the start id
    on, and the accumulated score after each step."""
    L = fluid.layers
    K = int(beam_size)
    cap = int(max_length) + 1
    # each source's context tiled over its K hypotheses: [B * K, H]
    init_state = L.reshape(
        L.expand(L.unsqueeze(context, axes=[1]), expand_times=[1, K, 1]),
        shape=[-1, decoder_size])
    array_len = L.fill_constant(shape=[1], dtype="int64", value=max_length)
    counter = L.fill_constant(shape=[1], dtype="int64", value=0)
    init_ids = L.data(name="init_ids", shape=[K], dtype="int64")
    init_scores = L.data(name="init_scores", shape=[K], dtype="float32")
    state_array = L.array_write(init_state, counter, capacity=cap)
    ids_array = L.array_write(init_ids, counter, capacity=cap)
    scores_array = L.array_write(init_scores, counter, capacity=cap)
    parents_array = L.array_write(L.zeros_like(init_ids), counter,
                                  capacity=cap)
    # the first row of each source's lane: the parent gather's offset
    lane_base = L.expand(
        L.reshape(L.range(0, int(batch_size) * K, K, "int64"),
                  shape=[-1, 1]), expand_times=[1, K])
    cond = L.less_than(x=counter, y=array_len)
    loop = L.While(cond=cond, max_iterations=int(max_length))
    with loop.block():
        pre_ids = _read(L, ids_array, counter, [-1, K])
        pre_state = _read(L, state_array, counter, [-1, decoder_size])
        pre_score = _read(L, scores_array, counter, [-1, K])
        pre_ids_emb = L.embedding(
            input=L.reshape(pre_ids, shape=[-1, 1]),
            size=[dict_size, word_dim], dtype="float32",
            is_sparse=is_sparse, param_attr=fluid.ParamAttr(name="vemb"))
        current_state = L.fc(input=[pre_state, pre_ids_emb],
                             size=decoder_size, act="tanh")
        current_score = L.fc(input=current_state, size=dict_size,
                             act="softmax")
        selected_ids, selected_scores, parent = L.beam_search(
            pre_ids, pre_score,
            L.reshape(current_score, shape=[-1, K, dict_size]),
            beam_size=K, end_id=end_id, is_accumulated=False)
        # each hypothesis continues its parent's state
        new_state = L.gather(current_state, L.reshape(
            L.elementwise_add(parent, lane_base), shape=[-1]))
        L.increment(x=counter, value=1, in_place=True)
        L.array_write(new_state, array=state_array, i=counter)
        L.array_write(selected_ids, array=ids_array, i=counter)
        L.array_write(selected_scores, array=scores_array, i=counter)
        L.array_write(parent, array=parents_array, i=counter)
        L.less_than(x=counter, y=array_len, cond=cond)
    # the arrays as [T, B, K] tensors (array_to_lod_tensor is batch-major;
    # every row of the arrays is written, so no padding enters)
    table = L.lod_rank_table(lengths=src_len)

    def stacked(array):
        return L.transpose(L.array_to_lod_tensor(array, table),
                           perm=[1, 0, 2])

    return L.beam_search_decode(
        stacked(ids_array), stacked(parents_array),
        scores=stacked(scores_array), beam_size=K, end_id=end_id)


def build_decode(fluid=None, batch_size=64, max_src_len=50,
                 dict_size=DICT_SIZE, word_dim=WORD_DIM,
                 hidden_dim=HIDDEN_DIM, beam_size=BEAM_SIZE,
                 max_length=MAX_LENGTH, end_id=END_ID, is_sparse=False):
    """The book's decode program: ``src_word_id`` / ``src_length`` data
    layers, ``encoder`` (B6 on the card) and ``decoder_decode``. Returns
    (translation_ids, translation_scores)."""
    if fluid is None:
        import paddle_tpu_torch as fluid
    L = fluid.layers
    src = L.data(name="src_word_id", shape=[max_src_len], dtype="int64")
    src_len = L.data(name="src_length", shape=[1], dtype="int64")
    context = encoder(fluid, src, src_len, dict_size, word_dim, hidden_dim,
                      is_sparse)
    return decoder_decode(fluid, context, src_len, batch_size, dict_size,
                          word_dim, hidden_dim, beam_size, max_length,
                          end_id, is_sparse)


def init_beams(np, batch_size, beam_size=BEAM_SIZE, start_id=0):
    """The ``init_ids`` / ``init_scores`` feeds: every hypothesis starts at
    ``start_id``; only hypothesis 0 is live (score 0, the rest -1e9), so
    the first step does not select K copies of one candidate."""
    scores = np.full((batch_size, beam_size), -1e9, "float32")
    scores[:, 0] = 0.0
    return {"init_ids": np.full((batch_size, beam_size), start_id, "int64"),
            "init_scores": scores}
