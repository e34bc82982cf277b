"""The sentiment classifier of the PaddlePaddle book, chapter 6
(``understand_sentiment``, ``convolution_net``): an embedding, two
``nets.sequence_conv_pool`` branches (windows 3 and 4, tanh, sqrt
pooling), a softmax ``fc`` over both, cross entropy, Adagrad.

The JAX package has no such model file. ``build`` takes the framework
module (``paddle_tpu_torch`` by default), so that the same network is
built through either package. Padded layout: the words are ``[batch,
max_len]`` ids plus ``[batch, 1]`` lengths instead of an LoD tensor. The
book's widths: the IMDB ``word_dict()`` at its cutoff of 150 (5,148 ids
with ``<unk>``), embedding 128, ``hid_dim`` 512, 2 classes, batch 128,
``Adagrad(0.002)``.
"""

WORD_DICT, EMB_DIM, HID_DIM, CLASS_DIM = 5148, 128, 512, 2
LEARNING_RATE = 0.002


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


def build(fluid=None, max_len=600, input_dim=WORD_DICT, class_dim=CLASS_DIM,
          emb_dim=EMB_DIM, hid_dim=HID_DIM):
    """Data layers (``words``, ``length``, ``label``), the network, its
    mean cross entropy and accuracy. Returns (avg_cost, accuracy,
    prediction); the caller clones for test and minimizes."""
    if fluid is None:
        import paddle_tpu_torch as fluid
    L = fluid.layers
    words = L.data(name="words", shape=[max_len], dtype="int64")
    length = L.data(name="length", shape=[1], dtype="int64")
    label = L.data(name="label", shape=[1], dtype="int64")
    prediction = convolution_net(fluid, words, length, input_dim, class_dim,
                                 emb_dim, hid_dim)
    cost = L.cross_entropy(input=prediction, label=label)
    avg_cost = L.mean(cost)
    accuracy = L.accuracy(input=prediction, label=label)
    return avg_cost, accuracy, prediction


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
