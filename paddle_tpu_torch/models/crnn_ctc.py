"""CRNN-CTC, the text-line recogniser of PaddlePaddle/models
``fluid/ocr_recognition`` (``crnn_ctc_model.py``): groups of two 3x3
convolutions with batch norm, max pools with ``ceil_mode``, the feature
map's columns as a sequence (``im2sequence``), a forward and a reverse
GRU with relu candidates, a class projection, the CTC loss, greedy
decoding and the edit distance.

The JAX package has no such model file. ``build`` takes the framework
module (``paddle_tpu_torch`` by default), so that the same network is
built through either package. The published configuration: gray images
``[1, 48, 512]``, 95 classes and the blank (index 95), channels 16, 32,
64 and 128 (pools after the first three groups), GRU width 200;
``Momentum(1e-3, 0.9)`` with L2 decay 4e-4 (``ctc_train_net``). Labels
are dense ``[batch, max_label]`` with their lengths.
"""

CLASSES, CHANNELS, RNN_HIDDEN = 95, (16, 32, 64, 128), 200


def conv_bn_pool(fluid, x, out_ch, w, w0, b, pooling=True):
    """Two convolutions (3x3, padding 1, no bias) each with ``batch_norm``
    (relu), then a 2x2 max pool of stride 2 with ``ceil_mode``."""
    L = fluid.layers
    for i, ch in enumerate(out_ch):
        x = L.conv2d(input=x, num_filters=ch, filter_size=3, padding=1,
                     param_attr=w0 if (i == 0 and w0 is not None) else w,
                     bias_attr=False)
        x = L.batch_norm(input=x, act="relu", param_attr=w, bias_attr=b)
    if pooling:
        x = L.pool2d(input=x, pool_size=2, pool_type="max", pool_stride=2,
                     ceil_mode=True)
    return x


def encoder_net(fluid, images, num_classes=CLASSES, channels=CHANNELS,
                rnn_hidden=RNN_HIDDEN):
    """``crnn_ctc_model.py`` ``encoder_net``: the logits ``[B, T,
    num_classes + 1]``, T the width of the last feature map."""
    L = fluid.layers
    init = fluid.initializer.Normal
    attr = fluid.ParamAttr
    b = attr(initializer=init(0.0, 0.0))
    w1 = attr(initializer=init(0.0, 0.01))
    x = images
    for i, ch in enumerate(channels):
        x = conv_bn_pool(fluid, x, [ch, ch], w1,
                         attr(initializer=init(0.0, 0.0005)) if i == 0
                         else None, b, pooling=i < len(channels) - 1)
    n, c, h, w = (int(d) for d in x.shape)
    seq = L.im2sequence(input=x, stride=[1, 1], filter_size=[h, 1])
    seq = L.reshape(seq, shape=[n, w, c * h])
    fc_w = attr(initializer=init(0.0, 0.02))
    fc_1 = L.fc(input=seq, size=rnn_hidden * 3, param_attr=fc_w,
                bias_attr=False, num_flatten_dims=2)
    fc_2 = L.fc(input=seq, size=rnn_hidden * 3, param_attr=fc_w,
                bias_attr=False, num_flatten_dims=2)
    gru_b = attr(initializer=init(0.0, 0.02), learning_rate=2.0)
    fwd = L.dynamic_gru(input=fc_1, size=rnn_hidden, param_attr=fc_w,
                        bias_attr=gru_b, candidate_activation="relu")
    bwd = L.dynamic_gru(input=fc_2, size=rnn_hidden, is_reverse=True,
                        param_attr=fc_w, bias_attr=gru_b,
                        candidate_activation="relu")
    return L.fc(input=[fwd, bwd], size=num_classes + 1,
                param_attr=attr(initializer=init(0.0, 0.02)),
                bias_attr=attr(initializer=init(0.0, 0.0)),
                num_flatten_dims=2)


def build(fluid=None, batch_size=32, img_shape=(1, 48, 512),
          num_classes=CLASSES, max_label=24, channels=CHANNELS,
          rnn_hidden=RNN_HIDDEN):
    """Data layers of ``batch_size`` rows (``pixel``, ``label``
    ``[max_label]`` int32, ``label_length``; a fixed batch, so that the
    frames' reshape has one free dimension), ``encoder_net``,
    ``warpctc`` (blank = ``num_classes``, ``norm_by_times``) summed; the
    greedy decode and its summed edit distance. Returns (sum_cost,
    extras)."""
    if fluid is None:
        import paddle_tpu_torch as fluid
    L = fluid.layers

    def data(name, shape, dtype):
        return L.data(name=name, shape=[batch_size] + list(shape),
                      dtype=dtype, append_batch_size=False)

    images = data("pixel", img_shape, "float32")
    label = data("label", [max_label], "int32")
    label_len = data("label_length", [1], "int64")
    logits = encoder_net(fluid, images, num_classes, channels, rnn_hidden)
    cost = L.warpctc(input=logits, label=label, blank=num_classes,
                     norm_by_times=True, label_length=label_len)
    sum_cost = L.reduce_sum(cost)
    decoded, decoded_len = L.ctc_greedy_decoder(input=logits,
                                                blank=num_classes)
    dist, _ = L.edit_distance(decoded, L.cast(label, "int64"),
                              normalized=False, input_length=decoded_len,
                              label_length=label_len)
    return sum_cost, dict(logits=logits, decoded=decoded,
                          decoded_len=decoded_len,
                          edit_distance=L.reduce_sum(dist))


def batch(np, rng, n, img_shape=(1, 48, 512), num_classes=CLASSES,
          max_label=24, min_label=4):
    """Images uniform in [0, 1) and labels of ``min_label..max_label``
    characters (classes 0..num_classes - 1, padded with 0), drawn from
    ``rng``."""
    lens = rng.randint(min_label, max_label + 1, n)
    label = rng.randint(0, num_classes, (n, max_label))
    label = np.where(np.arange(max_label)[None, :] < lens[:, None], label,
                     0).astype("int32")
    return {"pixel": rng.rand(n, *img_shape).astype("float32"),
            "label": label,
            "label_length": lens.reshape(-1, 1).astype("int64")}
