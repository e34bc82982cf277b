"""GoogLeNet / Inception-v1 (benchmark/paddle/image/googlenet.py capability,
one of the BASELINE.md benchmark families): inception concat blocks + two
auxiliary classifier towers contributing 0.3-weighted losses during
training.

Counterpart of ``paddle_tpu/models/googlenet.py``, the same program with
the same variable names.
"""

import paddle_tpu_torch as fluid


def conv_layer(input, num_filters, filter_size, stride=1, padding=None,
               act="relu"):
    if padding is None:
        padding = (filter_size - 1) // 2
    return fluid.layers.conv2d(
        input=input,
        num_filters=num_filters,
        filter_size=filter_size,
        stride=stride,
        padding=padding,
        act=act,
    )


def inception(input, c1, c3r, c3, c5r, c5, proj):
    b1 = conv_layer(input, c1, 1)
    b3 = conv_layer(conv_layer(input, c3r, 1), c3, 3)
    b5 = conv_layer(conv_layer(input, c5r, 1), c5, 5)
    pool = fluid.layers.pool2d(
        input=input, pool_size=3, pool_stride=1, pool_padding=1,
        pool_type="max",
    )
    bp = conv_layer(pool, proj, 1)
    return fluid.layers.concat([b1, b3, b5, bp], axis=1)


def _aux_head(input, class_dim, is_train):
    # 5x5/stride-3 matches the 224px reference geometry (14x14 -> 4x4);
    # smaller feature maps would pool to zero size, so fall back to global.
    spatial = min(int(input.shape[2]), int(input.shape[3]))
    if spatial >= 5:
        pool = fluid.layers.pool2d(
            input=input, pool_size=5, pool_stride=3, pool_type="avg"
        )
    else:
        pool = fluid.layers.pool2d(
            input=input, pool_type="avg", global_pooling=True
        )
    conv = conv_layer(pool, 128, 1)
    fc1 = fluid.layers.fc(input=conv, size=1024, act="relu")
    drop = fluid.layers.dropout(fc1, dropout_prob=0.7, is_test=not is_train)
    return fluid.layers.fc(input=drop, size=class_dim, act="softmax")


def googlenet(input, class_dim, is_train=True):
    conv1 = conv_layer(input, 64, 7, stride=2)
    pool1 = fluid.layers.pool2d(
        input=conv1, pool_size=3, pool_stride=2, pool_padding=1,
        pool_type="max",
    )
    conv2 = conv_layer(conv_layer(pool1, 64, 1), 192, 3)
    pool2 = fluid.layers.pool2d(
        input=conv2, pool_size=3, pool_stride=2, pool_padding=1,
        pool_type="max",
    )

    i3a = inception(pool2, 64, 96, 128, 16, 32, 32)
    i3b = inception(i3a, 128, 128, 192, 32, 96, 64)
    pool3 = fluid.layers.pool2d(
        input=i3b, pool_size=3, pool_stride=2, pool_padding=1,
        pool_type="max",
    )

    i4a = inception(pool3, 192, 96, 208, 16, 48, 64)
    i4b = inception(i4a, 160, 112, 224, 24, 64, 64)
    i4c = inception(i4b, 128, 128, 256, 24, 64, 64)
    i4d = inception(i4c, 112, 144, 288, 32, 64, 64)
    i4e = inception(i4d, 256, 160, 320, 32, 128, 128)
    pool4 = fluid.layers.pool2d(
        input=i4e, pool_size=3, pool_stride=2, pool_padding=1,
        pool_type="max",
    )

    i5a = inception(pool4, 256, 160, 320, 32, 128, 128)
    i5b = inception(i5a, 384, 192, 384, 48, 128, 128)
    pool5 = fluid.layers.pool2d(
        input=i5b, pool_type="avg", global_pooling=True
    )
    drop = fluid.layers.dropout(pool5, dropout_prob=0.4,
                                is_test=not is_train)
    main_out = fluid.layers.fc(input=drop, size=class_dim, act="softmax")

    aux1 = _aux_head(i4a, class_dim, is_train)
    aux2 = _aux_head(i4d, class_dim, is_train)
    return main_out, aux1, aux2


def build(img_shape=(3, 224, 224), class_num=1000, dtype="float32",
          is_train=True, use_aux_heads=True):
    images = fluid.layers.data(name="pixel", shape=list(img_shape),
                               dtype=dtype)
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    out, aux1, aux2 = googlenet(images, class_num, is_train=is_train)
    cost = fluid.layers.mean(
        fluid.layers.cross_entropy(input=out, label=label)
    )
    if use_aux_heads and is_train:
        cost1 = fluid.layers.mean(
            fluid.layers.cross_entropy(input=aux1, label=label)
        )
        cost2 = fluid.layers.mean(
            fluid.layers.cross_entropy(input=aux2, label=label)
        )
        cost = fluid.layers.elementwise_add(
            cost,
            fluid.layers.scale(
                fluid.layers.elementwise_add(cost1, cost2), scale=0.3
            ),
        )
    acc = fluid.layers.accuracy(input=out, label=label)
    return cost, [images, label], {"accuracy": acc, "predict": out}
