"""SE-ResNeXt (benchmark/fluid/models/se_resnext.py parity): grouped-conv
bottlenecks (cardinality 32/64) with squeeze-and-excitation channel gating.

Counterpart of ``paddle_tpu/models/se_resnext.py``, the same program with
the same variable names: the grouped 3x3 conv is cuDNN's grouped
convolution on the card, the SE gate two small fc layers and a broadcast
multiply.
"""

import paddle_tpu_torch as fluid


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, is_train=True):
    conv = fluid.layers.conv2d(
        input=input,
        num_filters=num_filters,
        filter_size=filter_size,
        stride=stride,
        padding=(filter_size - 1) // 2,
        groups=groups,
        act=None,
        bias_attr=False,
    )
    return fluid.layers.batch_norm(input=conv, act=act, is_test=not is_train)


def squeeze_excitation(input, num_channels, reduction_ratio):
    pool = fluid.layers.pool2d(
        input=input, pool_type="avg", global_pooling=True
    )
    squeeze = fluid.layers.fc(
        input=pool, size=num_channels // reduction_ratio, act="relu"
    )
    excitation = fluid.layers.fc(
        input=squeeze, size=num_channels, act="sigmoid"
    )
    return fluid.layers.elementwise_mul(x=input, y=excitation, axis=0)


def shortcut(input, ch_out, stride, is_train=True):
    ch_in = int(input.shape[1])
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(
            input, ch_out, 1, stride, is_train=is_train
        )
    return input


def bottleneck_block(input, num_filters, stride, cardinality,
                     reduction_ratio, is_train=True):
    conv0 = conv_bn_layer(
        input, num_filters, 1, act="relu", is_train=is_train
    )
    conv1 = conv_bn_layer(
        conv0, num_filters, 3, stride, groups=cardinality, act="relu",
        is_train=is_train,
    )
    conv2 = conv_bn_layer(
        conv1, num_filters * 2, 1, act=None, is_train=is_train
    )
    scale = squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    short = shortcut(input, num_filters * 2, stride, is_train=is_train)
    return fluid.layers.elementwise_add(short, scale, act="relu")


def se_resnext_imagenet(input, class_dim, depth=50, is_train=True):
    cfg = {
        50: ([3, 4, 6, 3], 32, 16, [128, 256, 512, 1024]),
        101: ([3, 4, 23, 3], 32, 16, [128, 256, 512, 1024]),
        152: ([3, 8, 36, 3], 64, 16, [128, 256, 512, 1024]),
    }
    stages, cardinality, reduction_ratio, num_filters = cfg[depth]
    if depth == 152:
        conv = conv_bn_layer(input, 64, 3, 2, act="relu", is_train=is_train)
        conv = conv_bn_layer(conv, 64, 3, act="relu", is_train=is_train)
        conv = conv_bn_layer(conv, 128, 3, act="relu", is_train=is_train)
    else:
        conv = conv_bn_layer(input, 64, 7, 2, act="relu", is_train=is_train)
    conv = fluid.layers.pool2d(
        input=conv, pool_size=3, pool_stride=2, pool_padding=1,
        pool_type="max",
    )
    for block, n in enumerate(stages):
        for i in range(n):
            conv = bottleneck_block(
                conv,
                num_filters[block],
                2 if i == 0 and block != 0 else 1,
                cardinality,
                reduction_ratio,
                is_train=is_train,
            )
    pool = fluid.layers.pool2d(
        input=conv, pool_type="avg", global_pooling=True
    )
    drop = fluid.layers.dropout(pool, dropout_prob=0.2, is_test=not is_train)
    return fluid.layers.fc(input=drop, size=class_dim, act="softmax")


def build(img_shape=(3, 224, 224), class_num=1000, depth=50, dtype="float32",
          is_train=True):
    images = fluid.layers.data(name="pixel", shape=list(img_shape),
                               dtype=dtype)
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    predict = se_resnext_imagenet(images, class_num, depth=depth,
                                  is_train=is_train)
    cost = fluid.layers.cross_entropy(input=predict, label=label)
    avg_cost = fluid.layers.mean(cost)
    acc = fluid.layers.accuracy(input=predict, label=label)
    return avg_cost, [images, label], {"accuracy": acc, "predict": predict}
