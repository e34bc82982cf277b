"""ResNet (benchmark/fluid/models/resnet.py parity): bottleneck / basic
block residual stacks for cifar10 (``resnet_cifar10``) and imagenet
(``resnet_imagenet``, ResNet-50 by default).

Counterpart of ``paddle_tpu/models/resnet.py``, the same program with the
same variable names: conv2d (cuDNN on the card) + batch_norm.
"""

import paddle_tpu_torch as fluid


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  is_train=True):
    conv1 = fluid.layers.conv2d(
        input=input,
        filter_size=filter_size,
        num_filters=ch_out,
        stride=stride,
        padding=padding,
        act=None,
        bias_attr=False,
    )
    return fluid.layers.batch_norm(input=conv1, act=act, is_test=not is_train)


def shortcut(input, ch_out, stride, is_train=True):
    ch_in = int(input.shape[1])
    if ch_in != ch_out:
        return conv_bn_layer(
            input, ch_out, 1, stride, 0, act=None, is_train=is_train
        )
    return input


def basicblock(input, ch_out, stride, is_train=True):
    short = shortcut(input, ch_out, stride, is_train=is_train)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_train=is_train)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, is_train=is_train)
    return fluid.layers.elementwise_add(short, conv2, act="relu")


def bottleneck(input, ch_out, stride, is_train=True):
    short = shortcut(input, ch_out * 4, stride, is_train=is_train)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_train=is_train)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_train=is_train)
    conv3 = conv_bn_layer(
        conv2, ch_out * 4, 1, 1, 0, act=None, is_train=is_train
    )
    return fluid.layers.elementwise_add(short, conv3, act="relu")


def layer_warp(block_func, input, ch_out, count, stride, is_train=True):
    res_out = block_func(input, ch_out, stride, is_train=is_train)
    for _ in range(count - 1):
        res_out = block_func(res_out, ch_out, 1, is_train=is_train)
    return res_out


def resnet_imagenet(input, class_dim, depth=50, is_train=True):
    cfg = {
        18: ([2, 2, 2, 2], basicblock),
        34: ([3, 4, 6, 3], basicblock),
        50: ([3, 4, 6, 3], bottleneck),
        101: ([3, 4, 23, 3], bottleneck),
        152: ([3, 8, 36, 3], bottleneck),
    }
    stages, block_func = cfg[depth]
    conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2, padding=3,
                          is_train=is_train)
    pool1 = fluid.layers.pool2d(
        input=conv1, pool_type="max", pool_size=3, pool_stride=2, pool_padding=1
    )
    res1 = layer_warp(block_func, pool1, 64, stages[0], 1, is_train=is_train)
    res2 = layer_warp(block_func, res1, 128, stages[1], 2, is_train=is_train)
    res3 = layer_warp(block_func, res2, 256, stages[2], 2, is_train=is_train)
    res4 = layer_warp(block_func, res3, 512, stages[3], 2, is_train=is_train)
    pool2 = fluid.layers.pool2d(
        input=res4, pool_size=7, pool_type="avg", global_pooling=True
    )
    out = fluid.layers.fc(input=pool2, size=class_dim, act="softmax")
    return out


def resnet_cifar10(input, class_dim, depth=32, is_train=True):
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(
        input=input, ch_out=16, filter_size=3, stride=1, padding=1,
        is_train=is_train,
    )
    res1 = layer_warp(basicblock, conv1, 16, n, 1, is_train=is_train)
    res2 = layer_warp(basicblock, res1, 32, n, 2, is_train=is_train)
    res3 = layer_warp(basicblock, res2, 64, n, 2, is_train=is_train)
    pool = fluid.layers.pool2d(
        input=res3, pool_size=8, pool_type="avg", global_pooling=True
    )
    out = fluid.layers.fc(input=pool, size=class_dim, act="softmax")
    return out


def build(img_shape=(3, 224, 224), class_num=1000, depth=50, variant="imagenet",
          dtype="float32", is_train=True):
    images = fluid.layers.data(name="pixel", shape=list(img_shape), dtype=dtype)
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    if variant == "imagenet":
        predict = resnet_imagenet(images, class_num, depth=depth,
                                  is_train=is_train)
    else:
        predict = resnet_cifar10(images, class_num, depth=depth,
                                 is_train=is_train)
    cost = fluid.layers.cross_entropy(input=predict, label=label)
    avg_cost = fluid.layers.mean(cost)
    acc = fluid.layers.accuracy(input=predict, label=label)
    return avg_cost, [images, label], {"accuracy": acc, "predict": predict}
