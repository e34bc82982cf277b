"""VGG-16 (benchmark/fluid/models/vgg.py parity): conv groups with BN +
dropout, two fc-bn layers, softmax classifier.

Counterpart of ``paddle_tpu/models/vgg.py``, the same program with the
same variable names.
"""

import paddle_tpu_torch as fluid


def vgg16_bn_drop(input):
    def conv_block(ipt, num_filter, groups, dropouts):
        return fluid.nets.img_conv_group(
            input=ipt,
            pool_size=2,
            pool_stride=2,
            conv_num_filter=[num_filter] * groups,
            conv_filter_size=3,
            conv_act="relu",
            conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts,
            pool_type="max",
        )

    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])

    drop = fluid.layers.dropout(x=conv5, dropout_prob=0.5)
    fc1 = fluid.layers.fc(input=drop, size=512, act=None)
    bn = fluid.layers.batch_norm(input=fc1, act="relu")
    drop2 = fluid.layers.dropout(x=bn, dropout_prob=0.5)
    fc2 = fluid.layers.fc(input=drop2, size=512, act=None)
    return fc2


def build(img_shape=(3, 32, 32), class_num=10, dtype="float32"):
    """CIFAR-10-shaped VGG-16 (the benchmark recipe's cifar10 config)."""
    images = fluid.layers.data(name="pixel", shape=list(img_shape), dtype=dtype)
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    net = vgg16_bn_drop(images)
    predict = fluid.layers.fc(input=net, size=class_num, act="softmax")
    cost = fluid.layers.cross_entropy(input=predict, label=label)
    avg_cost = fluid.layers.mean(cost)
    acc = fluid.layers.accuracy(input=predict, label=label)
    return avg_cost, [images, label], {"accuracy": acc, "predict": predict}
