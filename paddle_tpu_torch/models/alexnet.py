"""AlexNet (benchmark/paddle/image/alexnet.py capability, a BASELINE.md
benchmark family): 5 convs with LRN + 3 FCs with dropout.

Counterpart of ``paddle_tpu/models/alexnet.py``, the same program with
the same variable names.
"""

import paddle_tpu_torch as fluid


def alexnet(input, class_dim, is_train=True, use_lrn=True):
    conv1 = fluid.layers.conv2d(
        input=input, num_filters=96, filter_size=11, stride=4, padding=2,
        act="relu",
    )
    if use_lrn:
        conv1 = fluid.layers.lrn(conv1, n=5, alpha=1e-4, beta=0.75)
    pool1 = fluid.layers.pool2d(
        input=conv1, pool_size=3, pool_stride=2, pool_type="max"
    )

    conv2 = fluid.layers.conv2d(
        input=pool1, num_filters=256, filter_size=5, padding=2, groups=2,
        act="relu",
    )
    if use_lrn:
        conv2 = fluid.layers.lrn(conv2, n=5, alpha=1e-4, beta=0.75)
    pool2 = fluid.layers.pool2d(
        input=conv2, pool_size=3, pool_stride=2, pool_type="max"
    )

    conv3 = fluid.layers.conv2d(
        input=pool2, num_filters=384, filter_size=3, padding=1, act="relu"
    )
    conv4 = fluid.layers.conv2d(
        input=conv3, num_filters=384, filter_size=3, padding=1, groups=2,
        act="relu",
    )
    conv5 = fluid.layers.conv2d(
        input=conv4, num_filters=256, filter_size=3, padding=1, groups=2,
        act="relu",
    )
    pool5 = fluid.layers.pool2d(
        input=conv5, pool_size=3, pool_stride=2, pool_type="max"
    )

    fc6 = fluid.layers.fc(input=pool5, size=4096, act="relu")
    drop6 = fluid.layers.dropout(fc6, dropout_prob=0.5, is_test=not is_train)
    fc7 = fluid.layers.fc(input=drop6, size=4096, act="relu")
    drop7 = fluid.layers.dropout(fc7, dropout_prob=0.5, is_test=not is_train)
    return fluid.layers.fc(input=drop7, size=class_dim, act="softmax")


def build(img_shape=(3, 224, 224), class_num=1000, dtype="float32",
          is_train=True, use_lrn=True):
    images = fluid.layers.data(name="pixel", shape=list(img_shape),
                               dtype=dtype)
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    predict = alexnet(images, class_num, is_train=is_train, use_lrn=use_lrn)
    cost = fluid.layers.cross_entropy(input=predict, label=label)
    avg_cost = fluid.layers.mean(cost)
    acc = fluid.layers.accuracy(input=predict, label=label)
    return avg_cost, [images, label], {"accuracy": acc, "predict": predict}
