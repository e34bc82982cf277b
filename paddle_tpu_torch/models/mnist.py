"""MNIST conv model: two conv-pool blocks and an fc head.

Counterpart of ``paddle_tpu/models/mnist.py``, line for line
(benchmark/fluid/models/mnist.py parity).
"""

import paddle_tpu_torch as fluid


def build(batch_size=None, img_shape=(1, 28, 28), class_num=10,
          dtype="float32"):
    images = fluid.layers.data(name="pixel", shape=list(img_shape),
                               dtype=dtype)
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")

    conv_pool_1 = fluid.nets.simple_img_conv_pool(
        input=images, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu")
    conv_pool_2 = fluid.nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")
    predict = fluid.layers.fc(input=conv_pool_2, size=class_num,
                              act="softmax")
    cost = fluid.layers.cross_entropy(input=predict, label=label)
    avg_cost = fluid.layers.mean(cost)
    acc = fluid.layers.accuracy(input=predict, label=label)
    return avg_cost, [images, label], {"accuracy": acc, "predict": predict}
