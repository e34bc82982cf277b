"""Composite network helpers (python/paddle/fluid/nets.py parity).

Counterpart of ``paddle_tpu/nets.py``: ``simple_img_conv_pool`` (the
MNIST model's), ``img_conv_group`` (VGG's), ``sequence_conv_pool`` (the
sentiment CNN's), ``glu`` and ``scaled_dot_product_attention`` (plain
products and a softmax, no kernel, as in the JAX package).
"""

from paddle_tpu_torch import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "glu", "scaled_dot_product_attention"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr,
        act=act)
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def _expand(v):
        return v if hasattr(v, "__len__") else [v] * len(conv_num_filter)

    conv_padding = _expand(conv_padding)
    conv_filter_size = _expand(conv_filter_size)
    param_attr = (param_attr if isinstance(param_attr, (list, tuple))
                  else [param_attr] * len(conv_num_filter))
    conv_with_batchnorm = _expand(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _expand(conv_batchnorm_drop_rate)

    for i in range(len(conv_num_filter)):
        local_conv_act = None if conv_with_batchnorm[i] else conv_act
        tmp = layers.conv2d(
            input=tmp, num_filters=conv_num_filter[i],
            filter_size=conv_filter_size[i], padding=conv_padding[i],
            param_attr=param_attr[i], act=local_conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    return layers.pool2d(input=tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", length=None):
    """Sequence convolution + pooling block (nets.py:109): on the padded
    layout input is [B, T, N]; ``length`` masks the pooled tail."""
    conv_out = layers.sequence_conv(
        input=input, num_filters=num_filters, filter_size=filter_size,
        param_attr=param_attr, act=act, length=length)
    return layers.sequence_pool(conv_out, pool_type, length=length)


def glu(input, dim=-1):
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention over [batch, len, d]
    tensors (nets.py:130-160)."""
    d_key = int(queries.shape[-1]) // num_heads

    def _split_heads(x):
        if num_heads == 1:
            return x
        b = layers.reshape(x, [0, 0, num_heads,
                               int(x.shape[-1]) // num_heads])
        return layers.transpose(b, [0, 2, 1, 3])

    def _combine_heads(x):
        if num_heads == 1:
            return x
        t = layers.transpose(x, [0, 2, 1, 3])
        return layers.reshape(t, [0, 0, int(t.shape[2]) * int(t.shape[3])])

    q = _split_heads(queries)
    k = _split_heads(keys)
    v = _split_heads(values)
    scaled_q = layers.scale(q, scale=d_key ** -0.5)
    product = layers.matmul(scaled_q, k, transpose_y=True)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    ctx_multiheads = layers.matmul(weights, v)
    return _combine_heads(ctx_multiheads)
