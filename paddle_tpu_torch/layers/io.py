"""Data layers.

Counterpart of ``paddle_tpu/layers/io.py`` ``data`` and
``random_data_generator``; the reader pipelines come in a later slice.
"""

from paddle_tpu_torch.core.types import VarType
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["data", "random_data_generator"]


def data(name, shape, dtype="float32", lod_level=0, type=VarType.LOD_TENSOR,
         append_batch_size=True, stop_gradient=True):
    """Declare an input variable. With append_batch_size, a leading -1
    batch dim is added as in Fluid."""
    helper = LayerHelper("data", name=name)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.block.create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        type=type, stop_gradient=stop_gradient, is_data=True)


def random_data_generator(shapes, dtypes, low=0.0, high=1.0, int_low=0,
                          int_high=1, name=None):
    """In-graph synthetic data source: one Variable per slot, drawn on
    the device at every run from the op's key (no host feed). ``shapes``
    include the batch dim and must be static. Float slots ~ U[low,
    high); int slots ~ U{int_low, int_high} inclusive."""
    helper = LayerHelper("random_data_generator", name=name)
    if len(shapes) != len(dtypes):
        raise ValueError("random_data_generator: %d shapes but %d dtypes"
                         % (len(shapes), len(dtypes)))
    shape_concat, ranks = [], []
    for s in shapes:
        s = [int(d) for d in s]
        if any(d <= 0 for d in s):
            raise ValueError("random_data_generator needs fully static "
                             "shapes, got %r" % (s,))
        shape_concat.extend(s)
        ranks.append(len(s))
    outs = [helper.block.create_var(
        name="%s_slot%d" % (helper.name, i), shape=[int(d) for d in s],
        dtype=dt, stop_gradient=True)
        for i, (s, dt) in enumerate(zip(shapes, dtypes))]
    helper.append_op(
        type="random_data_generator",
        inputs={},
        outputs={"Out": outs},
        attrs={"shape_concat": shape_concat, "ranks": ranks,
               "dtypes": [str(d) for d in dtypes], "min": float(low),
               "max": float(high), "int_min": int(int_low),
               "int_max": int(int_high)},
    )
    return outs
