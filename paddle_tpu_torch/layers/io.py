"""Data layers.

Counterpart of ``paddle_tpu/layers/io.py`` ``data``; the reader
pipelines come in a later slice.
"""

from paddle_tpu_torch.core.types import VarType
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["data"]


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
