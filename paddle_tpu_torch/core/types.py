"""Device places and variable types.

Counterpart of ``paddle_tpu/core/types.py``. A Place resolves to a
``torch.device``: ``CUDAPlace(i)`` is card ``i`` and ``CPUPlace()`` the
host. There is no silent fallback: asking for a card on a machine without
one raises. ``TPUPlace`` stays as an alias of ``CUDAPlace`` so scripts
written for the JAX package run unchanged.
"""

import torch


class Place(object):
    """Base device tag. Resolves to a torch.device."""

    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def torch_device(self):
        raise NotImplementedError

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (type(self).__name__, self.device_id)


class CUDAPlace(Place):
    """An NVIDIA card. Raises when the process sees no card, rather than
    running on the CPU behind the caller's back."""

    def torch_device(self):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDAPlace(%d): torch sees no CUDA device; pass "
                "CPUPlace() to run on the CPU" % self.device_id)
        n = torch.cuda.device_count()
        if self.device_id >= n:
            raise RuntimeError(
                "CUDAPlace(%d): only %d CUDA device(s) visible"
                % (self.device_id, n))
        return torch.device("cuda", self.device_id)


# scripts written for the JAX package name the accelerator TPUPlace
TPUPlace = CUDAPlace


class CPUPlace(Place):
    def torch_device(self):
        return torch.device("cpu")


class VarType(object):
    """Variable type tags (framework.proto:105 VarType.Type)."""

    LOD_TENSOR = "lod_tensor"
    SELECTED_ROWS = "selected_rows"
    STEP_SCOPES = "step_scopes"
    LOD_RANK_TABLE = "lod_rank_table"
    LOD_TENSOR_ARRAY = "lod_tensor_array"
    READER = "reader"
    RAW = "raw"


_DTYPE_ALIASES = {
    "float": "float32",
    "double": "float64",
    "half": "float16",
    "bf16": "bfloat16",
    "int": "int32",
    "long": "int64",
    "bool_": "bool",
}

_TORCH = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}


def canonical_dtype(dtype):
    """Normalize any dtype spec (str / np.dtype / torch.dtype) to a
    canonical name."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, torch.dtype):
        name = str(dtype).split(".")[-1]
    elif hasattr(dtype, "name"):
        name = dtype.name
    else:
        name = str(dtype)
    name = _DTYPE_ALIASES.get(name, name)
    if name not in _TORCH:
        raise ValueError("unsupported dtype %r" % (dtype,))
    return name


def is_float_dtype(dtype):
    return canonical_dtype(dtype) in ("float16", "bfloat16", "float32",
                                      "float64")


def device_dtype(dtype):
    """The torch dtype a value of ``dtype`` takes on the device. Unlike
    the JAX package (x64 off narrows int64 to int32), int64 stays int64."""
    return _TORCH[canonical_dtype(dtype)]
