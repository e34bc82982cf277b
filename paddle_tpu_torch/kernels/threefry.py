"""threefry2x32 draws on the card: the launch wrapper of
``csrc/threefry.cu``.

The port's own kernel; it replaces no TPU kernel (XLA fuses the JAX
package's threefry draws itself). ``threefry_draw`` takes a
``core.prng.KeyChain`` and draws ``n`` counters per row of keys in one
launch: the chain's folds run inside the kernel, so an op's key
(``fold_in(fold_in(run_key, step), op_id)``) costs no launch of its
own. Its plain version is ``core.prng.plain_draw`` (torch ops); the
wrapper runs it for a tensor off the card, and on a CUDA device
launches the kernel or raises. ``THREEFRY.launches`` counts the
launches (a captured launch at every replay).
"""

import ctypes

import numpy as np
import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.kernels.build import Kernel

THREEFRY = Kernel("paddle_threefry", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
    ctypes.c_int] + [ctypes.c_uint] * 4 + [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])

MAX_ROWS = 65535  # the kernel's grid.y


def _out(mode, rows, n, dtype, device):
    if mode == prng.MODE_KEY:
        return torch.empty((rows, 2), dtype=torch.int64, device=device)
    if mode == prng.MODE_BERNOULLI and dtype not in (None, torch.bool,
                                                     torch.float32):
        raise TypeError("threefry bernoulli writes bool or float32 on the "
                        "card, not %s" % dtype)
    return prng.draw_out(mode, rows, n, dtype, device)


def _device_int64(t, device, what):
    if t.device != device:
        raise ValueError("threefry: %s on %s, the draw on %s"
                         % (what, t.device, device))
    return t.to(torch.int64).contiguous()


def threefry_draw(chain, n, mode, lo=0.0, hi=1.0, p=0.0, dtype=None,
                  device=None):
    """One draw (``core.prng._draw``'s contract): ``[rows, n]`` words,
    floats or mask, or ``[rows, 2]`` keys. Off the card:
    ``prng.plain_draw``. On a CUDA device: one launch. A ``device`` that
    the chain's tensors are not on raises (``KeyChain.device``)."""
    device = chain.device(device)
    if device.type != "cuda":
        return prng.plain_draw(chain, n, mode, lo=lo, hi=hi, p=p,
                               dtype=dtype, device=device)
    rows, n = chain.rows(), int(n)
    if rows > MAX_ROWS:
        raise ValueError("threefry: %d rows of keys, at most %d a launch"
                         % (rows, MAX_ROWS))
    keep = []  # tensors whose pointers the launch reads
    key_ptr, key_rows, k0, k1 = None, 1, 0, 0
    if isinstance(chain.base, torch.Tensor):
        key = _device_int64(chain.base, device, "key").reshape(-1, 2)
        keep.append(key)
        key_ptr, key_rows = key.data_ptr(), key.shape[0]
    else:
        k0, k1 = chain.base
    folds = list(chain.folds) + [0] * (prng.MAX_FOLDS - len(chain.folds))
    rd = []
    for t in chain.row_data:
        t = _device_int64(t, device, "row data")
        keep.append(t)
        rd.append(t.data_ptr())
    rd += [None] * (prng.MAX_ROW_FOLDS - len(rd))
    out = _out(mode, rows, n, dtype, device)
    if out.numel() == 0:
        return out
    lo32 = np.float32(lo)
    span = np.float32(hi) - lo32
    with torch.cuda.device(device):
        THREEFRY.launch(
            key_ptr, key_rows, k0, k1, len(chain.folds), *folds, rd[0],
            rd[1], rows, n, mode, float(lo32), float(span),
            float(np.float32(p)), int(out.dtype == torch.bool),
            out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    return out
