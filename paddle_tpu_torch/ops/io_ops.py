"""IO ops: assign_value, random_data_generator, print and the
graph-level save / load pair (and their combined forms).

Counterpart of ``paddle_tpu/ops/io_ops.py``. ``random_data_generator``
draws a synthetic batch on the device from the op's key, as the JAX
package's does: one ``split`` per slot, ``uniform`` for float slots and
``randint`` for integer ones, so both packages draw the same batch from
the same seed.

``print``, ``save`` and ``save_combine`` act on the host when the op
runs (a copy of the value to the host); ``load`` and ``load_combine``
read their file once per (program version, path), as the JAX package
reads it once per trace, and keep that value until the program is
edited. None of the five can sit in a captured CUDA graph:
``Executor.run_multi_step`` refuses them by name (``HOST_IO_OPS``), and
the eager loop runs them. Files carry the JAX package's dtypes
(``core.types.jax_host_array``: int64 values written int32), so either
package reads the other's.
"""

import os
import weakref

import numpy as np
import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.core.types import device_dtype, jax_host_array

# ops that act on the host when they run: a captured loop cannot hold them
HOST_IO_OPS = ("print", "save", "load", "save_combine", "load_combine")


def _lower_assign_value(ctx, ins, attrs):
    dtype = device_dtype(attrs.get("dtype"))
    arr = np.asarray(attrs["values"]).reshape(
        [int(d) for d in attrs["shape"]])
    return torch.as_tensor(arr).to(device=ctx.device, dtype=dtype)


register_op(
    "assign_value",
    inputs=[],
    outputs=["Out"],
    attrs={"shape": [], "dtype": "float32", "values": []},
    lower=_lower_assign_value,
    grad=None,
)


def _lower_random_data_generator(ctx, ins, attrs):
    """Float slots ~ U[min, max), integer slots ~ U{int_min, int_max}
    (inclusive); slot ``i`` draws from ``split(key, slots)[i]``, that is
    ``fold_in(key, i)``. Integer slots are drawn as the JAX package's
    int32 and kept in the slot's dtype (int64 stays int64 here)."""
    shape_concat = [int(d) for d in attrs["shape_concat"]]
    ranks = [int(r) for r in attrs["ranks"]]
    dtypes = list(attrs["dtypes"])
    lo, hi = float(attrs.get("min", 0.0)), float(attrs.get("max", 1.0))
    ilo, ihi = int(attrs.get("int_min", 0)), int(attrs.get("int_max", 1))
    key = ctx.rng()
    outs, off = [], 0
    for i, rank in enumerate(ranks):
        shape = tuple(shape_concat[off:off + rank])
        off += rank
        dt = device_dtype(dtypes[i])
        if key is None:
            outs.append(torch.empty(shape, dtype=dt, device=ctx.device))
            continue
        sub = prng.as_chain(key).fold_in(i)
        if dt.is_floating_point:
            outs.append(prng.uniform(sub, shape, lo, hi,
                                     device=ctx.device).to(dt))
        else:
            outs.append(prng.randint(sub, shape, ilo, ihi + 1,
                                     device=ctx.device).to(dt))
    return {"Out": outs}


register_op(
    "random_data_generator",
    inputs=[],
    outputs=["*Out"],
    attrs={"shape_concat": [], "ranks": [], "dtypes": [], "min": 0.0,
           "max": 1.0, "int_min": 0, "int_max": 1},
    lower=_lower_random_data_generator,
    grad=None,
)



def _shape_only(ctx):
    """Build-time shape inference runs the lowering on ``meta`` tensors:
    no host effect then."""
    return ctx.device is not None and ctx.device.type == "meta"


def _lower_print(ctx, ins, attrs):
    """The line ``jax.debug.print(message + " {x}", x=x)`` writes: the
    message, a space and ``str`` of the value as a numpy array.
    ``first_n`` is ignored, as in the JAX package."""
    x = ins["In"][0]
    if not _shape_only(ctx):
        message = attrs.get("message", "")
        print((message + " {x}").format(x=x.detach().cpu().numpy()))
    return x


register_op(
    "print",
    inputs=["In"],
    outputs=["Out"],
    attrs={
        "first_n": -1,
        "message": "",
        "print_tensor_name": True,
        "print_tensor_type": True,
        "print_tensor_shape": True,
        "print_tensor_lod": True,
        "print_phase": "BOTH",
    },
    lower=_lower_print,
)


# (id(program), program version, path) -> (weakref to the program, the
# value read): a load reads its file once per program version
_LOADED = {}


def _read_once(ctx, path, read):
    program = ctx.block_lowerer.program if ctx.block_lowerer else None
    if program is None:
        return read()
    key = (id(program), program._version, path)
    hit = _LOADED.get(key)
    if hit is not None and hit[0]() is program:
        return hit[1]
    for k in [k for k, (ref, _v) in _LOADED.items() if ref() is None]:
        del _LOADED[k]
    val = read()
    _LOADED[key] = (weakref.ref(program), val)
    return val


def _save_path(attrs, op_name, suffix):
    path = attrs.get("file_path", "")
    if not path:
        raise ValueError("%s: file_path attr is required" % op_name)
    if not path.endswith(suffix):
        path = path + suffix  # normalize once: guard and write must agree
    return path


def _lower_load(ctx, ins, attrs):
    """load_op.cc: a variable saved by ``io.save_vars`` (one ``.npy``),
    cast to the ``dtype`` attr when given."""
    path = attrs.get("file_path", "")
    if not path:
        raise ValueError("load: file_path attr is required")
    if not path.endswith(".npy"):
        path = path + ".npy"
    if _shape_only(ctx):
        arr = np.load(path, mmap_mode="r")
    else:
        arr = _read_once(ctx, path, lambda: np.load(path))
    dtype = attrs.get("dtype", "")
    want = device_dtype(dtype) if dtype else None
    if _shape_only(ctx):
        return torch.empty(arr.shape, dtype=want or torch.from_numpy(
            np.zeros(0, arr.dtype)).dtype, device=ctx.device)
    t = torch.from_numpy(np.array(arr)).to(ctx.device)
    return t.to(want) if want is not None else t


register_op(
    "load",
    inputs=[],
    outputs=["Out"],
    attrs={"file_path": "", "dtype": ""},
    lower=_lower_load,
    grad=None,
)


def _write_guarded(path, overwrite, op_name, write_fn):
    """The overwrite guard and makedirs around an execution-time write
    (save and save_combine)."""
    if not overwrite and os.path.exists(path):
        raise RuntimeError(
            "%s: %r exists and overwrite=False" % (op_name, path))
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    write_fn()


def _lower_save(ctx, ins, attrs):
    """save_op.cc: persist a variable when the op runs; the value passes
    through unchanged."""
    x = ins["X"][0]
    path = _save_path(attrs, "save", ".npy")
    if not _shape_only(ctx):
        _write_guarded(path, attrs.get("overwrite", True), "save",
                       lambda: np.save(path, jax_host_array(x)))
    return x


def _save_grad_maker(op, out_grads, wanted):
    # save is the identity in the dataflow; its gradient is an assign
    return [{"type": "assign", "inputs": {"X": out_grads["Out"]},
             "outputs": {"Out": wanted["X"]}, "attrs": {}}]


register_op(
    "save",
    inputs=["X"],
    outputs=["Out"],
    attrs={"file_path": "", "overwrite": True},
    lower=_lower_save,
    grad=_save_grad_maker,
)


def _lower_save_combine(ctx, ins, attrs):
    """save_combine_op.cc: several variables in one ``.npz``, by
    position (``arg_0`` .. ``arg_{n-1}``), as the load side restores
    them."""
    xs = ins["X"]
    path = _save_path(attrs, "save_combine", ".npz")
    if not _shape_only(ctx):
        _write_guarded(
            path, attrs.get("overwrite", True), "save_combine",
            lambda: np.savez(path, **{"arg_%d" % i: jax_host_array(v)
                                      for i, v in enumerate(xs)}))
    return {"Out": list(xs)}


def _save_combine_grad_maker(op, out_grads, wanted):
    # the identity per slot entry, like save; backward marks the entries
    # it skips with ""
    return [{"type": "assign", "inputs": {"X": [g]}, "outputs": {"Out": [w]},
             "attrs": {}}
            for g, w in zip(out_grads["Out"], wanted["X"]) if w]


register_op(
    "save_combine",
    inputs=["*X"],
    outputs=["*Out"],
    attrs={"file_path": "", "overwrite": True},
    lower=_lower_save_combine,
    grad=_save_combine_grad_maker,
)


def _read_combined(path, n_out):
    with np.load(path) as z:
        if len(z.files) != n_out:
            raise ValueError(
                "load_combine: archive %r holds %d entries but the op "
                "declares %d outputs" % (path, len(z.files), n_out))
        return [np.array(z["arg_%d" % i]) for i in range(n_out)]


def _lower_load_combine(ctx, ins, attrs):
    """load_combine_op.cc: the positional bundle ``save_combine``
    wrote."""
    path = _save_path(attrs, "load_combine", ".npz")
    n_out = len([n for n in ctx.op.output("Out") if n])
    if _shape_only(ctx):
        vals = _read_combined(path, n_out)
        return {"Out": [torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                                    device=ctx.device) for v in vals]}
    vals = _read_once(ctx, path, lambda: _read_combined(path, n_out))
    return {"Out": [torch.from_numpy(np.array(v)).to(ctx.device)
                    for v in vals]}


register_op(
    "load_combine",
    inputs=[],
    outputs=["*Out"],
    attrs={"file_path": ""},
    lower=_lower_load_combine,
    grad=None,
)
