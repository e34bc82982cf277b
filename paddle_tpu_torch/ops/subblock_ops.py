"""Sub-block ops: recurrent (StaticRNN / DynamicRNN), cond, while, and
the tensor arrays.

Counterpart of ``paddle_tpu/ops/subblock_ops.py`` (same slots, attrs and
defaults). Where the JAX package traces a sub-block once into
``lax.scan`` / ``lax.while_loop`` / ``lax.cond``, these ops run the
block's ops eagerly through the interpreter (``BlockLowerer.
lower_sub_block``), iteration by iteration:

* ``recurrent``: a Python loop over the time axis of ``[B, T, ...]``
  inputs (``reverse`` walks it backwards); step outputs are stacked on
  axis 1. Its gradient is the synthesized ``recurrent_grad``: on a train
  step the forward tape records the whole loop once.
* ``while``, bounded (``max_iterations > 0``): ``max_iterations`` steps,
  each step's carries selected by ``torch.where(active, new, old)`` as
  the JAX package's masked scan does; nothing is read on the host, so a
  captured ``run_multi_step`` holds it. ``while_grad`` reruns the bounded
  loop from ``InitX`` under autograd (``lower_grad_via_vjp``), counted in
  ``Executor.grad_op_reruns``. Unbounded (``max_iterations == 0``): the
  condition is read on the host once per iteration; forward only.
* ``cond``: the predicate is read on the host once and one branch runs.
  The other branch runs once per input signature on ``meta`` tensors, so
  both must give the same shapes and dtypes, as ``lax.cond`` requires.
* tensor arrays: ``core.types.TensorArray`` (a ``[capacity, ...]`` buffer
  and an int32 size), on the device; no array op reads the index on the
  host. An index is taken as ``jax.lax.dynamic_index_in_dim`` takes it:
  a negative one counts once from the end, then it is clamped into
  ``[0, capacity - 1]`` (a plain torch index past the end would be a
  device-side assert); ``write_to_array`` drops a write past the
  capacity and keeps the size.

Keys: step ``t`` of ``recurrent`` and of either ``while`` folds ``t``
into the op's own key (``ctx.rng()``); both ``cond`` branches take the
op's key. ``HOST_READS`` counts the host reads of ``while`` and ``cond``.
"""

import weakref

import torch

from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.core.types import TensorArray

# host reads of a predicate: an unbounded while's condition (once per
# iteration, and once at its exit) and cond's predicate
HOST_READS = {"while": 0, "cond": 0}


def reset_host_reads():
    for k in HOST_READS:
        HOST_READS[k] = 0


def _is_meta(t):
    if isinstance(t, TensorArray):
        t = t.buffer
    return isinstance(t, torch.Tensor) and t.device.type == "meta"


def _run_block(ctx, block_idx, env, key, device=None):
    return ctx.block_lowerer.lower_sub_block(
        block_idx, env, ctx.device if device is None else device, key)


def _step_key(base, t):
    return None if base is None else base.fold_in(t)


def _host_pred(t, op_type):
    """The predicate as a Python bool: the one host read."""
    HOST_READS[op_type] += 1
    return bool(t.reshape(()).item())


# ---------------------------------------------------------------------------
# recurrent: the time loop of StaticRNN / DynamicRNN
# ---------------------------------------------------------------------------


def _lower_recurrent(ctx, ins, attrs):
    in_names = list(attrs.get("input_step_names", []))
    pre_names = list(attrs.get("pre_state_names", []))
    state_names = list(attrs.get("state_names", []))
    out_names = list(attrs.get("output_step_names", []))
    param_names = list(attrs.get("param_names", []))
    reverse = attrs.get("reverse", False)
    seq_inputs = ins.get("inputs", [])
    states = list(ins.get("initial_states", []))
    params = ins.get("parameters", [])
    if not seq_inputs:
        raise ValueError("recurrent needs at least one step input")
    base = ctx.rng()
    steps = int(seq_inputs[0].shape[1])
    # shape inference runs one step, as tracing the scan's body once does
    # (the carries keep their shapes; a step output repeats over T)
    meta = _is_meta(seq_inputs[0])
    ys = [[] for _ in out_names]
    for t in range(min(steps, 1) if meta else steps):
        idx = steps - 1 - t if reverse else t
        env = dict(zip(param_names, params))
        env.update(zip(pre_names, states))
        env.update((n, x[:, idx]) for n, x in zip(in_names, seq_inputs))
        _run_block(ctx, attrs["sub_block"], env, _step_key(base, t))
        states = [env[n] for n in state_names]
        for y, n in zip(ys, out_names):
            y.append(env[n])
    if meta:
        return {"outputs": [y[0].unsqueeze(1).expand(
            (y[0].shape[0], steps) + tuple(y[0].shape[1:])) for y in ys],
            "final_states": states}
    if reverse:
        ys = [y[::-1] for y in ys]
    return {"outputs": [torch.stack(y, 1) for y in ys],
            "final_states": states}


register_op(
    "recurrent",
    inputs=["*inputs", "*initial_states", "*parameters"],
    outputs=["*outputs", "*final_states"],
    attrs={
        "sub_block": -1,
        "input_step_names": [],
        "pre_state_names": [],
        "state_names": [],
        "output_step_names": [],
        "param_names": [],
        "reverse": False,
    },
    lower=_lower_recurrent,
)


# ---------------------------------------------------------------------------
# cond: one of two sub-blocks
# ---------------------------------------------------------------------------

# op -> the input signatures whose branches were checked on meta tensors
_COND_CHECKED = weakref.WeakKeyDictionary()


def _signature(vals):
    return tuple((tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor)
                 else type(v).__name__ for v in vals)


def _meta(v):
    if isinstance(v, TensorArray):
        return TensorArray(_meta(v.buffer), _meta(v.size))
    return torch.empty(v.shape, dtype=v.dtype, device="meta")


def _check_branches(op_type, got_t, got_f):
    sig_t, sig_f = _signature(got_t), _signature(got_f)
    if sig_t != sig_f:
        raise ValueError(
            "%s: the branches give different shapes or dtypes: true %s, "
            "false %s" % (op_type, sig_t, sig_f))


def _lower_cond(ctx, ins, attrs):
    """Both branches must produce the declared output names with matching
    shapes and dtypes (the JAX package's ``lax.cond`` contract)."""
    input_names = list(attrs.get("input_names", []))
    outs = {True: (attrs["true_block"], list(attrs.get("true_out_names", []))),
            False: (attrs["false_block"],
                    list(attrs.get("false_out_names", [])))}
    xs = ins.get("X", [])
    key = ctx.rng()

    def branch(which, vals, k, device=None):
        block_idx, names = outs[which]
        env = dict(zip(input_names, vals))
        _run_block(ctx, block_idx, env, k, device)
        return [env[n] for n in names]

    pred = ins["Cond"][0]
    if _is_meta(pred):
        pred.reshape(())   # one predicate, as lax.cond takes
        got = branch(True, xs, None)
        _check_branches("cond", got, branch(False, xs, None))
        return {"Out": got}
    which = _host_pred(pred, "cond")
    got = branch(which, xs, key)
    seen = _COND_CHECKED.setdefault(ctx.op, set())
    sig = _signature(xs)
    if sig not in seen:
        other = branch(not which, [_meta(x) for x in xs], None,
                       torch.device("meta"))
        _check_branches("cond", *((got, other) if which else (other, got)))
        seen.add(sig)
    return {"Out": got}


register_op(
    "cond",
    inputs=["Cond", "*X"],
    outputs=["*Out"],
    attrs={
        "true_block": -1,
        "false_block": -1,
        "input_names": [],
        "true_out_names": [],
        "false_out_names": [],
    },
    lower=_lower_cond,
    no_grad_inputs=("Cond",),
)


# ---------------------------------------------------------------------------
# while
# ---------------------------------------------------------------------------


def _select(active, new, old):
    """``new`` where the loop is still active, else ``old`` (the masked
    scan's ``jnp.where``), tensor arrays part by part."""
    if isinstance(new, TensorArray):
        return TensorArray(_select(active, new.buffer, old.buffer),
                           _select(active, new.size, old.size))
    return torch.where(active, new, old.to(new.dtype))


def _lower_while(ctx, ins, attrs):
    """The carries are the declared carry vars (attr ``carry_names``),
    which the sub-block reads and writes; the condition is one of them
    (a [1] bool). Out aliases X; InitX keeps the pre-loop carries under
    fresh names for ``while_grad``."""
    carry_names = list(attrs.get("carry_names", []))
    param_names = list(attrs.get("param_names", []))
    cond_name = attrs["cond_name"]
    carries = list(ins.get("X", []))
    params = ins.get("parameters", [])
    if any(_is_meta(c) for c in carries):
        # shape inference: the carries keep their shapes
        return {"Out": carries, "InitX": carries}
    base = ctx.rng()
    max_iters = int(attrs.get("max_iterations", 0))
    vals = carries
    if max_iters:
        for t in range(max_iters):
            env = dict(zip(param_names, params))
            env.update(zip(carry_names, vals))
            active = env[cond_name].reshape(()).to(torch.bool)
            _run_block(ctx, attrs["sub_block"], env, _step_key(base, t))
            vals = [_select(active, env[n], v)
                    for n, v in zip(carry_names, vals)]
        return {"Out": vals, "InitX": carries}
    t = 0
    while _host_pred(dict(zip(carry_names, vals))[cond_name], "while"):
        env = dict(zip(param_names, params))
        env.update(zip(carry_names, vals))
        _run_block(ctx, attrs["sub_block"], env, _step_key(base, t))
        vals = [env[n] for n in carry_names]
        t += 1
    return {"Out": vals, "InitX": carries}


def _while_grad_maker(op, out_grads, wanted):
    """while's Out aliases X (in-place carries), so by grad time the env
    holds the post-loop values under those names; the InitX outputs saved
    the pre-loop carries under fresh names (graph-level StepScopes,
    while_op.cc:50-72), and while_grad reruns the bounded loop from
    them."""
    inputs = {
        "InitX": list(op.output("InitX")),
        "parameters": list(op.input("parameters")),
        "Out@GRAD": [g or "" for g in out_grads.get("Out", [])],
    }
    outputs = {}
    if "X" in wanted:
        outputs["X@GRAD"] = wanted["X"]
    if "parameters" in wanted:
        outputs["parameters@GRAD"] = wanted["parameters"]
    keep = ("sub_block", "carry_names", "param_names", "cond_name",
            "max_iterations")
    return [{
        "type": "while_grad",
        "inputs": inputs,
        "outputs": outputs,
        "attrs": {k: op.attrs[k] for k in keep if k in op.attrs},
    }]


def _lower_while_grad(ctx, ins, attrs):
    from paddle_tpu_torch.core.op_registry import (
        _diff_index,
        get_op_def,
        lower_grad_via_vjp,
    )

    if not attrs.get("max_iterations", 0):
        raise RuntimeError(
            "cannot differentiate a While with max_iterations=0: the "
            "unbounded lax.while_loop lowering is forward-only. Build the "
            "loop as fluid.layers.While(cond, max_iterations=N) to train "
            "through it (bounded masked-scan lowering).")
    op = ctx.op
    fwd_ins = {"X": ins.get("InitX", []),
               "parameters": ins.get("parameters", [])}
    wanted = {}
    xg = op.output("X@GRAD")
    pg = op.output("parameters@GRAD")
    if any(xg):
        wanted["X"] = [bool(n) for n in xg]
    if any(pg):
        wanted["parameters"] = [bool(n) for n in pg]
    if _diff_index(fwd_ins, wanted) and ctx.block_lowerer is not None:
        # the rerun of the loop under autograd (no forward tape entry)
        ctx.block_lowerer.grad_reruns += 1
    gres = lower_grad_via_vjp(get_op_def("while"), ctx, fwd_ins, attrs,
                              {"Out": ins.get("Out@GRAD", [])}, wanted)
    out = {}
    if "X" in gres:
        out["X@GRAD"] = gres["X"]
    if "parameters" in gres:
        out["parameters@GRAD"] = gres["parameters"]
    return out


register_op(
    "while",
    inputs=["*X", "*parameters"],
    outputs=["*Out", "*InitX"],
    attrs={
        "sub_block": -1,
        "carry_names": [],
        "param_names": [],
        "cond_name": "",
        "max_iterations": 0,
    },
    lower=_lower_while,
    grad=_while_grad_maker,
    intermediate_outputs=("InitX",),
)


register_op(
    "while_grad",
    inputs=["*InitX", "*parameters", "*Out@GRAD"],
    outputs=["*X@GRAD", "*parameters@GRAD"],
    attrs={
        "sub_block": -1,
        "carry_names": [],
        "param_names": [],
        "cond_name": "",
        "max_iterations": 0,
    },
    lower=_lower_while_grad,
    grad=None,
)


# ---------------------------------------------------------------------------
# tensor arrays: (buffer, size) with a static capacity
# ---------------------------------------------------------------------------


def _index(t):
    """A [1] int64 index on the tensor's device (never read on the
    host)."""
    return t.reshape(1).to(torch.int64)


def _row(i, cap):
    """The buffer row index ``i`` ([1] int64) lands on, as
    ``jax.lax.dynamic_index_in_dim`` takes it: a negative index counts
    once from the end, then it is clamped into ``[0, cap - 1]``."""
    return torch.where(i < 0, i + cap, i).clamp(0, cap - 1)


def _lower_write_to_array(ctx, ins, attrs):
    x = ins["X"][0]
    i = _index(ins["I"][0])
    arr = ins.get("Array")
    if arr:
        buf, size = arr[0].buffer, arr[0].size
    else:
        cap = int(attrs.get("capacity", 0))
        if cap <= 0:
            raise ValueError(
                "first write_to_array needs a static 'capacity' attr "
                "(array buffers have fixed shapes)")
        buf = torch.zeros((cap,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        size = torch.zeros((), dtype=torch.int32, device=x.device)
    cap = buf.shape[0]
    # a write past the capacity is dropped (its row written back
    # unchanged); a negative one lands where the JAX package's does
    row = _row(i, cap)
    in_bounds = i < cap
    new = torch.where(in_bounds.reshape((1,) * (x.dim() + 1)),
                      x.to(buf.dtype).unsqueeze(0), buf.index_select(0, row))
    buf = buf.index_copy(0, row, new)
    size = torch.where(in_bounds.reshape(()),
                       torch.maximum(size, (i + 1).reshape(()).to(
                           torch.int32)), size)
    return {"Out": [TensorArray(buf, size)]}


register_op(
    "write_to_array",
    inputs=["X", "I", "Array"],
    outputs=["Out"],
    attrs={"capacity": 0},
    lower=_lower_write_to_array,
    grad=None,
)


def _lower_read_from_array(ctx, ins, attrs):
    buf = ins["X"][0].buffer
    return buf.index_select(0, _row(_index(ins["I"][0]), buf.shape[0]))[0]


register_op(
    "read_from_array",
    inputs=["X", "I"],
    outputs=["Out"],
    lower=_lower_read_from_array,
    grad=None,
)


register_op(
    "lod_array_length",
    inputs=["X"],
    outputs=["Out"],
    lower=lambda ctx, ins, attrs: ins["X"][0].size.to(
        torch.int64).reshape(1),
    grad=None,
)


def _array_to_lod_tensor_grad_maker(op, out_grads, wanted):
    # dX (an array) = lod_tensor_to_array of the dense dOut: the pair makes
    # the round trip differentiable (array_to_lod_tensor_op.cc's grad)
    return [{
        "type": "lod_tensor_to_array",
        "inputs": {"X": [out_grads["Out"][0]],
                   "RankTable": list(op.input("RankTable"))},
        "outputs": {"Out": wanted["X"]},
        "attrs": {},
    }]


register_op(
    "array_to_lod_tensor",
    inputs=["X", "RankTable"],
    outputs=["Out"],
    # the time-major buffer [cap, B, ...] -> the batch-major [B, cap, ...];
    # unwritten rows past the size stay zero padding
    lower=lambda ctx, ins, attrs: ins["X"][0].buffer.movedim(0, 1),
    grad=_array_to_lod_tensor_grad_maker,
    no_grad_inputs=("RankTable",),
)


def _lod_tensor_to_array_grad_maker(op, out_grads, wanted):
    # dX (dense) = array_to_lod_tensor of the array's gradient
    return [{
        "type": "array_to_lod_tensor",
        "inputs": {"X": [out_grads["Out"][0]],
                   "RankTable": list(op.input("RankTable"))},
        "outputs": {"Out": wanted["X"]},
        "attrs": {},
    }]


def _lower_lod_tensor_to_array(ctx, ins, attrs):
    x = ins["X"][0]
    size = torch.full((), x.shape[1], dtype=torch.int32, device=x.device)
    return {"Out": [TensorArray(x.movedim(1, 0), size)]}


register_op(
    "lod_tensor_to_array",
    inputs=["X", "RankTable"],
    outputs=["Out"],
    lower=_lower_lod_tensor_to_array,
    grad=_lod_tensor_to_array_grad_maker,
    no_grad_inputs=("RankTable",),
)
