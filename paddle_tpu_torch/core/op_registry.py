"""Operator registry: schema + torch lowering.

Counterpart of ``paddle_tpu/core/op_registry.py`` (``op_registry.h:190``
registrar parity). Each op registers a *lowering*: a plain function on
torch tensors, ``lower(ctx, ins, attrs) -> outputs``, that the eager
``BlockLowerer`` calls op by op.

Gradients: an op registered with ``grad="auto"`` gets a synthesized
``<type>_grad`` op (``ensure_auto_grad_op``) whose lowering re-runs the
forward lowering on detached leaves that require grad and differentiates
it with ``torch.autograd.grad``, as the JAX package re-traces the forward
under ``jax.vjp``. XLA's CSE removes that forward rerun inside one jitted
step; the eager port pays for it (PERF.md). A lowering that wraps a
``torch.autograd.Function`` (the flash attention kernels) gets that
Function's backward.
"""

import torch


class LowerContext(object):
    """Per-op context handed to lowering rules.

    Attributes:
      op: the framework.Operator being lowered (desc access).
      is_test: inference mode flag.
      block_lowerer: the BlockLowerer driving the run.
      device: the torch.device ops with no tensor input allocate on
        (``meta`` during build-time shape inference).
    """

    def __init__(self, op, rng, is_test=False, block_lowerer=None,
                 device=None):
        self.op = op
        self._rng = rng
        self.is_test = is_test
        self.block_lowerer = block_lowerer
        self.device = device

    def rng(self):
        """A torch.Generator for this op instance on ``device`` (None
        during shape inference), seeded from (program seed, run, op id)
        or from the op's nonzero ``seed`` attr."""
        return self._rng()


class OpDef(object):
    __slots__ = (
        "type",
        "inputs",
        "outputs",
        "attrs",
        "lower",
        "grad",
        "no_grad_inputs",
        "intermediate_outputs",
        "infer_shape",
    )

    def __init__(self, type, inputs, outputs, attrs, lower, grad,
                 no_grad_inputs, intermediate_outputs, infer_shape):
        self.type = type
        self.inputs = inputs  # list of slot names; "*X" marks duplicable
        self.outputs = outputs
        self.attrs = attrs  # dict name -> default
        self.lower = lower  # fn(ctx, ins, attrs) -> dict slot -> value(s)
        self.grad = grad
        self.no_grad_inputs = no_grad_inputs
        self.intermediate_outputs = intermediate_outputs
        self.infer_shape = infer_shape  # optional override

    def input_slots(self):
        return [s.lstrip("*") for s in self.inputs]

    def output_slots(self):
        return [s.lstrip("*") for s in self.outputs]

    def is_duplicable_input(self, slot):
        return ("*" + slot) in self.inputs

    def is_duplicable_output(self, slot):
        return ("*" + slot) in self.outputs


_REGISTRY = {}


def register_op(type, inputs, outputs, attrs=None, lower=None, grad="auto",
                no_grad_inputs=(), intermediate_outputs=(),
                infer_shape=None):
    """Register an operator definition (REGISTER_OPERATOR analog)."""
    if type in _REGISTRY:
        raise ValueError("op %r already registered" % type)
    if lower is None:
        raise ValueError("op %r needs a lowering rule" % type)
    opdef = OpDef(
        type=type,
        inputs=list(inputs),
        outputs=list(outputs),
        attrs=dict(attrs or {}),
        lower=lower,
        grad=grad,
        no_grad_inputs=frozenset(no_grad_inputs),
        intermediate_outputs=frozenset(intermediate_outputs),
        infer_shape=infer_shape,
    )
    _REGISTRY[type] = opdef
    return opdef


def get_op_def(type):
    opdef = _REGISTRY.get(type)
    if opdef is None:
        raise KeyError("operator %r is not registered" % type)
    return opdef


def has_op(type):
    return type in _REGISTRY


def registered_ops():
    return sorted(_REGISTRY)


def normalize_outputs(opdef, result):
    """Lowerings may return a single tensor, a tuple (positional outputs),
    or a dict slot -> tensor|list. Normalize to dict slot -> list."""
    slots = opdef.output_slots()
    if isinstance(result, dict):
        out = {}
        for k, v in result.items():
            out[k] = list(v) if isinstance(v, (list, tuple)) else [v]
        return out
    if isinstance(result, tuple):
        if len(result) != len(slots):
            raise ValueError(
                "op %s lowering returned %d outputs, schema has %d"
                % (opdef.type, len(result), len(slots)))
        return {s: [r] for s, r in zip(slots, result)}
    return {slots[0]: [result]}


# ---------------------------------------------------------------------------
# Generic vjp-based gradient lowering (op_registry.py:179-322)
# ---------------------------------------------------------------------------


def lower_grad_via_vjp(fwd_def, ctx, ins, attrs, out_grads,
                       wanted_input_grads):
    """Lower a ``<type>_grad`` op by differentiating the forward lowering.

    ins: forward inputs, dict slot -> list[tensor].
    out_grads: dict fwd-output-slot -> list[tensor or None] (None, or a
      missing entry, is a zero cotangent).
    wanted_input_grads: dict fwd-input-slot -> list[bool].

    Returns dict fwd-input-slot -> list[tensor or None]; a wanted float
    input the outputs do not depend on gets zeros, as jax.vjp gives.
    """
    diff_index = []  # (slot, i): wanted AND floating point
    for slot, arrs in ins.items():
        wants = wanted_input_grads.get(slot, [False] * len(arrs))
        for i, a in enumerate(arrs):
            if i < len(wants) and wants[i] and a.is_floating_point():
                diff_index.append((slot, i))
    if not diff_index:
        return {}

    local = {s: list(v) for s, v in ins.items()}
    leaves = []
    with torch.enable_grad():
        for slot, i in diff_index:
            leaf = local[slot][i].detach().requires_grad_(True)
            local[slot][i] = leaf
            leaves.append(leaf)
        outs = normalize_outputs(fwd_def, fwd_def.lower(ctx, local, attrs))
        ys, cots = [], []
        for oslot, refs in outs.items():
            gs = out_grads.get(oslot, [])
            for j, ref in enumerate(refs):
                g = gs[j] if j < len(gs) else None
                # only float outputs that depend on a leaf take a
                # cotangent; a zero cotangent contributes nothing
                if g is None or ref is None or not ref.requires_grad:
                    continue
                ys.append(ref)
                cots.append(g.to(ref.dtype).reshape(ref.shape))
        grads = (torch.autograd.grad(ys, leaves, cots, allow_unused=True)
                 if ys else [None] * len(leaves))

    out = {}
    for (slot, i), leaf, g in zip(diff_index, leaves, grads):
        if slot not in out:
            out[slot] = [None] * len(ins[slot])
        out[slot][i] = torch.zeros_like(leaf) if g is None else g
    return out


def ensure_auto_grad_op(fwd_type):
    """Register (once) the synthesized ``<type>_grad`` operator whose
    lowering differentiates the forward rule. GradOpDescMaker analog."""
    gtype = fwd_type + "_grad"
    if gtype in _REGISTRY:
        return _REGISTRY[gtype]
    fwd = get_op_def(fwd_type)
    if fwd.grad is None:
        raise ValueError("op %r has no gradient" % fwd_type)

    g_inputs = list(fwd.inputs)
    for s in fwd.outputs:
        g_inputs.append(s)
        star = "*" if s.startswith("*") else ""
        g_inputs.append(star + s.lstrip("*") + "@GRAD")
    g_outputs = [
        ("*" if s.startswith("*") else "") + s.lstrip("*") + "@GRAD"
        for s in fwd.inputs
    ]

    def lower(ctx, ins, attrs):
        op = ctx.op
        fwd_ins = {s: ins[s] for s in fwd.input_slots() if s in ins}
        out_grads = {o: ins[o + "@GRAD"] for o in fwd.output_slots()
                     if (o + "@GRAD") in ins}
        wanted = {}
        for s in fwd.input_slots():
            names = op.output(s + "@GRAD")
            if any(names):
                wanted[s] = [bool(n) for n in names]
        gres = lower_grad_via_vjp(fwd, ctx, fwd_ins, attrs, out_grads,
                                  wanted)
        return {s + "@GRAD": gs for s, gs in gres.items()}

    return register_op(gtype, inputs=g_inputs, outputs=g_outputs,
                       lower=lower, grad=None)
