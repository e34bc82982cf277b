"""Operator registry: schema + torch lowering.

Counterpart of ``paddle_tpu/core/op_registry.py`` (``op_registry.h:190``
registrar parity). Each op registers a *lowering*: a plain function on
torch tensors, ``lower(ctx, ins, attrs) -> outputs``, that the eager
``BlockLowerer`` calls op by op.

Gradients: an op registered with ``grad="auto"`` gets a synthesized
``<type>_grad`` op (``ensure_auto_grad_op``), a real op of the program,
as in the JAX package. Where a block holds both the forward op and its
grad op, the forward runs once: the ``BlockLowerer`` runs its lowering on
detached leaves that require grad (``record_forward``) and keeps the
autograd graph on the run's forward tape, and the grad op differentiates
that graph with ``torch.autograd.grad`` (``grad_from_tape``), as XLA's
CSE shares the forward between an op and the ``jax.vjp`` rerun of its
grad op inside the JAX package's one jitted step. A grad op with no tape
entry (its forward in another run or block, or an input changed since
the forward) reruns the forward lowering under autograd
(``lower_grad_via_vjp``, counted). A lowering that wraps a
``torch.autograd.Function`` (the flash attention and recurrence
kernels) gets that Function's backward.
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
        # a grad op's entry of the forward tape (TapeEntry), if any
        self.tape_entry = None
        # the op's inputs as the block holds them, before the AMP casts
        # (core/amp.py): what the tape's checks compare
        self.raw_ins = None

    def rng(self):
        """This op instance's threefry key, a ``prng.KeyChain`` (None
        during shape inference): ``fold_in(step_key, __rng_id__)``, or
        ``fold_in(PRNGKey(seed), __rng_id__)`` for a nonzero ``seed``
        attr, as the JAX package derives it."""
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
# Gradient lowering: the forward tape, or a vjp rerun of the forward
# ---------------------------------------------------------------------------


def wanted_grads(grad_op, fwd_def):
    """{fwd input slot: [bool]}: the inputs whose ``@GRAD`` ``grad_op``
    writes."""
    wanted = {}
    for s in fwd_def.input_slots():
        names = grad_op.output(s + "@GRAD")
        if any(names):
            wanted[s] = [bool(n) for n in names]
    return wanted


def _diff_index(ins, wanted):
    """[(slot, i)]: the inputs both wanted and floating-point tensors (a
    tensor array, ``core.types.TensorArray``, takes no gradient)."""
    out = []
    for slot, arrs in ins.items():
        wants = wanted.get(slot, [False] * len(arrs))
        for i, a in enumerate(arrs):
            if (i < len(wants) and wants[i] and isinstance(a, torch.Tensor)
                    and a.is_floating_point()):
                out.append((slot, i))
    return out


def _with_leaves(ins, diff_index):
    """A copy of ``ins`` whose ``diff_index`` entries are detached leaves
    that require grad; returns (copy, leaves)."""
    local = {s: list(v) for s, v in ins.items()}
    leaves = []
    for slot, i in diff_index:
        leaf = local[slot][i].detach().requires_grad_(True)
        local[slot][i] = leaf
        leaves.append(leaf)
    return local, leaves


def _differentiate(outs, leaves, out_grads):
    """torch.autograd.grad of the outputs that take a cotangent: only
    float outputs that depend on a leaf do (a zero cotangent adds
    nothing), each cast and reshaped to its output."""
    ys, cots = [], []
    for oslot, refs in outs.items():
        gs = out_grads.get(oslot, [])
        for j, ref in enumerate(refs):
            g = gs[j] if j < len(gs) else None
            if (g is None or not isinstance(ref, torch.Tensor)
                    or not ref.requires_grad):
                continue
            ys.append(ref)
            cots.append(g.to(ref.dtype).reshape(ref.shape))
    if not ys:
        return [None] * len(leaves)
    return torch.autograd.grad(ys, leaves, cots, allow_unused=True)


def _input_grads(ins, diff_index, leaves, grads):
    """fwd-input-slot -> [grad or None]; a wanted input the outputs do not
    reach gets zeros, as jax.vjp gives."""
    out = {}
    for (slot, i), leaf, g in zip(diff_index, leaves, grads):
        if slot not in out:
            out[slot] = [None] * len(ins[slot])
        out[slot][i] = torch.zeros_like(leaf) if g is None else g
    return out


def lower_grad_via_vjp(fwd_def, ctx, ins, attrs, out_grads,
                       wanted_input_grads):
    """Lower a ``<type>_grad`` op by rerunning the forward lowering under
    autograd and differentiating it.

    ins: forward inputs, dict slot -> list[tensor].
    out_grads: dict fwd-output-slot -> list[tensor or None] (None, or a
      missing entry, is a zero cotangent).
    wanted_input_grads: dict fwd-input-slot -> list[bool].

    Returns dict fwd-input-slot -> list[tensor or None].
    """
    diff_index = _diff_index(ins, wanted_input_grads)
    if not diff_index:
        return {}
    local, leaves = _with_leaves(ins, diff_index)
    with torch.enable_grad():
        outs = normalize_outputs(fwd_def, fwd_def.lower(ctx, local, attrs))
        grads = _differentiate(outs, leaves, out_grads)
    return _input_grads(ins, diff_index, leaves, grads)


class TapeEntry(object):
    """One forward op's autograd graph, kept on the run's tape for its
    paired grad op: the leaves, the outputs (with their graph), and the
    tensors the block held under the forward's input names right after
    the forward ran, with their versions."""

    __slots__ = ("ins", "diff_index", "leaves", "outs", "inputs")

    def __init__(self, ins, diff_index, leaves, outs):
        self.ins = {s: len(v) for s, v in ins.items()}
        self.diff_index = diff_index
        self.leaves = leaves
        self.outs = outs
        self.inputs = []

    def snapshot(self, tensors):
        """The tensors the forward's input names hold after the forward
        (a state input the op rewrites, as batch_norm's moving
        statistics, holds the op's new value; a tensor array has no
        version and is compared by identity)."""
        self.inputs = [(t, getattr(t, "_version", None)) for t in tensors]

    def holds(self, tensors):
        """The grad op reads exactly what the snapshot saw, unmodified."""
        return len(tensors) == len(self.inputs) and all(
            t is u and getattr(t, "_version", None) == v
            for t, (u, v) in zip(tensors, self.inputs))


def record_forward(fwd_def, ctx, ins, attrs, wanted):
    """Run a forward lowering once, recording its autograd graph for the
    grad op that wants ``wanted`` (:func:`wanted_grads`). Returns (the
    outputs, detached, as normalize_outputs gives them; the TapeEntry,
    or None when no wanted input is floating point)."""
    diff_index = _diff_index(ins, wanted)
    if not diff_index:
        return normalize_outputs(fwd_def, fwd_def.lower(ctx, ins, attrs)), \
            None
    local, leaves = _with_leaves(ins, diff_index)
    with torch.enable_grad():
        outs = normalize_outputs(fwd_def, fwd_def.lower(ctx, local, attrs))
    detached = {s: [v.detach() if isinstance(v, torch.Tensor) else v
                    for v in vs] for s, vs in outs.items()}
    return detached, TapeEntry(ins, diff_index, leaves, outs)


def grad_from_tape(entry, out_grads, op_type):
    """The input gradients from a forward's recorded graph (the graph is
    freed after). A failure raises naming the op: the tape never falls
    back to a rerun once it holds the entry."""
    try:
        grads = _differentiate(entry.outs, entry.leaves, out_grads)
    except Exception as e:
        raise RuntimeError("%s_grad: differentiating the forward tape's "
                           "graph failed: %s" % (op_type, e)) from e
    ins = {s: [None] * n for s, n in entry.ins.items()}
    return _input_grads(ins, entry.diff_index, entry.leaves, grads)


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
        fwd_ins = {s: ins[s] for s in fwd.input_slots() if s in ins}
        out_grads = {o: ins[o + "@GRAD"] for o in fwd.output_slots()
                     if (o + "@GRAD") in ins}
        entry = ctx.tape_entry
        held = ctx.raw_ins if ctx.raw_ins is not None else ins
        if entry is not None and entry.holds(
                [t for s in fwd.input_slots() for t in held.get(s, [])]):
            gres = grad_from_tape(entry, out_grads, fwd_type)
        else:
            wanted = wanted_grads(ctx.op, fwd)
            if _diff_index(fwd_ins, wanted) and ctx.block_lowerer:
                ctx.block_lowerer.grad_reruns += 1
            gres = lower_grad_via_vjp(fwd, ctx, fwd_ins, attrs, out_grads,
                                      wanted)
        return {s + "@GRAD": gs for s, gs in gres.items()}

    return register_op(gtype, inputs=g_inputs, outputs=g_outputs,
                       lower=lower, grad=None)
