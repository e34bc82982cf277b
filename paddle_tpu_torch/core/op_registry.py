"""Operator registry: schema + torch lowering.

Counterpart of ``paddle_tpu/core/op_registry.py`` (``op_registry.h:190``
registrar parity). Each op registers a *lowering*: a plain function on
torch tensors, ``lower(ctx, ins, attrs) -> outputs``, that the eager
``BlockLowerer`` calls op by op. Gradient synthesis (``<type>_grad`` ops)
comes with the training slice; ``grad`` is recorded for schema parity.
"""


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
