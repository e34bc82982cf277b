"""The declarative Program graph IR, built from Python.

Counterpart of ``paddle_tpu/framework.py`` (Program:1404, Block:920,
Operator:494, Variable:204 parity). Shape inference runs each op's torch
lowering on ``meta`` tensors (shapes and dtypes, no data): one source of
truth for shapes instead of hand-written InferShape per op. A lowering
that has to read a value (a data-dependent shape) gives its op an
``infer_shape`` hook instead.
"""

import contextlib
import copy

import torch

from paddle_tpu_torch.core import op_registry
from paddle_tpu_torch.core.types import (
    CPUPlace,
    CUDAPlace,
    VarType,
    canonical_dtype,
    device_dtype,
)

# Sentinel used to stand in for the -1 (dynamic batch) dimension during
# build-time shape inference; output dims equal to it map back to -1.
_DYN_SENTINEL = 557

OP_ROLE_ATTR_NAME = "op_role"
OP_ROLE_VAR_ATTR_NAME = "op_role_var"


class OpRole(object):
    Forward = 0
    Backward = 1
    Optimize = 2
    RPC = 3
    Dist = 4
    LRSched = 16
    Loss = 256


class Variable(object):
    """A typed symbolic value in a Block (framework.py:204 parity)."""

    def __init__(self, block, name, shape=None, dtype="float32", lod_level=0,
                 persistable=False, stop_gradient=False,
                 type=VarType.LOD_TENSOR, is_data=False, initializer=None):
        self.block = block
        self.name = name
        self.shape = tuple(int(d) for d in shape) if shape is not None else None
        self.dtype = canonical_dtype(dtype) if type == VarType.LOD_TENSOR else dtype
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.type = type
        self.is_data = is_data
        self.initializer = initializer
        self.op = None  # producing op (set by append_op)

    @property
    def ndim(self):
        return None if self.shape is None else len(self.shape)

    @property
    def recorded_dtype(self):
        """The dtype a saved program records for this var, as the JAX
        package records it. Its shape inference runs with 64-bit integers
        off, so an int64 temporary an op produces is recorded int32 (the
        run here keeps int64); state, feeds and the outputs of an op whose
        build-time inference is still deferred keep the dtype they are
        declared with."""
        op = self.op
        if (self.dtype != "int64" or op is None or self.persistable
                or self.is_data or any(
                    o is op for _, o in self.block.program._deferred_infer)):
            return self.dtype
        return "int32"

    def astype(self, dtype):
        """This variable cast to ``dtype`` (a ``cast`` op)."""
        from paddle_tpu_torch.layers import tensor as tensor_layers

        return tensor_layers.cast(self, dtype)

    def __repr__(self):
        return "Variable(%s, shape=%s, dtype=%s%s)" % (
            self.name, self.shape, self.dtype,
            ", persistable" if self.persistable else "")

    __str__ = __repr__

    # Operator sugar so variables compose like arrays in user scripts.
    def _binary(self, other, op, reverse=False):
        from paddle_tpu_torch.layers import math_ops

        if reverse:
            return math_ops.elementwise_binary_reversed(op, self, other)
        return math_ops.elementwise_binary(op, self, other)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._binary(other, "elementwise_sub", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __rtruediv__(self, other):
        return self._binary(other, "elementwise_div", reverse=True)

    def __pow__(self, other):
        return self._binary(other, "elementwise_pow")

    def __rpow__(self, other):
        return self._binary(other, "elementwise_pow", reverse=True)

    def __neg__(self):
        from paddle_tpu_torch.layers import nn

        return nn.scale(self, scale=-1.0)


class Parameter(Variable):
    """A trainable persistable Variable (framework.py Parameter parity)."""

    def __init__(self, block, name, shape, dtype, **kwargs):
        self.trainable = kwargs.pop("trainable", True)
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
        super(Parameter, self).__init__(
            block, name, shape=shape, dtype=dtype, persistable=True, **kwargs)
        self.stop_gradient = not self.trainable


class Operator(object):
    """One op instance in a Block (framework.py:494 / op_desc.h:29 parity).

    inputs/outputs: dict slot -> list of var names. attrs: plain dict.
    """

    def __init__(self, block, type, inputs, outputs, attrs=None):
        op_registry.get_op_def(type)  # validate registration
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        prog = block.program
        self.attrs.setdefault(OP_ROLE_ATTR_NAME, prog._op_role)
        if prog._op_role_var and OP_ROLE_VAR_ATTR_NAME not in self.attrs:
            self.attrs[OP_ROLE_VAR_ATTR_NAME] = list(prog._op_role_var)
        if "__rng_id__" not in self.attrs:
            self.attrs["__rng_id__"] = prog._next_rng_id()

    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def has_attr(self, name):
        return name in self.attrs

    def attr(self, name):
        return self.attrs[name]

    def set_attr(self, name, val):
        self.attrs[name] = val
        self.block.program._bump_version()

    def __repr__(self):
        return "{%s: (%s) -> (%s)}" % (
            self.type,
            ", ".join("%s=%s" % kv for kv in self.inputs.items()),
            ", ".join("%s=%s" % kv for kv in self.outputs.items()))


class Block(object):
    """A straight-line list of ops + a var symbol table (framework.py:920)."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}  # name -> Variable
        self.ops = []
        self.forward_block_idx = -1

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise KeyError("var %r not in block %d" % (name, self.idx))
        return v

    def _find_var_recursive(self, name):
        block = self
        while block is not None:
            v = block.vars.get(name)
            if v is not None:
                return v
            block = block.parent_block
        return None

    def has_var(self, name):
        return name in self.vars

    def has_var_recursive(self, name):
        return self._find_var_recursive(name) is not None

    def create_var(self, name=None, **kwargs):
        from paddle_tpu_torch import unique_name

        if name is None:
            name = unique_name.generate("tmp")
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, name, **kwargs)
        self.vars[name] = v
        self.program._bump_version()
        return v

    def create_parameter(self, name, shape, dtype, **kwargs):
        # Parameters always live in the global (root) block, as in Fluid.
        global_block = self.program.global_block()
        if name in global_block.vars:
            return global_block.vars[name]
        p = Parameter(global_block, name, shape, dtype, **kwargs)
        global_block.vars[name] = p
        self.program._bump_version()
        return p

    def rename_var(self, old, new):
        """Rename ``old`` to ``new`` in this block's symbol table and in
        every op of the block."""
        v = self.vars.pop(old)
        v.name = new
        self.vars[new] = v
        for op in self.ops:
            for names in list(op.inputs.values()) + list(
                    op.outputs.values()):
                for i, n in enumerate(names):
                    if n == old:
                        names[i] = new
        self.program._bump_version()
        return v

    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  infer_shape=True):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        if infer_shape:
            try:
                _infer_op_shapes(self, op)
            except Exception:
                # best-effort at build time, as in the reference: an op
                # whose input shapes are unknown keeps shape None, and
                # execution derives every shape from the concrete feeds.
                # The deferral lets infer_deferred_shapes retry it once
                # feed shapes are known (the verifier does)
                self.program._defer_shape_inference(self.idx, op)
        else:
            self.program._defer_shape_inference(self.idx, op)
        for name in op.output_arg_names():
            v = self.vars.get(name)
            if v is not None and v.op is None:
                v.op = op
        self.program._bump_version()
        return op

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        try:
            _infer_op_shapes(self, op)
        except Exception:
            self.program._defer_shape_inference(self.idx, op)
        self.program._bump_version()
        return op

    def insert_op(self, index, type, inputs=None, outputs=None, attrs=None):
        """An op at ``index`` with no shape inference: the graph passes
        splice ops between ones whose outputs are already typed."""
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self.program._bump_version()
        return op

    def remove_op(self, index):
        self.ops.pop(index)
        self.program._bump_version()

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def iter_parameters(self):
        return iter(self.all_parameters())


class Program(object):
    """A list of Blocks; block 0 is global (framework.py:1404 parity).

    ``_version`` changes on every mutation, so the Executor's per-program
    analysis cache can tell a mutated program from the one it analysed.
    """

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._version = 0
        # (block idx, op) whose build-time shape inference was skipped or
        # failed; infer_deferred_shapes retries them
        self._deferred_infer = []
        self._rng_counter = 0
        self._is_test = False
        # the mixed-precision compute dtype (core/amp.py); None: float32
        self._amp_dtype = None
        self._op_role = OpRole.Forward
        self._op_role_var = []

    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    @property
    def num_blocks(self):
        return len(self.blocks)

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def create_block(self, parent_idx=None):
        """A new block whose parent is ``parent_idx`` (the current block
        by default); it becomes the current block."""
        parent = self.current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent_idx=parent)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        return b

    def rollback(self):
        """Make the current block's parent current again."""
        self.current_block_idx = self.current_block().parent_idx

    def _bump_version(self):
        self._version += 1

    def _defer_shape_inference(self, block_idx, op):
        self._deferred_infer.append((block_idx, op))

    def infer_deferred_shapes(self, feed_shapes=None):
        """Retry shape inference for ops deferred at append time
        (framework.py ``infer_deferred_shapes`` parity). ``feed_shapes``
        maps var name -> shape for data vars still missing one. Ops that
        succeed leave the deferred list; returns ``[(block_idx, op,
        error)]`` for those that still fail (the verifier's V011).
        Memoized per (version, feed shapes)."""
        pending = self._deferred_infer
        if not pending:
            return []
        memo_key = (self._version, tuple(sorted(
            (n, tuple(int(d) for d in s))
            for n, s in (feed_shapes or {}).items())))
        memo = getattr(self, "_deferred_infer_memo", None)
        if memo is not None and memo[0] == memo_key:
            return memo[1]
        for name, shape in (feed_shapes or {}).items():
            v = self.global_block()._find_var_recursive(name)
            if v is not None and v.shape is None:
                v.shape = tuple(int(d) for d in shape)
                self._bump_version()
        failures, remaining, resolved = [], [], False
        for block_idx, op in pending:
            block = self.blocks[block_idx] if block_idx < len(
                self.blocks) else None
            if block is None or not any(o is op for o in block.ops):
                continue  # op was pruned/removed since the deferral
            try:
                _infer_op_shapes(block, op)
                resolved = True
            except Exception as e:
                failures.append((block_idx, op, str(e)))
                remaining.append((block_idx, op))
        self._deferred_infer = remaining
        if resolved:
            self._bump_version()
        self._deferred_infer_memo = (
            (self._version, memo_key[1]), failures)
        return failures

    def verify(self, level="error", fetch_names=None, feed_shapes=None,
               feed_names=None, suppress=()):
        """Run the structural verifier (analysis/verify.py) over this
        program. Raises ``analysis.ProgramVerifyError`` when any
        diagnostic sits at or above ``level`` (level=None only
        collects); returns the full diagnostics list otherwise."""
        from paddle_tpu_torch.analysis import check_program

        return check_program(
            self, level=level, fetch_names=fetch_names,
            feed_shapes=feed_shapes, feed_names=feed_names,
            suppress=suppress)

    def _next_rng_id(self):
        self._rng_counter += 1
        return self._rng_counter

    @contextlib.contextmanager
    def _optimized_guard(self, param_and_grads):
        """Ops appended inside are stamped ``op_role = Optimize`` and
        ``op_role_var = [param, grad]`` names (framework.py:472)."""
        prev_role, prev_var = self._op_role, self._op_role_var
        self._op_role = OpRole.Optimize
        self._op_role_var = [
            v.name if isinstance(v, Variable) else v for v in param_and_grads
        ]
        try:
            yield
        finally:
            self._op_role, self._op_role_var = prev_role, prev_var

    @contextlib.contextmanager
    def _lr_schedule_guard(self):
        """Ops appended inside are stamped ``op_role = LRSched``
        (framework.py:484)."""
        prev = self._op_role
        self._op_role = OpRole.LRSched
        try:
            yield
        finally:
            self._op_role = prev

    def clone(self, for_test=False):
        """Deep copy; ``for_test`` flips every ``is_test`` attr (dropout's
        inference behaviour), as framework.py:493 does."""
        p = copy.deepcopy(self)
        if for_test:
            p._is_test = True
            for block in p.blocks:
                for op in block.ops:
                    if "is_test" in op.attrs:
                        op.attrs["is_test"] = True
        p._bump_version()
        return p

    def list_vars(self):
        for block in self.blocks:
            for v in block.vars.values():
                yield v

    def __repr__(self):
        lines = []
        for block in self.blocks:
            lines.append("-- block %d (parent %d) --"
                         % (block.idx, block.parent_idx))
            for v in block.vars.values():
                lines.append("  " + repr(v))
            for op in block.ops:
                lines.append("  " + repr(op))
        return "\n".join(lines)

    __str__ = __repr__


# ---------------------------------------------------------------------------
# Shape inference: the lowering rule run on meta tensors
# ---------------------------------------------------------------------------

_META = torch.device("meta")


def _infer_op_shapes(block, op):
    opdef = op_registry.get_op_def(op.type)
    if opdef.infer_shape is not None:
        opdef.infer_shape(block, op)
        return
    from paddle_tpu_torch.core.lowering import BlockLowerer

    ins = {}
    had_dynamic = False
    for slot in opdef.input_slots():
        arrs = []
        for name in op.input(slot):
            v = block._find_var_recursive(name)
            if v is None or v.shape is None:
                raise ValueError("unknown shape for input %s" % name)
            shape = []
            for d in v.shape:
                if d < 0:
                    shape.append(_DYN_SENTINEL)
                    had_dynamic = True
                else:
                    shape.append(d)
            arrs.append(torch.empty(shape, dtype=device_dtype(v.dtype),
                                    device=_META))
        # absent optional slots are omitted, as the executor does
        if arrs:
            ins[slot] = arrs
    ctx = op_registry.LowerContext(
        op, rng=lambda: None, is_test=False,
        block_lowerer=BlockLowerer(block.program, block.idx), device=_META)
    out = op_registry.normalize_outputs(opdef, opdef.lower(ctx, ins, op.attrs))
    for slot, vals in out.items():
        for name, t in zip(op.output(slot), vals):
            v = block._find_var_recursive(name)
            if v is None or t is None:
                continue
            # the sentinel is prime, so any output dim it multiplies into
            # (reshape merging batch with feature dims) maps back to -1 too
            v.shape = tuple(
                -1 if (had_dynamic and d != 0 and d % _DYN_SENTINEL == 0)
                else int(d) for d in t.shape)
            v.dtype = canonical_dtype(t.dtype)


def grad_var_name(name):
    return name + "@GRAD"


_name_scope_stack = []


@contextlib.contextmanager
def name_scope(prefix=None):
    """A naming scope for the ops built inside (framework.py name_scope
    parity: kept on a stack, names are not prefixed)."""
    _name_scope_stack.append(prefix or "")
    try:
        yield
    finally:
        _name_scope_stack.pop()


def cpu_places(device_count=None):
    """``device_count`` CPU places (one by default)."""
    return [CPUPlace(i) for i in range(device_count or 1)]


def tpu_places(device_ids=None):
    """The card places (``TPUPlace`` is ``CUDAPlace``): the given ids, or
    one per visible card (one where torch sees none, as the JAX package
    falls back to its default devices)."""
    if device_ids is None:
        device_ids = range(max(1, torch.cuda.device_count()))
    return [CUDAPlace(i) for i in device_ids]


# ---------------------------------------------------------------------------
# Default programs + guards (framework.py:2061-2129 parity)
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


def switch_main_program(program):
    global _main_program
    prev, _main_program = _main_program, program
    return prev


def switch_startup_program(program):
    global _startup_program
    prev, _startup_program = _startup_program, program
    return prev


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)
