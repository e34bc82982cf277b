"""Control-flow layers: the comparisons, increment, is_empty, tensor
arrays, the rank table and the sub-block constructs.

Counterpart of ``paddle_tpu/layers/control_flow.py``, with its names,
signatures and minted variable names (``set_deterministic_params`` seeds
by name): ``StaticRNN`` (the ``recurrent`` op over a sub-block),
``DynamicRNN`` (the same over padded sequences, with length masks),
``While`` (the ``while`` op; bounded with ``max_iterations``, which
trains through it), ``cond`` / ``Switch`` (the ``cond`` op) and
``IfElse`` (a dense ``where_select`` merge). The ops run in
``ops/subblock_ops.py``.
"""

import contextlib

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = [
    "less_than",
    "less_equal",
    "greater_than",
    "greater_equal",
    "equal",
    "not_equal",
    "increment",
    "is_empty",
    "array_write",
    "array_read",
    "array_length",
    "create_array",
    "StaticRNN",
    "DynamicRNN",
    "While",
    "Switch",
    "IfElse",
    "cond",
    "lod_rank_table",
    "reorder_lod_tensor_by_rank",
    "lod_tensor_to_array",
    "array_to_lod_tensor",
]


def _compare(op_type):
    def fn(x, y, cond=None, **kwargs):
        helper = LayerHelper(op_type)
        if cond is None:
            cond = helper.create_variable_for_type_inference("bool")
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [cond]})
        return cond

    fn.__name__ = op_type
    return fn


less_than = _compare("less_than")
less_equal = _compare("less_equal")
greater_than = _compare("greater_than")
greater_equal = _compare("greater_equal")
equal = _compare("equal")
not_equal = _compare("not_equal")


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def is_empty(x, cond=None):
    helper = LayerHelper("is_empty")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool",
                                                         stop_gradient=True)
    helper.append_op(type="is_empty", inputs={"X": [x]},
                     outputs={"Out": [cond]})
    return cond


# -- LoDTensorArray (on the device: ops/subblock_ops.py TensorArray) --------


class LoDTensorArray(list):
    """Host-side tensor array (fluid.LoDTensorArray parity): a plain list
    of numpy arrays, what a fetch of an array variable returns. On the
    device the array ops hold a fixed-capacity ``(buffer, size)`` pair
    (``ops/subblock_ops.py`` ``TensorArray``)."""


def create_array(dtype):
    from paddle_tpu_torch.core.types import VarType

    helper = LayerHelper("array")
    return helper.block.create_var(
        name=unique_name.generate("array"),
        type=VarType.LOD_TENSOR_ARRAY,
        dtype=dtype,
        shape=None,
    )


def array_write(x, i, array=None, capacity=128):
    """Write x into array[i]. First write allocates a static ``capacity``
    buffer (fixed shapes, as in the JAX package; the reference grows a
    vector of tensors, tensor_array_read_write_op.cc)."""
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    helper.append_op(
        type="write_to_array",
        inputs={"X": [x], "I": [i], "Array": [array]}
        if getattr(array, "_array_written", False)
        else {"X": [x], "I": [i]},
        outputs={"Out": [array]},
        attrs={"capacity": int(capacity)},
    )
    array._array_written = True
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op(
        type="read_from_array",
        inputs={"X": [array], "I": [i]},
        outputs={"Out": [out]},
    )
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference("int64",
                                                    stop_gradient=True)
    helper.append_op(
        type="lod_array_length", inputs={"X": [array]}, outputs={"Out": [out]}
    )
    return out


# ---------------------------------------------------------------------------
# Sub-block capture helpers
# ---------------------------------------------------------------------------


def _captured_names(sub_block, local_names):
    """Input names referenced by sub-block ops but not produced locally."""
    produced = set(local_names)
    captured = []
    seen = set(produced)
    for op in sub_block.ops:
        for name in op.input_arg_names():
            if name and name not in seen:
                seen.add(name)
                captured.append(name)
        for name in op.output_arg_names():
            if name:
                produced.add(name)
                seen.add(name)
    return [n for n in captured if n not in set(local_names)]


# ---------------------------------------------------------------------------
# StaticRNN — the recurrent op: a loop over the time axis
# ---------------------------------------------------------------------------


class StaticRNN(object):
    """Static (fixed-length) RNN built from a user-defined step block.

    Usage (reference-compatible, layers/control_flow.py StaticRNN):

        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)            # x: [batch, T, d]
            h_prev = rnn.memory(shape=[-1, D], batch_ref=x)
            h = layers.fc(input=[x_t, h_prev], size=D, act="tanh")
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        out = rnn()                             # [batch, T, D]
    """

    BEFORE_RNN = 0
    IN_RNN = 1
    AFTER_RNN = 2

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self.status = StaticRNN.BEFORE_RNN
        self.seq_inputs = []  # (outer, inner)
        self.memories = []  # (boot outer, pre inner, updated inner or None)
        self.step_outputs = []  # (inner, outer)
        self.sub_block = None
        self._main = self.helper.main_program

    @contextlib.contextmanager
    def step(self):
        if self.status != StaticRNN.BEFORE_RNN:
            raise ValueError("step() can only be entered once")
        self.parent_block = self._main.current_block()
        self.sub_block = self._main.create_block()
        self.status = StaticRNN.IN_RNN
        try:
            yield
        except BaseException:
            # Don't mask the user's error with a completion error.
            self._main.rollback()
            raise
        self._main.rollback()
        self.status = StaticRNN.AFTER_RNN
        self._complete_op()

    def _assert_in_rnn(self):
        if self.status != StaticRNN.IN_RNN:
            raise ValueError("must be called inside `with rnn.step():`")

    def step_input(self, x):
        self._assert_in_rnn()
        shape = None
        if x.shape is not None and len(x.shape) >= 2:
            shape = [x.shape[0]] + list(x.shape[2:])
        inner = self.sub_block.create_var(
            name=unique_name.generate("rnn_step_in"),
            dtype=x.dtype,
            shape=shape,
        )
        self.seq_inputs.append((x, inner))
        return inner

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=0):
        self._assert_in_rnn()
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError(
                    "memory() needs either init or (shape and batch_ref)"
                )
            from paddle_tpu_torch.layers import tensor as tensor_layers

            cur = self._main.current_block_idx
            self._main.current_block_idx = self.parent_block.idx
            try:
                init = tensor_layers.fill_constant_batch_size_like(
                    input=batch_ref,
                    shape=list(shape),
                    dtype=batch_ref.dtype,
                    value=init_value,
                    input_dim_idx=ref_batch_dim_idx,
                    output_dim_idx=init_batch_dim_idx,
                )
            finally:
                self._main.current_block_idx = cur
        pre = self.sub_block.create_var(
            name=unique_name.generate("rnn_mem"),
            dtype=init.dtype,
            shape=init.shape,
        )
        self.memories.append([init, pre, None])
        return pre

    def update_memory(self, mem, var):
        self._assert_in_rnn()
        for entry in self.memories:
            if entry[1] is mem or entry[1].name == getattr(mem, "name", mem):
                entry[2] = var
                return
        raise ValueError("update_memory: %s is not a memory of this RNN"
                         % mem.name)

    def step_output(self, o):
        self._assert_in_rnn()
        outer = self.parent_block.create_var(
            name=unique_name.generate("rnn_out"),
            dtype=o.dtype,
            shape=None,
        )
        self.step_outputs.append((o, outer))

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete_op(self):
        for boot, pre, updated in self.memories:
            if updated is None:
                raise ValueError(
                    "memory %s was never update_memory()'d" % pre.name
                )
        local = (
            [inner.name for _, inner in self.seq_inputs]
            + [m[1].name for m in self.memories]
        )
        params = _captured_names(self.sub_block, local)
        final_outs = [
            self.parent_block.create_var(
                name=unique_name.generate("rnn_final"),
                dtype=m[0].dtype,
                shape=None,
            )
            for m in self.memories
        ]
        self.parent_block.append_op(
            type="recurrent",
            inputs={
                "inputs": [x.name for x, _ in self.seq_inputs],
                "initial_states": [m[0].name for m in self.memories],
                "parameters": params,
            },
            outputs={
                "outputs": [outer.name for _, outer in self.step_outputs],
                "final_states": [v.name for v in final_outs],
            },
            attrs={
                "sub_block": self.sub_block.idx,
                "input_step_names": [i.name for _, i in self.seq_inputs],
                "pre_state_names": [m[1].name for m in self.memories],
                "state_names": [m[2].name for m in self.memories],
                "output_step_names": [o.name for o, _ in self.step_outputs],
                "param_names": params,
            },
        )
        self.final_states = final_outs

    def __call__(self, *args, **kwargs):
        if self.status != StaticRNN.AFTER_RNN:
            raise ValueError("RNN output requested before step block closed")
        outs = [outer for _, outer in self.step_outputs]
        return outs[0] if len(outs) == 1 else outs


# ---------------------------------------------------------------------------
# DynamicRNN — the same recurrent op, plus length masks
# ---------------------------------------------------------------------------


class DynamicRNN(object):
    """Variable-length RNN over padded [batch, T, d] + lengths.

    The reference's DynamicRNN sorts sequences with lod_rank_table and
    shrinks the batch per step (control_flow.py DynamicRNN); under static
    shapes the equivalent is a full-batch loop with a
    validity mask: memories hold their previous value past each sequence's
    end, and step outputs are zeroed there.
    """

    def __init__(self, lengths=None, name=None):
        self._rnn = StaticRNN(name=name)
        self.lengths = lengths
        self._mask = None
        self._step_idx = None

    @contextlib.contextmanager
    def block(self):
        with self._rnn.step():
            yield

    def step_input(self, x, level=0):
        inner = self._rnn.step_input(x)
        if self.lengths is not None and self._mask is None:
            from paddle_tpu_torch.layers import sequence as seq_layers

            maxlen = int(x.shape[1]) if x.shape and x.shape[1] else None
            if maxlen is None:
                raise ValueError("DynamicRNN needs a static max length")
            # [batch, T] mask computed once in the parent block, scanned.
            main = self._rnn._main
            cur = main.current_block_idx
            main.current_block_idx = self._rnn.parent_block.idx
            try:
                mask = seq_layers.sequence_mask(
                    self.lengths, maxlen=maxlen, dtype="float32"
                )
            finally:
                main.current_block_idx = cur
            self._mask = self._rnn.step_input(mask)
        return inner

    def static_input(self, x):
        # Captured automatically as a parameter of the scan.
        return x

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=0):
        return self._rnn.memory(
            init=init,
            shape=shape,
            batch_ref=batch_ref,
            init_value=init_value,
            init_batch_dim_idx=init_batch_dim_idx,
            ref_batch_dim_idx=ref_batch_dim_idx,
        )

    def update_memory(self, mem, var):
        if self._mask is not None:
            var = _masked_update(var, mem, self._mask)
        self._rnn.update_memory(mem, var)

    def output(self, *outputs):
        outs = []
        for o in outputs:
            if self._mask is not None:
                o = _masked_update(o, None, self._mask)
            outs.append(o)
        self._rnn.output(*outs)

    def __call__(self):
        return self._rnn()


def _masked_update(new, old, mask):
    """new*m + old*(1-m), broadcasting the [batch] step mask."""
    from paddle_tpu_torch.layers import nn as nn_layers

    helper = LayerHelper("masked_update")
    m = nn_layers.unsqueeze(mask, axes=[1]) if len(mask.shape or ()) == 1 \
        else mask
    kept = helper.create_variable_for_type_inference(new.dtype)
    if old is None:
        helper.append_op(
            type="elementwise_mul",
            inputs={"X": [new], "Y": [m]},
            outputs={"Out": [kept]},
            attrs={"axis": 0},
        )
        return kept
    # new*m + old*(1-m) == old + (new-old)*m
    diff = helper.create_variable_for_type_inference(new.dtype)
    helper.append_op(
        type="elementwise_sub",
        inputs={"X": [new], "Y": [old]},
        outputs={"Out": [diff]},
    )
    scaled = helper.create_variable_for_type_inference(new.dtype)
    helper.append_op(
        type="elementwise_mul",
        inputs={"X": [diff], "Y": [m]},
        outputs={"Out": [scaled]},
        attrs={"axis": 0},
    )
    out = helper.create_variable_for_type_inference(new.dtype)
    helper.append_op(
        type="elementwise_add",
        inputs={"X": [old], "Y": [scaled]},
        outputs={"Out": [out]},
    )
    return out


# ---------------------------------------------------------------------------
# While — the while op (bounded: differentiable; unbounded: forward-only)
# ---------------------------------------------------------------------------


class While(object):
    """``with While(cond).block():`` loop. Carried vars = every parent-block
    var the body writes; Condition must be a [1] bool var updated in the
    body. ``max_iterations > 0`` bounds the loop (masked steps past its
    exit), which trains through it; 0 is forward-only (decode loops).
    Reference: while_op.cc:36.
    """

    def __init__(self, cond, max_iterations=0, name=None):
        self.helper = LayerHelper("while", name=name)
        if cond.dtype not in ("bool",):
            raise TypeError("While condition must be a bool variable")
        self.cond_var = cond
        self.max_iterations = max_iterations
        self._main = self.helper.main_program

    @contextlib.contextmanager
    def block(self):
        parent_block = self._main.current_block()
        sub_block = self._main.create_block()
        try:
            yield
        except BaseException:
            self._main.rollback()
            raise
        else:
            self._main.rollback()
            # Carried vars: sub-block outputs that refer to parent vars
            # (in-place updates), plus the condition var.
            written = []
            seen = set()
            for op in sub_block.ops:
                for name in op.output_arg_names():
                    if (
                        name
                        and name not in seen
                        and parent_block._find_var_recursive(name) is not None
                    ):
                        seen.add(name)
                        written.append(name)
            if self.cond_var.name not in seen:
                raise ValueError(
                    "While body must update the condition variable %s"
                    % self.cond_var.name
                )
            carry = written
            # Fail fast on carried vars with no pre-loop value: every var
            # the body updates must be produced before the loop (tensor
            # arrays included — seed them with an array_write outside).
            for n in carry:
                v = parent_block._find_var_recursive(n)
                if v is not None and v.op is None and not v.is_data \
                        and not v.persistable:
                    raise ValueError(
                        "While carries %r but it has no value before the "
                        "loop; initialize it (fill_constant / array_write) "
                        "before entering While" % n
                    )
            params = [
                n
                for n in _captured_names(sub_block, carry)
                if n not in set(carry)
            ]
            # InitX saves the pre-loop carry values under fresh names so
            # while_grad can restart the loop (Out aliases X in-place). Each
            # is declared with its carry's recorded dtype, as the JAX
            # package copies the dtype its inference gave the carry.
            from paddle_tpu_torch import unique_name

            init_names = []
            for n in carry:
                v = parent_block._find_var_recursive(n)
                iname = unique_name.generate(n + "__while_init")
                parent_block.create_var(
                    name=iname,
                    shape=None if v is None else v.shape,
                    dtype="float32" if v is None else v.recorded_dtype,
                    stop_gradient=True,
                )
                init_names.append(iname)
            parent_block.append_op(
                type="while",
                inputs={"X": carry, "parameters": params},
                outputs={"Out": carry, "InitX": init_names},
                attrs={
                    "sub_block": sub_block.idx,
                    "carry_names": carry,
                    "param_names": params,
                    "cond_name": self.cond_var.name,
                    "max_iterations": int(self.max_iterations),
                },
            )
            # Float carries are (re)defined by the loop body, so gradients
            # must flow through them even though constant initializers
            # (fill_constant & co) mark their outputs stop_gradient —
            # otherwise a loss downstream of the loop never reaches
            # while_grad. A user's explicit stop_gradient on a non-constant
            # carry (detached EMA etc.) is respected.
            from paddle_tpu_torch.core.types import is_float_dtype

            _const_producers = {"fill_constant", "fill_zeros_like",
                                "fill_constant_batch_size_like",
                                "assign_value"}
            for n in carry:
                v = parent_block._find_var_recursive(n)
                if (
                    v is not None
                    and is_float_dtype(v.dtype)
                    and v.op is not None
                    and v.op.type in _const_producers
                ):
                    v.stop_gradient = False


# ---------------------------------------------------------------------------
# cond / IfElse / Switch — the cond op
# ---------------------------------------------------------------------------


def cond(pred, true_fn, false_fn):
    """Functional two-branch conditional: ``out = cond(p, f, g)``.

    Both branches are traced into sub-blocks and must return the same
    number of variables with matching shapes/dtypes.
    """
    helper = LayerHelper("cond")
    main = helper.main_program
    parent_block = main.current_block()

    def trace(fn):
        sub = main.create_block()
        try:
            res = fn()
        finally:
            main.rollback()
        if res is None:
            res = []
        if not isinstance(res, (list, tuple)):
            res = [res]
        return sub, list(res)

    sub_t, outs_t = trace(true_fn)
    sub_f, outs_f = trace(false_fn)
    if len(outs_t) != len(outs_f):
        raise ValueError(
            "true_fn returned %d outputs, false_fn %d"
            % (len(outs_t), len(outs_f))
        )
    # Capture sub-block reads AND branch outputs that resolve in the parent
    # block (a branch may pass a parent var through untouched).
    passthrough = [
        v.name
        for v in outs_t + outs_f
        if parent_block._find_var_recursive(v.name) is not None
    ]
    inputs = sorted(
        set(_captured_names(sub_t, []))
        | set(_captured_names(sub_f, []))
        | set(passthrough)
    )
    outs = [
        helper.create_variable_for_type_inference(v.dtype) for v in outs_t
    ]
    parent_block.append_op(
        type="cond",
        inputs={"Cond": [pred.name], "X": inputs},
        outputs={"Out": [o.name for o in outs]},
        attrs={
            "true_block": sub_t.idx,
            "false_block": sub_f.idx,
            "input_names": inputs,
            "true_out_names": [v.name for v in outs_t],
            "false_out_names": [v.name for v in outs_f],
        },
    )
    return outs[0] if len(outs) == 1 else outs


class Switch(object):
    """``with switch.case(cond): ... with switch.default(): ...``

    Reference: layers/control_flow.py Switch (chained conditional_blocks).
    Here each case body must assign to the same output vars via
    layers.assign; cases become a chain of cond ops.
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.cases = []  # (cond_var or None, sub_block)
        self._main = self.helper.main_program
        self.parent_block = self._main.current_block()

    @contextlib.contextmanager
    def case(self, condition):
        sub = self._main.create_block()
        try:
            yield
        finally:
            self._main.rollback()
        self.cases.append((condition, sub))

    @contextlib.contextmanager
    def default(self):
        sub = self._main.create_block()
        try:
            yield
        finally:
            self._main.rollback()
        self.cases.append((None, sub))
        self._complete()

    def _complete(self):
        # Outputs: union of names written by any case that exist in parent.
        out_names = []
        seen = set()
        for _, sub in self.cases:
            for op in sub.ops:
                for n in op.output_arg_names():
                    if (
                        n
                        and n not in seen
                        and self.parent_block._find_var_recursive(n)
                        is not None
                    ):
                        seen.add(n)
                        out_names.append(n)
        default = None
        conds = []
        for c, sub in self.cases:
            if c is None:
                default = sub
            else:
                conds.append((c, sub))
        if default is None:
            raise ValueError("Switch requires a default() case")
        # Build nested conds from the last case inward.
        inputs = sorted(
            set(
                n
                for _, sub in self.cases
                for n in _captured_names(sub, [])
            )
            | set(out_names)
        )

        # Chain of cond ops in the parent block: default first, then each
        # case from last to first, so the FIRST matching case wins. The
        # default link uses a constant-true predicate.
        current_names = list(out_names)  # fall-through = pre-switch values
        chain = [(None, default)] + list(reversed(conds))
        for c, sub in chain:
            if c is None:
                from paddle_tpu_torch.layers import tensor as tensor_layers

                c = tensor_layers.fill_constant([1], "bool", True)
            new_outs = [
                self.parent_block.create_var(
                    name=unique_name.generate("switch_out"),
                    dtype=self.parent_block._find_var_recursive(n).dtype,
                    shape=None,
                )
                for n in out_names
            ]
            # false branch: identity sub-block (pass-through of current).
            ident = self._main.create_block()
            self._main.rollback()
            self.parent_block.append_op(
                type="cond",
                inputs={"Cond": [c.name], "X": inputs},
                outputs={"Out": [v.name for v in new_outs]},
                attrs={
                    "true_block": sub.idx,
                    "false_block": ident.idx,
                    "input_names": inputs,
                    "true_out_names": out_names,
                    "false_out_names": current_names,
                },
            )
            current_names = [v.name for v in new_outs]
            inputs = sorted(set(inputs) | set(current_names))
        # Bind results back to the original names via assign.
        from paddle_tpu_torch.layers import tensor as tensor_layers

        for orig, cur in zip(out_names, current_names):
            tensor_layers.assign(
                self.parent_block._find_var_recursive(cur),
                self.parent_block._find_var_recursive(orig),
            )


class IfElse(object):
    """Reference layers/control_flow.py IfElse. Batch-element conditional:
    true_block/false_block each transform the full batch; outputs are
    merged elementwise by the [batch, 1] bool condition (select), which is
    the dense equivalent of the reference's split/merge ops."""

    OUT_IF_ELSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self._main = self.helper.main_program
        self.parent_block = self._main.current_block()
        self._true_outs = None
        self._false_outs = None
        self._in_true = False
        self._inputs = []

    @contextlib.contextmanager
    def true_block(self):
        self._in_true = True
        yield
        self._in_true = False

    @contextlib.contextmanager
    def false_block(self):
        self._in_true = False
        yield

    def input(self, x):
        return x

    def output(self, *outs):
        if self._in_true:
            self._true_outs = list(outs)
        else:
            self._false_outs = list(outs)

    def __call__(self):
        if self._true_outs is None or self._false_outs is None:
            raise ValueError("both branches must call output()")
        merged = []
        for t, f in zip(self._true_outs, self._false_outs):
            out = self.helper.create_variable_for_type_inference(t.dtype)
            self.helper.append_op(
                type="where_select",
                inputs={"Cond": [self.cond], "X": [t], "Y": [f]},
                outputs={"Out": [out]},
            )
            merged.append(out)
        return merged


class RankTable(object):
    """A lod_rank_table's result: ``index`` (the batch order, by
    descending length, ties stable) and ``length`` (the sorted lengths),
    int64 Variables computed at run time."""

    def __init__(self, index, length):
        self.index = index
        self.length = length


def lod_rank_table(x=None, level=0, lengths=None):
    """Rank sequences by descending length (control_flow.py:819). The
    padded layout carries lengths as a tensor: pass ``lengths`` ([batch]
    or [batch, 1] int); ``x`` and ``level`` (which must be 0) are kept
    for the reference's signature."""
    if lengths is None:
        raise ValueError(
            "lod_rank_table needs lengths= (the dense-padded design "
            "carries sequence lengths as an explicit tensor; see "
            "docs/LOD_DESIGN.md)")
    if level != 0:
        raise ValueError("only level=0 is supported on device")
    helper = LayerHelper("lod_rank_table")
    index = helper.create_variable_for_type_inference("int64")
    sorted_len = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="lod_rank_table",
        inputs={"Length": [lengths]},
        outputs={"Index": [index], "SortedLength": [sorted_len]})
    return RankTable(index, sorted_len)


def lod_tensor_to_array(x, table):
    """Move a dense-padded [B, T, ...] tensor into a tensor array whose
    time axis is the array index (lod_tensor_to_array_op.cc role; the
    reference splits ragged rows per rank-table bucket, the dense design
    re-axes the padded tensor — docs/LOD_DESIGN.md)."""
    from paddle_tpu_torch.core.types import VarType

    helper = LayerHelper("lod_tensor_to_array")
    array = helper.block.create_var(
        name=unique_name.generate("lod_tensor_to_array"),
        type=VarType.LOD_TENSOR_ARRAY,
        dtype=x.dtype,
        shape=None,
    )
    helper.append_op(
        type="lod_tensor_to_array",
        inputs={"X": [x], "RankTable": [table.index]},
        outputs={"Out": [array]},
    )
    array._array_written = True
    return array


def array_to_lod_tensor(x, table):
    """Inverse of lod_tensor_to_array: stack the array back into a dense
    batch-major [B, T, ...] tensor (array_to_lod_tensor_op.cc role)."""
    helper = LayerHelper("array_to_lod_tensor")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="array_to_lod_tensor",
        inputs={"X": [x], "RankTable": [table.index]},
        outputs={"Out": [out]},
    )
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    """``x``'s batch dimension in the rank table's order
    (control_flow.py:882); the gradient scatters back through the
    permutation."""
    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="reorder_lod_tensor_by_rank",
        inputs={"X": [x], "RankIndex": [rank_table.index]},
        outputs={"Out": [out]})
    return out
