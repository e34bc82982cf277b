"""Graph-level reverse-mode autodiff: append gradient OPS to the program.

Counterpart of ``paddle_tpu/backward.py`` (python/paddle/fluid/
backward.py:469 append_backward, :685 calc_gradient, :135
_addup_repetitive_outputs_ parity). Gradients are real operators appended
to the block, role-tagged Backward, with the reference's names: ``x@GRAD``
for a variable's gradient, ``x@GRAD@RENAME_n`` for its n-th extra
contribution, summed by a ``sum`` op. Each grad op is the synthesized
``<type>_grad`` of ``core/op_registry.ensure_auto_grad_op``, whose
lowering differentiates the forward lowering. The JAX package's
hand-written grad-desc makers (``grad=callable``) belong to ops this port
does not carry yet.
"""

from paddle_tpu_torch import framework
from paddle_tpu_torch.core import op_registry
from paddle_tpu_torch.framework import (
    OpRole,
    Parameter,
    Variable,
    grad_var_name,
)


def _collect_no_grad(block, no_grad_set):
    s = {v.name if isinstance(v, Variable) else v for v in no_grad_set or ()}
    for v in block.vars.values():
        if v.stop_gradient:
            s.add(v.name)
    return s


class _GradAccumulator(object):
    """Tracks per-var gradient contributions; sums duplicates
    (_addup_repetitive_outputs_ parity)."""

    def __init__(self, block):
        self.block = block
        self.contribs = {}  # fwd var name -> [grad var names]

    def add(self, var_name, grad_name):
        self.contribs.setdefault(var_name, []).append(grad_name)

    def alloc_name(self, var_name, reserved):
        """A distinct grad name per contribution. ``reserved`` counts the
        names given out within the current op, so a var feeding two input
        slots (self-attention's matmul(x, x)) gets two names that
        finalize() sums, instead of one name written twice."""
        n = len(self.contribs.get(var_name, [])) + reserved.get(var_name, 0)
        reserved[var_name] = reserved.get(var_name, 0) + 1
        if n == 0:
            return grad_var_name(var_name)
        return "%s@RENAME_%d" % (grad_var_name(var_name), n)

    def finalize(self, var_name):
        """The (possibly summed) grad var name for var_name, or None."""
        names = self.contribs.get(var_name)
        if not names:
            return None
        if len(names) == 1:
            return names[0]
        total = grad_var_name(var_name)
        self._make_grad_var(total, self.block._find_var_recursive(var_name))
        self.block.append_op(
            type="sum",
            inputs={"X": list(names)},
            outputs={"Out": [total]},
            attrs={framework.OP_ROLE_ATTR_NAME: OpRole.Backward},
        )
        self.contribs[var_name] = [total]
        return total

    def _make_grad_var(self, grad_name, fwd_var):
        if not self.block.has_var(grad_name):
            self.block.create_var(
                name=grad_name,
                shape=None if fwd_var is None else fwd_var.shape,
                dtype="float32" if fwd_var is None else fwd_var.dtype,
                stop_gradient=True,
            )


def _append_grad_ops_for(block, op, acc, no_grad):
    """Append the grad op for one forward op; record contributions."""
    opdef = op_registry.get_op_def(op.type)
    if opdef.grad is None:
        return
    if callable(opdef.grad):
        raise NotImplementedError(
            "op %r has a hand-written grad maker; paddle_tpu_torch "
            "synthesizes every grad op (grad='auto')" % op.type)

    out_grads = {}
    any_grad = False
    for slot in opdef.output_slots():
        gs = []
        for name in op.output(slot):
            g = acc.finalize(name) if name else None
            gs.append(g)
            any_grad = any_grad or g is not None
        out_grads[slot] = gs
    if not any_grad:
        return

    wanted = {}
    reserved = {}
    for slot in opdef.input_slots():
        if slot in opdef.no_grad_inputs:
            continue
        names = []
        for name in op.input(slot):
            v = block._find_var_recursive(name) if name else None
            skip = (not name or name in no_grad or v is None
                    or v.stop_gradient
                    or (isinstance(v, Parameter) and not v.trainable))
            names.append("" if skip else acc.alloc_name(name, reserved))
        if any(names):
            wanted[slot] = names
    if not wanted:
        return

    op_registry.ensure_auto_grad_op(op.type)
    g_inputs = {}
    for slot in opdef.input_slots():
        if op.input(slot):
            g_inputs[slot] = list(op.input(slot))
    for slot in opdef.output_slots():
        if op.output(slot):
            g_inputs[slot] = list(op.output(slot))
        gs = out_grads.get(slot, [])
        if any(g is not None for g in gs):
            g_inputs[slot + "@GRAD"] = [g or "" for g in gs]
    g_outputs = {s + "@GRAD": names for s, names in wanted.items()}
    # the forward's attrs, __rng_id__ included: dropout_grad replays the
    # forward's mask
    attrs = dict(op.attrs)
    attrs[framework.OP_ROLE_ATTR_NAME] = OpRole.Backward

    # grad vars before the op (shape mirrors the forward var): build-time
    # shape inference of a grad op may fail (a kernel on meta tensors),
    # and these shapes stand then
    for names in g_outputs.values():
        for gname in names:
            if gname:
                fwd_var = block._find_var_recursive(gname.split("@GRAD")[0])
                acc._make_grad_var(gname, fwd_var)
    block.append_op(type=op.type + "_grad", inputs=g_inputs,
                    outputs=g_outputs, attrs=attrs)

    for slot, names in wanted.items():
        for name, gname in zip(op.input(slot), names):
            if gname:
                acc.add(name, gname)


def _backward_pass(block, target_vars, target_grads, no_grad_set):
    """Shared reverse walk from the last op producing a target; returns
    the accumulator."""
    no_grad = _collect_no_grad(block, no_grad_set)
    acc = _GradAccumulator(block)
    for v, g in zip(target_vars, target_grads):
        acc.add(v.name, g)

    fwd_ops = list(block.ops)
    target_names = {v.name for v in target_vars}
    last = len(fwd_ops) - 1
    for i in range(len(fwd_ops) - 1, -1, -1):
        if target_names & set(fwd_ops[i].output_arg_names()):
            last = i
            break
    for op in reversed(fwd_ops[: last + 1]):
        _append_grad_ops_for(block, op, acc, no_grad)
    return acc


def _fill_ones(block, name, like, role):
    block.create_var(name=name, shape=like.shape or (1,), dtype=like.dtype,
                     stop_gradient=True)
    block.append_op(
        type="fill_constant",
        outputs={"Out": [name]},
        attrs={"shape": list(like.shape or (1,)), "dtype": like.dtype,
               "value": 1.0, framework.OP_ROLE_ATTR_NAME: role},
    )


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Append backward ops computing d(loss)/d(param) for every trainable
    parameter; returns [(param, grad_var)] (backward.py:469 parity)."""
    assert isinstance(loss, Variable)
    block = loss.block.program.global_block()

    loss_grad = grad_var_name(loss.name)
    _fill_ones(block, loss_grad, loss, OpRole.Backward | OpRole.Loss)
    acc = _backward_pass(block, [loss], [loss_grad], no_grad_set)

    if parameter_list is not None:
        params = [block.var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [p for p in block.all_parameters() if p.trainable]

    params_and_grads = []
    for p in params:
        gname = acc.finalize(p.name)
        if gname is None:
            continue
        gvar = block._find_var_recursive(gname)
        if gvar is not None and gvar.shape is None:
            gvar.shape = p.shape
            gvar.dtype = p.dtype
        params_and_grads.append((p, gvar))
    return params_and_grads


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradients of targets w.r.t. inputs (backward.py:685 parity)."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    block = targets[0].block

    grad_names = []
    if target_gradients is None:
        target_gradients = [None] * len(targets)
    for t, tg in zip(targets, target_gradients):
        if tg is None:
            gname = grad_var_name(t.name)
            _fill_ones(block, gname, t, OpRole.Backward)
            grad_names.append(gname)
        else:
            grad_names.append(tg.name)

    acc = _backward_pass(block, list(targets), grad_names, no_grad_set)
    result = []
    for inp in inputs:
        gname = acc.finalize(inp.name)
        result.append(None if gname is None
                      else block._find_var_recursive(gname))
    return result
