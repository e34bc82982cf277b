"""Block interpreter: runs a block's ops eagerly on torch tensors.

Counterpart of ``paddle_tpu/core/lowering.py``. Where the JAX package
traces a whole block into one XLA computation, the port applies each op's
lowering in program order to a name -> tensor environment, and PyTorch
dispatches every tensor op as it comes (``executor.cc:392-404``
RunPreparedContext is the reference's own per-op loop).

The forward tape: where the block holds an op and its ``<type>_grad``
(``grad_pairs``), the op's lowering runs once under autograd and its
graph waits on the run's tape for the grad op, which differentiates it
(``op_registry.record_forward`` / ``grad_from_tape``) instead of
rerunning the forward. The tape lives for one pass over the block and is
dropped at its end, errors included. The environment only ever holds
detached tensors, so later ops never extend a recorded graph.
"""

from paddle_tpu_torch.core import op_registry, prng
from paddle_tpu_torch.core.op_registry import LowerContext, normalize_outputs


def _valid(names):
    return [n for n in names if n]


class BlockLowerer(object):
    """Runs the ops of one block over a name -> tensor environment."""

    def __init__(self, program, block_idx=0, is_test=False):
        self.program = program
        self.block = program.block(block_idx)
        self.is_test = is_test
        # the op being lowered (a failed CUDA graph capture names it)
        self.current_op = None
        # grad ops that reran their forward (no tape entry, or one whose
        # inputs changed since the forward); the executor collects it
        self.grad_reruns = 0

    def analyze(self, scope_names, feed_names):
        """Classify variable usage for a run.

        Returns (state_in, state_out):
          state_in: persistable vars the block reads that must come from
            the scope;
          state_out: persistable vars the block writes (written back to
            the scope after the run).
        """
        defined = set(feed_names)
        state_in, state_out = [], []
        seen_in, seen_out = set(), set()
        for op in self.block.ops:
            for name in _valid(op.input_arg_names()):
                if name in defined or name in seen_in:
                    continue
                v = self.block._find_var_recursive(name)
                if v is not None and v.persistable and name in scope_names:
                    seen_in.add(name)
                    state_in.append(name)
            for name in _valid(op.output_arg_names()):
                defined.add(name)
                v = self.block._find_var_recursive(name)
                if v is not None and v.persistable and name not in seen_out:
                    seen_out.add(name)
                    state_out.append(name)
        return state_in, state_out

    def release_plan(self, keep):
        """For each op, the variable names no later op reads or writes and
        ``keep`` does not hold: the environment drops them right after
        that op, so a train step holds an intermediate only while it is
        needed (what XLA's buffer liveness does for the JAX package)."""
        last = {}
        for i, op in enumerate(self.block.ops):
            for name in _valid(op.input_arg_names() + op.output_arg_names()):
                last[name] = i
        plan = [[] for _ in self.block.ops]
        for name, i in last.items():
            if name not in keep:
                plan[i].append(name)
        return plan

    def grad_pairs(self):
        """{forward op index: grad op index}: each ``<type>_grad`` op with
        the nearest earlier unpaired op of ``type`` whose input slots name
        the variables of the grad op's same-named inputs, and whose output
        slots do too (what backward.py builds the grad op from)."""
        ops = self.block.ops
        pairs = {}
        for j, gop in enumerate(ops):
            if not gop.type.endswith("_grad"):
                continue
            ftype = gop.type[:-len("_grad")]
            if not op_registry.has_op(ftype):
                continue
            fdef = op_registry.get_op_def(ftype)
            for i in range(j - 1, -1, -1):
                op = ops[i]
                if (op.type == ftype and i not in pairs
                        and all(op.input(s) == gop.input(s)
                                for s in fdef.input_slots())
                        and all(op.output(s) == gop.input(s)
                                for s in fdef.output_slots())):
                    pairs[i] = j
                    break
        return pairs

    def lower_into(self, env, device, step_key, release, pairs=None):
        """Run every op's lowering against env (name -> tensor), dropping
        each variable after its last use (``release``, a
        :meth:`release_plan`). ``step_key`` (a ``prng.KeyChain``) is the
        run's (or the loop step's) key. ``pairs`` (:meth:`grad_pairs`)
        turns the forward tape on."""
        tape = {}
        try:
            for i, (op, names) in enumerate(zip(self.block.ops, release)):
                self.lower_op(op, env, device, step_key, pairs, tape, i)
                for name in names:
                    env.pop(name, None)
        finally:
            # an exception's traceback keeps this frame alive, and with
            # it every recorded graph: drop them here
            tape.clear()
        return env

    def lower_op(self, op, env, device, step_key, pairs=None, tape=None,
                 index=None):
        opdef = op_registry.get_op_def(op.type)
        ins = {}
        for slot in opdef.input_slots():
            names = op.input(slot)
            if names:
                try:
                    ins[slot] = [env[n] for n in _valid(names)]
                except KeyError as e:
                    raise RuntimeError(
                        "op %s reads uninitialized variable %s "
                        "(not fed, not persistable-in-scope, not produced "
                        "earlier in the block)" % (op.type, e))
        self.current_op = op
        ctx = LowerContext(
            op,
            rng=_make_rng(step_key, op.attrs),
            is_test=self.is_test or op.attrs.get("is_test", False),
            block_lowerer=self,
            device=device,
        )
        grad_index = pairs.get(index) if pairs else None
        entry = None
        if grad_index is not None and not ctx.is_test:
            outs, entry = op_registry.record_forward(
                opdef, ctx, ins, op.attrs, op_registry.wanted_grads(
                    self.block.ops[grad_index], opdef))
        else:
            if tape:
                ctx.tape_entry = tape.pop(index, None)
            outs = normalize_outputs(opdef, opdef.lower(ctx, ins, op.attrs))
        for slot, vals in outs.items():
            for name, val in zip(op.output(slot), vals):
                if name and val is not None:
                    env[name] = val
        if entry is not None:
            entry.snapshot([env[n] for s in opdef.input_slots()
                            for n in _valid(op.input(s))])
            tape[grad_index] = entry


def _make_rng(step_key, attrs):
    """An op's key, as the JAX package derives it
    (``paddle_tpu/core/lowering.py`` ``_make_rng``): the op's own
    nonzero ``seed`` attr pins its stream (fix_seed semantics,
    ``fold_in(PRNGKey(seed), __rng_id__)``, the same every step);
    otherwise ``fold_in(step_key, __rng_id__)``. A ``prng.KeyChain``:
    nothing is computed until an op draws."""
    rng_id = int(attrs.get("__rng_id__", 0))
    seed = int(attrs.get("seed", 0) or 0)

    def rng():
        if seed:
            return prng.KeyChain(prng.PRNGKey_pair(seed)).fold_in(rng_id)
        return step_key.fold_in(rng_id)

    return rng
