"""Block interpreter: runs a block's ops eagerly on torch tensors.

Counterpart of ``paddle_tpu/core/lowering.py``. Where the JAX package
traces a whole block into one XLA computation, the port applies each op's
lowering in program order to a name -> tensor environment, and PyTorch
dispatches every tensor op as it comes (``executor.cc:392-404``
RunPreparedContext is the reference's own per-op loop).
"""

import torch

from paddle_tpu_torch.core import op_registry
from paddle_tpu_torch.core.op_registry import LowerContext, normalize_outputs


def _valid(names):
    return [n for n in names if n]


class BlockLowerer(object):
    """Runs the ops of one block over a name -> tensor environment."""

    def __init__(self, program, block_idx=0, is_test=False):
        self.program = program
        self.block = program.block(block_idx)
        self.is_test = is_test
        # the op being lowered (a failed CUDA graph capture names it) and
        # the types of the ops that asked for a random generator (a
        # program with any is never captured: its seeds would be baked in)
        self.current_op = None
        self.rng_ops = set()

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

    def lower_into(self, env, device, seed, release):
        """Run every op's lowering against env (name -> tensor), dropping
        each variable after its last use (``release``, a
        :meth:`release_plan`)."""
        for op, names in zip(self.block.ops, release):
            self.lower_op(op, env, device, seed)
            for name in names:
                env.pop(name, None)
        return env

    def lower_op(self, op, env, device, seed):
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
        make_rng = _make_rng(seed, op.attrs, device)

        def rng():
            self.rng_ops.add(op.type)
            return make_rng()

        ctx = LowerContext(
            op,
            rng=rng,
            is_test=self.is_test or op.attrs.get("is_test", False),
            block_lowerer=self,
            device=device,
        )
        outs = normalize_outputs(opdef, opdef.lower(ctx, ins, op.attrs))
        for slot, vals in outs.items():
            for name, val in zip(op.output(slot), vals):
                if name and val is not None:
                    env[name] = val


def _make_rng(seed, attrs, device):
    """Per-op generator factory: the op's own nonzero ``seed`` attr pins
    its stream (fix_seed semantics); otherwise the stream derives from the
    run's seed and the op's ``__rng_id__``."""
    rng_id = int(attrs.get("__rng_id__", 0))
    fixed = int(attrs.get("seed", 0) or 0)

    def rng():
        g = torch.Generator(device=device)
        if fixed:
            g.manual_seed((fixed * 1000003 + rng_id) % (2 ** 63))
        else:
            g.manual_seed((int(seed) * 1000003 + rng_id) % (2 ** 63))
        return g

    return rng
