"""Testing utilities: deterministic parameters and fresh port state.

``set_deterministic_params`` is a copy of ``paddle_tpu/testing.py``'s:
every float persistable is overwritten with numpy values seeded by the
variable's NAME, so the two packages (which mint identical names) hold
bit-identical weights, and the committed goldens in ``tests/golden/``
apply to the port too. ``fresh_state`` gives a test fresh default
programs, name counters and global scope of this package (the JAX
package's conftest resets only its own).
"""

import contextlib
import hashlib

import numpy as np
import torch

from paddle_tpu_torch.framework import Parameter


def _seed_of(name):
    return int.from_bytes(
        hashlib.md5(name.encode("utf-8")).digest()[:4], "little")


def set_deterministic_params(program, scope, scale=0.1,
                             parameters_only=False):
    """Overwrite every float persistable of ``program`` that ``scope``
    holds with seeded numpy values, on the device it already lives on.
    ``parameters_only`` leaves every other persistable (an optimizer's
    accumulators and learning rate) as the startup program set it."""
    for var in program.global_block().vars.values():
        if not getattr(var, "persistable", False):
            continue
        if parameters_only and not isinstance(var, Parameter):
            continue
        cur = scope.get_value(var.name)
        if cur is None:
            continue
        if not isinstance(cur, torch.Tensor):
            cur = torch.from_numpy(np.asarray(cur))
        if not cur.dtype.is_floating_point:
            continue
        rng = np.random.RandomState(_seed_of(var.name))
        lname = var.name.lower()
        # batch_norm running stats: variances stay positive
        if "variance" in lname or ".var_" in lname or \
                lname.endswith("_var") or lname.endswith(".var"):
            val = 0.5 + rng.rand(*cur.shape)
        elif "mean" in lname:
            val = 0.05 * rng.randn(*cur.shape)
        else:
            val = scale * rng.randn(*cur.shape)
        scope.set_value(var.name, torch.from_numpy(val).to(
            dtype=cur.dtype, device=cur.device))


@contextlib.contextmanager
def fresh_state():
    """Fresh default main/startup programs, ``unique_name`` counters and
    global scope for this package, restored on exit."""
    from paddle_tpu_torch import executor, framework, unique_name
    from paddle_tpu_torch.core.scope import Scope

    prev_main = framework.switch_main_program(framework.Program())
    prev_startup = framework.switch_startup_program(framework.Program())
    prev_names = unique_name.switch({})
    prev_stack = executor._scope_stack[:]
    executor._scope_stack[:] = [Scope()]
    try:
        yield
    finally:
        framework.switch_main_program(prev_main)
        framework.switch_startup_program(prev_startup)
        unique_name.switch(prev_names)
        executor._scope_stack[:] = prev_stack
