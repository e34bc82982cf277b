"""Resilience (counterpart of ``paddle_tpu/resilience/``).

* ``checkpoint`` — :class:`CheckpointManager`: atomic (temp dir +
  fsynced manifest + rename), digest-verified, asynchronously written
  checkpoints of the scope and the executor's RNG state; on load,
  corrupt serials are quarantined and the scan falls back to the newest
  complete one. The JAX package's files: either package restores the
  other's checkpoints.
* ``retry`` — classified retry policy (``FLAGS_dispatch_retries``):
  transient IO/RPC faults backed off and retried, user and verifier
  errors never; every retry counted (``paddle_tpu_retries_total``).
* ``chaos`` — seeded, deterministic fault injection
  (``FLAGS_chaos_spec``) at the serving, wire, checkpoint and snapshot
  sites.

The training session comes with a later slice (ROADMAP.md A item 6).
"""

from paddle_tpu_torch.resilience import chaos  # noqa: F401
from paddle_tpu_torch.resilience import checkpoint  # noqa: F401
from paddle_tpu_torch.resilience import retry  # noqa: F401
from paddle_tpu_torch.resilience.checkpoint import CheckpointManager  # noqa: F401
