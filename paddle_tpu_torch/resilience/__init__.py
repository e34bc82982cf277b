"""Resilience for the serving plane (counterpart of
``paddle_tpu/resilience/``).

* ``retry`` — classified retry policy (``FLAGS_dispatch_retries``):
  transient IO/RPC faults backed off and retried, user and verifier
  errors never; every retry counted (``paddle_tpu_retries_total``).
* ``chaos`` — seeded, deterministic fault injection
  (``FLAGS_chaos_spec``) at the serving and wire sites.

The checkpoint manager and the training session come with a later slice
(ROADMAP.md A8's second half).
"""

from paddle_tpu_torch.resilience import chaos  # noqa: F401
from paddle_tpu_torch.resilience import retry  # noqa: F401
