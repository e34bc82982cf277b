"""Observability for the serving plane (counterpart of
``paddle_tpu/observability/``).

* ``metrics_registry`` — counters, gauges, histograms; Prometheus text.
* ``lock_witness`` — named locks and their acquisition-order graph.
* ``blackbox`` — the flight-event ring dumped on a failure.
* ``tracing`` — one trace per serving request.
* ``watchdog`` — declares a stall of armed blocking work.
* ``telemetry`` — the executors' step-time window.
* ``memory`` — out-of-memory classification.

Not ported yet (ROADMAP.md A9): the recompile explainer, the step
profiler, NaN provenance, the memory ledger, and telemetry's device
memory and FLOP accounting.
"""

from paddle_tpu_torch.observability import blackbox  # noqa: F401
from paddle_tpu_torch.observability import memory  # noqa: F401
from paddle_tpu_torch.observability import metrics_registry  # noqa: F401
from paddle_tpu_torch.observability import telemetry  # noqa: F401
from paddle_tpu_torch.observability import tracing  # noqa: F401
from paddle_tpu_torch.observability import watchdog  # noqa: F401
from paddle_tpu_torch.observability.metrics_registry import REGISTRY  # noqa: F401
