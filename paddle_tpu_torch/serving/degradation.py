"""Graceful overload degradation: healthy -> brownout -> shed.

Counterpart of ``paddle_tpu/serving/degradation.py`` (a copy). Under
overload a serving process serves normally (healthy), serves the cheap
version (brownout: the decode session evicts its prefix cache and
refuses best-of-N forks) or stops admitting while in-flight work drains
(shed). Every refused caller gets a typed, retriable
:class:`DegradedError` carrying a retry-after hint.

:class:`HealthMonitor` is the state machine: the caller feeds it a load
fraction (queue depth / max depth for ``BatchingServer``; reserved pages
/ capacity and live slots / slots for ``SlotDecodeSession``) at every
admission and completion; it applies hysteresis and records every
transition (``paddle_tpu_serving_health`` gauge,
``paddle_tpu_serving_health_transitions_total{component,from,to}``).
"""

from paddle_tpu_torch.observability.metrics_registry import REGISTRY as _REGISTRY
from paddle_tpu_torch.resilience.retry import TransientError
from paddle_tpu_torch.serving.server import ServingError

__all__ = ["HealthMonitor", "DegradedError",
           "HEALTHY", "BROWNOUT", "SHED"]

HEALTHY, BROWNOUT, SHED = "healthy", "brownout", "shed"
_LEVEL = {HEALTHY: 0, BROWNOUT: 1, SHED: 2}

_health_gauge = _REGISTRY.gauge(
    "paddle_tpu_serving_health",
    "serving degradation state per component "
    "(0 healthy, 1 brownout, 2 shed)",
    labels=("component",))
_transitions = _REGISTRY.counter(
    "paddle_tpu_serving_health_transitions_total",
    "degradation state-machine transitions by component",
    labels=("component", "from", "to"))


class DegradedError(ServingError, TransientError):
    """A degraded component refused this admission (brownout refusing a
    fork, shed refusing everything). RETRIABLE by type — it subclasses
    ``resilience.retry.TransientError``, so classified retry loops back
    off and re-ask instead of surfacing a hard failure — and carries
    ``retry_after_s`` (the server's own drain estimate) plus the
    ``state`` that refused. The request was NOT partially admitted:
    degradation rejects happen before any slot/page/queue mutation."""

    def __init__(self, message, state=BROWNOUT, retry_after_s=0.05):
        super(DegradedError, self).__init__(message)
        self.state = state
        self.retry_after_s = float(retry_after_s)


class HealthMonitor(object):
    """Hysteresis state machine over a 0..1 load fraction.

    ``observe(load)`` moves the state and returns it: load >=
    ``shed_at`` -> shed, >= ``brownout_at`` -> at least brownout, and a
    degraded state recovers one level only when load falls below
    ``recover_at`` (shed relaxes to brownout, then to healthy — never
    straight down, so a drain burst can't skip the cheap-serving
    phase). ``on_transition(frm, to)`` fires AFTER the books (gauge,
    counter, flight event) land — the hook the decode session uses to
    evict its prefix cache on entering brownout.
    """

    def __init__(self, component, brownout_at=0.75, shed_at=0.95,
                 recover_at=0.5, retry_after_s=0.05, on_transition=None):
        if not (0.0 <= recover_at <= brownout_at <= shed_at):
            raise ValueError(
                "HealthMonitor needs recover_at <= brownout_at <= "
                "shed_at, got %r <= %r <= %r"
                % (recover_at, brownout_at, shed_at))
        self.component = str(component)
        self.brownout_at = float(brownout_at)
        self.shed_at = float(shed_at)
        self.recover_at = float(recover_at)
        self.retry_after_s = float(retry_after_s)
        self.on_transition = on_transition
        self.state = HEALTHY
        self.transitions = 0
        _health_gauge.set(0, component=self.component)

    def observe(self, load):
        load = float(load)
        prev = self.state
        if load >= self.shed_at:
            nxt = SHED
        elif load >= self.brownout_at:
            nxt = BROWNOUT if prev != SHED else SHED
        elif load < self.recover_at:
            # recover one level per crossing, never two at once
            nxt = (BROWNOUT if prev == SHED
                   else HEALTHY)
        else:
            nxt = prev  # the hysteresis band: hold
        if nxt != prev:
            self.state = nxt
            self.transitions += 1
            _health_gauge.set(_LEVEL[nxt], component=self.component)
            _transitions.inc(**{"component": self.component,
                                "from": prev, "to": nxt})
            from paddle_tpu_torch.observability import blackbox

            if blackbox.ENABLED:
                blackbox.record(
                    "serving_health_transition",
                    component=self.component, frm=prev, to=nxt,
                    load=round(load, 4))
            if self.on_transition is not None:
                self.on_transition(prev, nxt)
        return self.state

    def reject(self, what):
        """The typed refuse for the CURRENT state (callers raise it)."""
        return DegradedError(
            "%s %s: %s refused; retry after %.3fs"
            % (self.component, self.state, what, self.retry_after_s),
            state=self.state, retry_after_s=self.retry_after_s)
