"""Process-global metrics registry: counters, gauges, histograms.

Counterpart of ``paddle_tpu/observability/metrics_registry.py`` (a copy:
the same metric types, bucket ladders, exemplars and Prometheus text
0.0.4 export, so one scrape reads alike from either package). Every
serving module registers its series here; the frontend's ``metrics``
endpoint returns ``REGISTRY.to_prometheus()``.

* Thread-safe: one registry lock guards metric creation; each metric
  guards its own label->value map.
* Labels are plain keyword dicts; a metric's label NAMES are fixed at
  registration (Prometheus contract), values vary per observation.
* Histograms use fixed upper bounds chosen at registration, so
  ``observe`` is O(len(buckets)) with no allocation.
* Collectors: ``register_collector(fn)`` adds a scrape-time callback
  yielding ``(name, type, help, [(labels, value)])`` tuples.
"""

import json
import os
import threading
import time

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "DEFAULT_BUCKETS", "SERVING_BUCKETS", "DECODE_BUCKETS",
]

# Latency-ish default buckets (seconds): 100us .. 60s, roughly x3 steps.
DEFAULT_BUCKETS = (
    0.0001, 0.0003, 0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0,
    30.0, 60.0,
)

# Request-SLO buckets (seconds) for the serving layer: finer in the
# 0.5ms-250ms band where inference p99s live, so a histogram scrape can
# localize an SLO breach the coarse DEFAULT_BUCKETS would smear.
SERVING_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)

# Decode-resolution buckets (seconds): the streaming plane's numbers —
# inter-token gaps and per-dispatch decode latencies — live in the
# 100us-10ms band (bench decode leg: ~0.33ms/token on the CPU proxy)
# where even SERVING_BUCKETS' 0.5ms floor smears everything into two
# buckets. Sub-ms ladder below, SERVING-compatible tail above so one
# scrape still localizes an outlier stream.
DECODE_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 1.0, 5.0,
)


def _label_key(label_names, labels):
    labels = labels or {}
    extra = set(labels) - set(label_names)
    if extra:
        raise ValueError(
            "unknown label(s) %s (declared: %s)"
            % (sorted(extra), list(label_names)))
    return tuple((n, str(labels.get(n, ""))) for n in label_names)


def _fmt_value(v):
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return repr(v)
    return repr(float(v)) if isinstance(v, float) else str(v)


def _fmt_labels(pairs, extra=()):
    items = [(k, v) for k, v in pairs] + list(extra)
    if not items:
        return ""
    body = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in items)
    return "{%s}" % body


class _Metric(object):
    kind = None

    def __init__(self, name, help_text, label_names):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        # deliberately NOT a lock_witness factory: the witness reports
        # through these very metrics — wrapping them would recurse
        self._lock = threading.Lock()
        self._values = {}  # label key tuple -> value

    def _series(self):
        """Consistent copy for export. Scalar values copy shallow; the
        Histogram override deep-copies its state dicts — the exporter
        reads count several times per series, and a concurrent observe()
        between those reads would emit a scrape where bucket{+Inf},
        _count and _sum disagree."""
        with self._lock:
            return dict(self._values)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount=1, **labels):
        if amount < 0:
            raise ValueError("counter can only increase (got %r)" % amount)
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels):
        key = _label_key(self.label_names, labels)
        with self._lock:
            return self._values.get(key, 0)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value, **labels):
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._values[key] = value

    def inc(self, amount=1, **labels):
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def dec(self, amount=1, **labels):
        self.inc(-amount, **labels)

    def value(self, **labels):
        key = _label_key(self.label_names, labels)
        with self._lock:
            return self._values.get(key, 0)


class Histogram(_Metric):
    """Fixed-bucket cumulative histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name, help_text, label_names, buckets):
        super(Histogram, self).__init__(name, help_text, label_names)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bs

    def observe(self, value, exemplar=None, **labels):
        """``exemplar``: an opaque id (a trace id) remembered for the
        NARROWEST bucket the value lands in — last writer wins per
        bucket, so a scrape's p99 bucket names a recent replayable
        request (observability/tracing.py resolves it against the
        completed-trace ring). Exemplars ride the JSON snapshot only;
        the text exposition stays plain 0.0.4."""
        key = _label_key(self.label_names, labels)
        value = float(value)
        with self._lock:
            st = self._values.get(key)
            if st is None:
                st = {"count": 0, "sum": 0.0,
                      "buckets": [0] * len(self.buckets)}
                self._values[key] = st
            st["count"] += 1
            st["sum"] += value
            counts = st["buckets"]
            narrowest = len(self.buckets)  # +Inf overflow bucket
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
                    narrowest = min(narrowest, i)
            if exemplar is not None:
                st.setdefault("exemplars", {})[narrowest] = {
                    "id": str(exemplar), "value": value,
                    "ts": time.time()}

    def exemplars(self, **labels):
        """{bucket_index: {"id", "value", "ts"}} for one series —
        index len(buckets) is the +Inf overflow bucket."""
        key = _label_key(self.label_names, labels)
        with self._lock:
            st = self._values.get(key)
            if st is None:
                return {}
            return {i: dict(e)
                    for i, e in (st.get("exemplars") or {}).items()}

    def snapshot(self, **labels):
        key = _label_key(self.label_names, labels)
        with self._lock:
            st = self._values.get(key)
            if st is None:
                return {"count": 0, "sum": 0.0,
                        "buckets": [0] * len(self.buckets)}
            out = {"count": st["count"], "sum": st["sum"],
                   "buckets": list(st["buckets"])}
            if st.get("exemplars"):
                out["exemplars"] = {i: dict(e)
                                    for i, e in st["exemplars"].items()}
            return out

    def _series(self):
        with self._lock:
            out = {}
            for key, st in self._values.items():
                entry = {"count": st["count"], "sum": st["sum"],
                         "buckets": list(st["buckets"])}
                if st.get("exemplars"):
                    entry["exemplars"] = {
                        i: dict(e) for i, e in st["exemplars"].items()}
                out[key] = entry
            return out


class MetricsRegistry(object):
    def __init__(self):
        # plain on purpose — see the per-metric lock note above
        self._lock = threading.Lock()
        self._metrics = {}      # name -> metric, insertion-ordered
        self._order = []
        self._collectors = []

    def _register(self, cls, name, help_text, labels, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.label_names != tuple(labels):
                    raise ValueError(
                        "metric %r re-registered with a different type or "
                        "label set" % name)
                return m
            m = cls(name, help_text, tuple(labels), **kw)
            self._metrics[name] = m
            self._order.append(name)
            return m

    def counter(self, name, help_text="", labels=()):
        return self._register(Counter, name, help_text, labels)

    def gauge(self, name, help_text="", labels=()):
        return self._register(Gauge, name, help_text, labels)

    def histogram(self, name, help_text="", labels=(),
                  buckets=DEFAULT_BUCKETS):
        return self._register(Histogram, name, help_text, labels,
                              buckets=buckets)

    def register_collector(self, fn):
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def reset(self):
        """Zero every metric's series, keeping registrations alive:
        modules bind metric handles once at import (telemetry, explain,
        inference), so dropping the registration would orphan those
        handles — they would keep incrementing objects no scrape can see.
        Collectors stay."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            with m._lock:
                m._values.clear()

    # -- export --------------------------------------------------------------
    def _collected(self):
        """[(name, kind, help, [(label_pairs, value)])] from collectors."""
        with self._lock:
            collectors = list(self._collectors)
        out = []
        for fn in collectors:
            try:
                for name, kind, help_text, series in fn():
                    out.append((
                        name, kind, help_text,
                        [(tuple(sorted(lbl.items())), v)
                         for lbl, v in series]))
            except Exception:
                # a broken collector must never take down the scrape
                continue
        return out

    def to_prometheus(self):
        """Prometheus text exposition format 0.0.4."""
        lines = []
        with self._lock:
            metrics = [self._metrics[n] for n in self._order]
        for m in metrics:
            lines.append("# HELP %s %s" % (m.name, m.help or m.name))
            lines.append("# TYPE %s %s" % (m.name, m.kind))
            series = sorted(m._series().items())
            if m.kind == "histogram":
                for key, st in series:
                    cum = 0
                    for bound, c in zip(m.buckets, st["buckets"]):
                        cum = c
                        lines.append("%s_bucket%s %s" % (
                            m.name,
                            _fmt_labels(key, [("le", _fmt_value(bound))]),
                            cum))
                    lines.append("%s_bucket%s %s" % (
                        m.name, _fmt_labels(key, [("le", "+Inf")]),
                        st["count"]))
                    lines.append("%s_sum%s %s" % (
                        m.name, _fmt_labels(key), _fmt_value(st["sum"])))
                    lines.append("%s_count%s %s" % (
                        m.name, _fmt_labels(key), st["count"]))
            else:
                for key, v in series:
                    lines.append("%s%s %s" % (
                        m.name, _fmt_labels(key), _fmt_value(v)))
        for name, kind, help_text, series in self._collected():
            lines.append("# HELP %s %s" % (name, help_text or name))
            lines.append("# TYPE %s %s" % (name, kind))
            for key, v in sorted(series):
                lines.append("%s%s %s" % (name, _fmt_labels(key),
                                          _fmt_value(v)))
        return "\n".join(lines) + "\n"

    def snapshot(self):
        """One JSON-able dict of every series (registry + collectors)."""
        out = {"ts": time.time(), "metrics": {}}
        with self._lock:
            metrics = [self._metrics[n] for n in self._order]
        for m in metrics:
            series = []
            for key, v in sorted(m._series().items()):
                entry = {"labels": dict(key)}
                if m.kind == "histogram":
                    entry.update(count=v["count"], sum=v["sum"],
                                 buckets=list(v["buckets"]))
                    if v.get("exemplars"):
                        # JSON keys must be strings; bucket index keys
                        # stringify (index == len(bounds) is +Inf)
                        entry["exemplars"] = {
                            str(i): e for i, e in v["exemplars"].items()}
                else:
                    entry["value"] = v
                series.append(entry)
            rec = {"type": m.kind, "series": series}
            if m.kind == "histogram":
                rec["bucket_bounds"] = list(m.buckets)
            out["metrics"][m.name] = rec
        for name, kind, _help, series in self._collected():
            out["metrics"].setdefault(name, {"type": kind, "series": []})[
                "series"].extend(
                    {"labels": dict(key), "value": v} for key, v in series)
        return out

    def write_prometheus(self, path):
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_prometheus())
        os.replace(tmp, path)  # atomic: scrapers see old or new, not torn

    def write_jsonl(self, path, mode="a"):
        """Append one snapshot line (JSONL: a time series of scrapes)."""
        with open(path, mode) as f:
            f.write(json.dumps(self.snapshot(), sort_keys=True) + "\n")


REGISTRY = MetricsRegistry()
