"""Metrics registry: labelled counters, gauges and histograms.

A copy of ``veles_tpu/observability/registry.py`` (stdlib only): one
process-global, thread-safe store of labelled counters, gauges and
histograms that the training profiler
(:mod:`veles_tpu_torch.observability.profiler`), the serving metrics
(:mod:`veles_tpu_torch.serving.metrics`), the flight recorder and the
fleet router record into, exportable as Prometheus text exposition
(format 0.0.4) or as a JSON-able snapshot.  The serving server's and
the fleet router's ``GET /metrics`` report the same numbers.

No other module of the package is imported here, so ``logger.py``,
``units.py`` and the serving stack all use it without cycles.
"""

import math
import threading
import weakref

__all__ = ["MetricsRegistry", "REGISTRY", "counter", "gauge", "histogram",
           "render_prometheus"]

#: default histogram ladder (seconds): micro-benchmark to human scale
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _escape_label(value):
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _format_value(v):
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if isinstance(v, float) and v != v:
        return "NaN"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


class _Child:
    """One (metric, label-values) time series."""

    __slots__ = ("_lock", "labels")

    def __init__(self, labels):
        self._lock = threading.Lock()
        self.labels = labels            # tuple of label values


class CounterChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, labels):
        super().__init__(labels)
        self._value = 0.0

    def inc(self, amount=1):
        if amount < 0:
            raise ValueError("counters only go up (got %r)" % (amount,))
        with self._lock:
            self._value += amount

    @property
    def value(self):
        return self._value


class GaugeChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, labels):
        super().__init__(labels)
        self._value = 0.0

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    def dec(self, amount=1):
        self.inc(-amount)

    def set_max(self, value):
        """Watermark semantics: keep the maximum ever seen."""
        with self._lock:
            if value > self._value:
                self._value = float(value)

    @property
    def value(self):
        return self._value


class HistogramChild(_Child):
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, labels, buckets):
        super().__init__(labels)
        self.buckets = buckets
        self.counts = [0] * len(buckets)    # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0

    def observe(self, value):
        value = float(value)
        with self._lock:
            self.sum += value
            self.count += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self.counts[i] += 1
                    break

    def snapshot(self):
        with self._lock:
            return {"count": self.count, "sum": round(self.sum, 6),
                    "avg": round(self.sum / self.count, 6)
                    if self.count else None}


class Metric:
    """A named metric family; ``labels(**kv)`` returns the child series."""

    def __init__(self, name, help, kind, label_names, buckets=None):
        self.name = name
        self.help = help
        self.kind = kind                    # counter | gauge | histogram
        self.label_names = tuple(label_names)
        self.buckets = tuple(buckets) if buckets else None
        self._children = {}
        self._default_child = None
        self._lock = threading.Lock()

    def labels(self, **kv):
        if set(kv) != set(self.label_names):
            raise ValueError(
                "%s expects labels %r, got %r"
                % (self.name, self.label_names, tuple(kv)))
        key = tuple(str(kv[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    if self.kind == "counter":
                        child = CounterChild(key)
                    elif self.kind == "gauge":
                        child = GaugeChild(key)
                    else:
                        child = HistogramChild(key, self.buckets)
                    self._children[key] = child
        return child

    # label-less convenience: the metric itself acts as its only child
    # (child cached: inc() sits on serving hot paths, and labels()
    # rebuilds the key tuple + set-compares on every call)
    def _default(self):
        child = self._default_child
        if child is None:
            if self.label_names:
                raise ValueError("%s has labels %r; use .labels(...)"
                                 % (self.name, self.label_names))
            child = self.labels()
            self._default_child = child
        return child

    def inc(self, amount=1):
        self._default().inc(amount)

    def set(self, value):
        self._default().set(value)

    def observe(self, value):
        self._default().observe(value)

    @property
    def value(self):
        return self._default().value

    def children(self):
        with self._lock:
            return dict(self._children)


class MetricsRegistry:
    """Thread-safe name → :class:`Metric` map with Prometheus export.

    Metric constructors are idempotent: asking for an existing name with
    the same kind/labels returns the existing family (so modules can
    declare their metrics independently); a conflicting redeclaration
    raises — silent type drift would corrupt the exposition.
    """

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()
        # scrape-time collectors (prometheus-client custom-collector
        # style): objects whose collect_metrics() refreshes derived
        # gauges (e.g. latency quantiles over a sample window) right
        # before export.  Weak references: a dead scheduler's metrics
        # object must not be kept alive (or keep collecting) forever.
        self._collectors = weakref.WeakSet()

    def _declare(self, name, help, kind, label_names, buckets=None):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is not None:
                if metric.kind != kind or \
                        metric.label_names != tuple(label_names):
                    raise ValueError(
                        "metric %r already declared as %s%r, cannot "
                        "redeclare as %s%r" %
                        (name, metric.kind, metric.label_names, kind,
                         tuple(label_names)))
                return metric
            metric = Metric(name, help, kind, label_names, buckets)
            self._metrics[name] = metric
            return metric

    def counter(self, name, help="", labels=()):
        return self._declare(name, help, "counter", labels)

    def gauge(self, name, help="", labels=()):
        return self._declare(name, help, "gauge", labels)

    def histogram(self, name, help="", labels=(), buckets=None):
        return self._declare(name, help, "histogram", labels,
                             buckets or DEFAULT_BUCKETS)

    def register_collector(self, obj):
        """Register ``obj`` (held weakly); its ``collect_metrics()``
        runs before every export."""
        self._collectors.add(obj)
        return obj

    def _run_collectors(self):
        for obj in list(self._collectors):
            try:
                obj.collect_metrics()
            except Exception:  # noqa: BLE001 — a broken collector must
                pass           # never take down the scrape endpoint

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def metrics(self):
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    # -- export --------------------------------------------------------------
    def render_prometheus(self):
        """The full registry as Prometheus text exposition 0.0.4."""
        self._run_collectors()
        lines = []
        for metric in self.metrics():
            lines.append("# HELP %s %s" %
                         (metric.name,
                          metric.help.replace("\\", "\\\\")
                          .replace("\n", "\\n")))
            lines.append("# TYPE %s %s" % (metric.name, metric.kind))
            children = metric.children()
            for key in sorted(children):
                child = children[key]
                pairs = list(zip(metric.label_names, key))
                if metric.kind == "histogram":
                    cum = 0
                    for b, c in zip(child.buckets, child.counts):
                        cum += c
                        lines.append("%s_bucket{%s} %d" % (
                            metric.name,
                            _label_str(pairs + [("le", _format_value(
                                float(b)))]),
                            cum))
                    lines.append("%s_bucket{%s} %d" % (
                        metric.name,
                        _label_str(pairs + [("le", "+Inf")]),
                        child.count))
                    suffix = _label_str(pairs)
                    suffix = "{%s}" % suffix if suffix else ""
                    lines.append("%s_sum%s %s" % (
                        metric.name, suffix, _format_value(child.sum)))
                    lines.append("%s_count%s %d" % (
                        metric.name, suffix, child.count))
                else:
                    suffix = _label_str(pairs)
                    suffix = "{%s}" % suffix if suffix else ""
                    lines.append("%s%s %s" % (
                        metric.name, suffix, _format_value(child.value)))
        return "\n".join(lines) + "\n" if lines else ""

    def snapshot(self):
        """JSON-able view for the /status merge and dashboards."""
        self._run_collectors()
        out = {}
        for metric in self.metrics():
            series = []
            children = metric.children()
            for key in sorted(children):
                child = children[key]
                entry = {"labels": dict(zip(metric.label_names, key))}
                if metric.kind == "histogram":
                    entry.update(child.snapshot())
                else:
                    entry["value"] = child.value
                series.append(entry)
            out[metric.name] = {"type": metric.kind, "help": metric.help,
                                "series": series}
        return out

    def reset(self):
        """Drop every metric (tests / forked workers)."""
        with self._lock:
            self._metrics.clear()


def _label_str(pairs):
    return ",".join('%s="%s"' % (n, _escape_label(v)) for n, v in pairs)


#: the process-global registry every subsystem records into
REGISTRY = MetricsRegistry()


def counter(name, help="", labels=()):
    return REGISTRY.counter(name, help, labels)


def gauge(name, help="", labels=()):
    return REGISTRY.gauge(name, help, labels)


def histogram(name, help="", labels=(), buckets=None):
    return REGISTRY.histogram(name, help, labels, buckets)


def render_prometheus():
    return REGISTRY.render_prometheus()
