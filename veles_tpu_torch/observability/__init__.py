"""Observability of the port (host-only copies of
``veles_tpu.observability``):

- :mod:`.registry`: the process-global :class:`MetricsRegistry`
  (labelled counters, gauges, histograms) that training and serving
  record into, rendered as Prometheus text;
- :mod:`.trace`: trace-context propagation (``X-Trace-Id``, the
  ``VELES_TRACE_CONTEXT`` environment variable, protocol payloads), the
  JAX package's wire;
- :mod:`.flight`: the per-request flight recorder; :mod:`.attribution`
  turns its timelines into phase shares;
- :mod:`.profiler`: :class:`StepProfiler`, the data-wait / host /
  device split of a training step.

``registry`` and ``trace`` are stdlib-only and import nothing of the
package; the others load lazily on attribute access (the profiler needs
the logger, which imports ``trace``).
"""

from .registry import (MetricsRegistry, REGISTRY, counter, gauge,  # noqa
                       histogram, render_prometheus)
from . import trace                                                # noqa


def __getattr__(name):
    if name == "StepProfiler":
        from .profiler import StepProfiler
        return StepProfiler
    if name in ("profiler", "flight", "attribution"):
        import importlib
        return importlib.import_module("." + name, __name__)
    if name == "FlightRecorder":
        from .flight import FlightRecorder
        return FlightRecorder
    raise AttributeError(name)
