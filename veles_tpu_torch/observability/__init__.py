"""Observability of the port: the metrics registry behind ``/metrics``
and the trace context behind ``X-Trace-Id`` (host-only copies of
``veles_tpu.observability``'s registry and trace modules)."""
