"""Trace-context propagation: one ``trace_id`` across processes.

A copy of ``veles_tpu/observability/trace.py``: a *trace context*
(``trace_id`` + span ids) travels with the work, and reads and writes
the same wire as the JAX package's, so either package adopts the
other's context:

- in-process via a thread-local span stack (plus a process-wide ambient
  context adopted from the environment), stamped onto every
  :class:`~veles_tpu_torch.logger.EventLog` record;
- in protocol messages as a :func:`payload` dict (``{"trace_id",
  "parent_span"}``), entered with :func:`adopt`;
- parent -> child process via the ``VELES_TRACE_CONTEXT`` environment
  variable (:func:`inject_env` / :func:`adopt_env`; the fleet supervisor
  plants it in every replica);
- HTTP request -> batch -> step in serving (the ``X-Trace-Id`` header,
  :func:`http_headers`; the fleet router forwards it to the replica).

Each process still writes its own ``events-<pid>.jsonl``; because the
records share one ``trace_id``, ``tools/merge_traces.py`` folds them
into a single chrome://tracing / Perfetto timeline.  Setting
``VELES_TRACE_DIR`` enables tracing in any process of the package.

Stdlib-only; importable from anywhere without cycles.
"""

import contextlib
import os
import threading
import uuid

__all__ = ["new_id", "current", "span_context", "adopt", "payload",
           "http_headers", "inject_env", "adopt_env", "set_ambient",
           "TRACE_ENV"]

#: env var carrying "trace_id:parent_span" across process boundaries
TRACE_ENV = "VELES_TRACE_CONTEXT"

_local = threading.local()
_ambient = None      # process-wide fallback (set once from the env)


class SpanContext:
    """One active span: ids only — timing stays with the EventLog."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id, span_id, parent_id=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    def __repr__(self):
        return "<span %s/%s parent=%s>" % (self.trace_id, self.span_id,
                                           self.parent_id)


def new_id():
    """A fresh 64-bit hex id (trace or span)."""
    return uuid.uuid4().hex[:16]


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def current():
    """The innermost active :class:`SpanContext` (thread-local first,
    then the process ambient context), or None."""
    stack = _stack()
    if stack:
        return stack[-1]
    return _ambient


def set_ambient(trace_id, parent_span=None):
    """Install a process-wide fallback context (e.g. adopted from the
    spawning master via the environment)."""
    global _ambient
    _ambient = SpanContext(trace_id, parent_span or new_id(), None) \
        if trace_id else None
    return _ambient


@contextlib.contextmanager
def span_context(trace_id=None, parent=None):
    """Push a new span: child of the current context unless overridden."""
    cur = current()
    tid = trace_id or (cur.trace_id if cur else new_id())
    pid = parent if parent is not None else \
        (cur.span_id if cur and tid == cur.trace_id else None)
    ctx = SpanContext(tid, new_id(), pid)
    stack = _stack()
    stack.append(ctx)
    try:
        yield ctx
    finally:
        stack.pop()


def payload(ctx=None):
    """Wire form of ``ctx`` (default: current) for protocol messages;
    the receiver's spans become CHILDREN of this span.  None when no
    context is active."""
    ctx = ctx or current()
    if ctx is None:
        return None
    return {"trace_id": ctx.trace_id, "parent_span": ctx.span_id}


@contextlib.contextmanager
def adopt(wire):
    """Enter the remote context described by a :func:`payload` dict
    (no-op passthrough for None/garbage — a traceless peer must not
    break the receiver)."""
    if not isinstance(wire, dict) or not wire.get("trace_id"):
        yield None
        return
    with span_context(trace_id=str(wire["trace_id"]),
                      parent=wire.get("parent_span")) as ctx:
        yield ctx


def http_headers(ctx=None):
    """HTTP form of ``ctx`` (default: current) — the headers an
    in-process hop (fleet router → replica) forwards so the receiving
    server's request span joins the same trace.  Empty when no context
    is active."""
    ctx = ctx or current()
    if ctx is None:
        return {}
    return {"X-Trace-Id": ctx.trace_id}


def inject_env(env=None):
    """Return ``env`` (default: a copy of os.environ) with the current
    context encoded for a child process; unchanged when no context."""
    ctx = current()
    if ctx is None:
        return env
    env = dict(os.environ if env is None else env)
    env[TRACE_ENV] = "%s:%s" % (ctx.trace_id, ctx.span_id)
    return env


def adopt_env(environ=None):
    """Adopt :data:`TRACE_ENV` from the environment as the process
    ambient context (call once at process startup).  Returns the
    context or None."""
    raw = (environ if environ is not None else os.environ).get(TRACE_ENV)
    if not raw:
        return None
    trace_id, _, parent = raw.partition(":")
    ctx = SpanContext(trace_id, new_id(), parent or None)
    global _ambient
    _ambient = ctx
    return ctx
