"""Trace context: one ``trace_id`` from the HTTP request to its spans.

The part of ``veles_tpu/observability/trace.py`` the serving path uses:
a thread-local span stack.  The server opens a span context per request
(the client's ``X-Trace-Id`` header, or a fresh id), answers with the
id in ``X-Trace-Id``, and the event log stamps it onto every record
written while the context is active.  The cross-process propagation of
the JAX package (job messages, the environment) is not ported.

Stdlib only.
"""

import contextlib
import threading
import uuid

__all__ = ["new_id", "current", "span_context"]

_local = threading.local()


class SpanContext:
    """One active span: ids only — timing stays with the event log."""

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
    """The innermost active :class:`SpanContext` of this thread, or
    None."""
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def span_context(trace_id=None):
    """Push a new span: a child of the current context when it shares
    its trace."""
    cur = current()
    tid = trace_id or (cur.trace_id if cur else new_id())
    pid = cur.span_id if cur and tid == cur.trace_id else None
    ctx = SpanContext(tid, new_id(), pid)
    stack = _stack()
    stack.append(ctx)
    try:
        yield ctx
    finally:
        stack.pop()
