"""Pickling protocol for framework objects.

Mirrors the reference ``Pickleable`` semantics
(veles/distributable.py:48-133): every attribute whose name
ends with ``_`` is *transient* — excluded from pickles — and must be restored
by ``init_unpickled()``, which runs both at construction and after unpickling.
"""

import threading


class Pickleable:
    """Base for objects that survive pickling with transient state.

    Subclasses override :meth:`init_unpickled` to (re)create every
    ``*_``-suffixed attribute and must call ``super().init_unpickled()``.
    """

    def __init__(self):
        self.init_unpickled()

    def init_unpickled(self):
        """(Re)create transient state.  Called on init and on unpickle."""
        self.stream_ = None

    def __getstate__(self):
        state = {}
        for key, value in self.__dict__.items():
            if key.endswith("_"):
                continue
            if callable(value) and getattr(value, "__self__", None) is self:
                continue  # bound methods of self are rebuilt on restore
            if callable(value) and getattr(value, "transient_", False):
                # instrumentation wrappers installed over methods (e.g.
                # a MinibatchPrefetcher's run()) mark themselves
                # transient: they hold threads/queues and are re-attached
                # after restore, never pickled
                continue
            state[key] = value
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.init_unpickled()


class Lockable(Pickleable):
    """Pickleable with a transient reentrant lock (``_lock_``)."""

    def init_unpickled(self):
        super().init_unpickled()
        self._lock_ = threading.RLock()

    def __enter__(self):
        self._lock_.acquire()
        return self

    def __exit__(self, *unused):
        self._lock_.release()
