"""Workflow: a container of linked units with a run lifecycle.

The port's copy of ``veles_tpu/workflow.py``, a re-design of
veles/workflow.py:87-1051.  Kept: unit multiset with add_ref/del_ref,
initialize in dependency order with deferred-init retries, run/stop
lifecycle via StartPoint/EndPoint, aggregation of the IDistributable
5-method protocol across member units (workflow.py:478-574), Graphviz
graph generation (:628), results gathering (:827), checksum (:852),
per-unit timing table (:788-825).

Not ported yet (ROADMAP.md): the minibatch prefetcher, the graph
compiler, the step profiler and ``package_export``.
"""

import collections
import hashlib
import json
import sys

from .plumbing import StartPoint, EndPoint
from .result_provider import IResultProvider
from .units import Container


class NoMoreJobs(Exception):
    """Raised by generate_data_for_slave when the epoch is exhausted."""


class Workflow(Container):
    """A directed graph of units executed from start_point to end_point."""

    hide_from_registry = True

    def __init__(self, workflow=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self._units = []
        self.start_point = StartPoint(self)
        self.end_point = EndPoint(self)
        self.device = None
        self.launcher_ref = None
        self.result_file = kwargs.get("result_file")
        self._restored_from_snapshot = False

    def init_unpickled(self):
        super().init_unpickled()
        self._queue_ = collections.deque()
        self._is_finished_ = False
        self._is_running_ = False
        self._run_after_stop_warned_ = set()
        self._on_finished_callbacks_ = []

    # -- container protocol --------------------------------------------------
    def add_ref(self, unit):
        if unit is self:
            raise ValueError("a workflow cannot contain itself")
        if unit not in self._units:
            # unique member names: links, stats, and the export archive
            # (per-unit .npy paths, package contents.json) are all keyed
            # by name — two default-named Conv units must not collide
            taken = {u.name for u in self._units}
            if unit.name in taken:
                base = unit.name
                i = 1
                while "%s.%d" % (base, i) in taken:
                    i += 1
                unit.name = "%s.%d" % (base, i)
            self._units.append(unit)
        unit.workflow = self

    def del_ref(self, unit):
        if unit in self._units:
            self._units.remove(unit)

    @property
    def units(self):
        return list(self._units)

    def __iter__(self):
        return iter(self._units)

    def __len__(self):
        return len(self._units)

    def __getitem__(self, key):
        if isinstance(key, str):
            for u in self._units:
                if u.name == key:
                    return u
            raise KeyError(key)
        return self._units[key]

    def index_of(self, unit):
        return self._units.index(unit)

    # -- state ---------------------------------------------------------------
    @property
    def is_finished(self):
        return self._is_finished_

    @property
    def is_running(self):
        return self._is_running_

    @property
    def restored_from_snapshot(self):
        return self._restored_from_snapshot

    # -- lifecycle -----------------------------------------------------------
    def initialize(self, device=None, **kwargs):
        """Initialize all units in dependency order.

        A unit returning True from initialize() means "dependencies not yet
        satisfied" — it is retried after the others (reference
        workflow.py:303-350 deferred init).
        """
        super().initialize(**kwargs)
        self.device = device
        order = self._dependency_order()
        pending = collections.deque(order)
        retries = 0
        max_retries = len(pending) ** 2 + 10
        while pending:
            unit = pending.popleft()
            if unit is self:
                continue
            unit.verify_demands()
            deferred = unit.initialize(device=device, **kwargs)
            if deferred:
                pending.append(unit)
                retries += 1
                if retries > max_retries:
                    raise RuntimeError(
                        "initialization deadlock; still pending: %s" %
                        ([u.name for u in pending]))
        for unit in order:
            unit.reset_gates()
        self._is_finished_ = False
        return self

    def _dependency_order(self):
        """Topological order over control links from start_point, then any
        unlinked units in insertion order."""
        order, seen = [], set()
        queue = collections.deque([self.start_point])
        indeg = {}
        for u in self._units:
            indeg[u] = len(u.links_from)
        while queue:
            u = queue.popleft()
            if id(u) in seen:
                continue
            seen.add(id(u))
            order.append(u)
            for dst in u.links_to:
                if id(dst) not in seen:
                    indeg[dst] = indeg.get(dst, 1) - 1
                    if indeg[dst] <= 0 or dst.ignores_gate:
                        queue.append(dst)
        # break cycles / pick up stragglers in insertion order
        for u in self._units:
            if id(u) not in seen:
                seen.add(id(u))
                order.append(u)
        return order

    def run(self):
        """Execute the graph from start_point until the workflow finishes or
        no unit is ready (reference workflow.py:351-400)."""
        self._is_running_ = True
        self._is_finished_ = False
        for unit in self._units:
            unit.reset_gates()  # no stale AND-gate latches from a prior run
        schedule = self._queue_.append
        try:
            self.start_point.execute(schedule)
            while self._queue_:
                unit = self._queue_.popleft()
                if self._is_finished_ and not (unit.runs_after_stop or
                                               unit.ignores_gate):
                    # scheduled before EndPoint fired this iteration;
                    # only service side-branches (plotters, reporters)
                    # still observe the final state
                    continue
                unit.execute(schedule)
        finally:
            self._queue_.clear()
            self._is_running_ = False
        return self

    def on_workflow_finished(self):
        self._is_finished_ = True
        for unit in self._units:
            unit.stop()
        for cb in self._on_finished_callbacks_:
            cb()

    def add_finished_callback(self, cb):
        self._on_finished_callbacks_.append(cb)

    def stop(self):
        if not self._is_finished_:
            self.on_workflow_finished()

    def warning_run_after_stop(self, unit):
        if unit.name not in self._run_after_stop_warned_:
            self._run_after_stop_warned_.add(unit.name)
            print("WARNING: %s signaled after the workflow finished "
                  "(check your links)" % unit, file=sys.stderr)

    def make_train_gate(self, loader):
        """A gate_skip Bool that is True while the loader serves non-train
        minibatches — wire it to GD units so updates happen only on the
        train class (the reference links gds through Decision the same
        way)."""
        from .loader.base import TRAIN
        from .mutable import Bool
        return Bool.from_callable(
            lambda: loader.minibatch_class != TRAIN,
            name="not_train")

    # -- IDistributable aggregation (reference workflow.py:478-574) ----------
    def generate_data_for_master(self):
        data = []
        for unit in self._units:
            data.append(unit.generate_data_for_master())
        return data

    def generate_data_for_slave(self, slave=None):
        data = []
        has_any = False
        for unit in self._units:
            if not unit.has_data_for_slave:
                data.append(None)
                continue
            data.append(unit.generate_data_for_slave(slave))
            has_any = True
        if not has_any:
            raise NoMoreJobs()
        return data

    def apply_data_from_master(self, data):
        for unit, d in zip(self._units, data):
            if d is not None:
                unit.apply_data_from_master(d)

    def apply_data_from_slave(self, data, slave=None):
        with self:
            for unit, d in zip(self._units, data):
                if d is not None:
                    unit.apply_data_from_slave(d, slave)

    def drop_slave(self, slave=None):
        for unit in self._units:
            unit.drop_slave(slave)

    def do_job(self, data, update, callback):
        """Slave-side: apply master data, run one pass, call back with the
        update (reference workflow.py:558-574)."""
        self.apply_data_from_master(data)
        if update is not None:
            self.apply_data_from_slave(update)
        self.run()
        callback(self.generate_data_for_master())

    # -- observability -------------------------------------------------------
    def attach_profiler(self, **kwargs):
        """Instrument this workflow's training step with a
        :class:`~veles_tpu_torch.observability.profiler.StepProfiler`
        (data-wait / host / device / snapshot split, examples/sec, the
        card's peak memory -> registry series and ``train.step`` spans).
        Call after ``initialize``.  Reachable as ``self.profiler``;
        ``profiler.detach()`` removes its wrappers.  Stored transiently
        (``profiler_``): a pickle never carries the profiler."""
        from .observability.profiler import StepProfiler
        self.profiler_ = StepProfiler(self, **kwargs)
        return self.profiler_

    @property
    def profiler(self):
        return getattr(self, "profiler_", None)

    # -- results / stats -----------------------------------------------------
    def gather_results(self):
        """Collect metrics from every IResultProvider unit
        (reference workflow.py:827-849)."""
        results = {}
        for unit in self._units:
            if isinstance(unit, IResultProvider):
                results.update(unit.get_metric_values())
        return results

    def write_results(self, file=None, results=None):
        """Serialize results JSON (the single serialization path — the
        Launcher passes its enriched dict through ``results``)."""
        results = results if results is not None else self.gather_results()
        path = file or self.result_file
        if path == "-":
            json.dump(results, sys.stdout, indent=2, default=str)
            sys.stdout.write("\n")
        elif path:
            with open(path, "w") as f:
                json.dump(results, f, indent=2, default=str)
        return results

    def print_stats(self, top=10, file=None):
        """Top-N unit run-time table (reference workflow.py:788-825)."""
        file = file or sys.stdout
        total = sum(u.timers["run"] for u in self._units) or 1e-12
        rows = sorted(((u.timers["run"], u.timers["runs"], u.name)
                       for u in self._units), reverse=True)[:top]
        print("%-28s %10s %8s %7s" % ("unit", "time,s", "runs", "%"),
              file=file)
        for t, n, name in rows:
            print("%-28s %10.3f %8d %6.1f%%" % (name, t, n, 100 * t / total),
                  file=file)

    # -- graph / identity ----------------------------------------------------
    def generate_graph(self, filename=None):
        """Emit the unit graph in Graphviz dot format
        (reference workflow.py:628)."""
        lines = ["digraph %s {" % self.name.replace(" ", "_")]
        for u in self._units:
            lines.append('  "%s" [label="%s\\n%s"];' %
                         (u.name, u.name, u.__class__.__name__))
        for u in self._units:
            for dst in u.links_to:
                lines.append('  "%s" -> "%s";' % (u.name, dst.name))
        lines.append("}")
        text = "\n".join(lines)
        if filename:
            with open(filename, "w") as f:
                f.write(text)
        return text

    @property
    def checksum(self):
        """Stable digest of the unit graph used in the master/slave handshake
        (reference workflow.py:852-866)."""
        desc = json.dumps([u.describe() for u in self._units],
                          sort_keys=True, default=str)
        return hashlib.sha256(desc.encode()).hexdigest()
