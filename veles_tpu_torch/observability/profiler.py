"""StepProfiler: where does a training step spend its time?

The port of ``veles_tpu/observability/profiler.py``.  It wraps the two
hot units of a workflow, the loader and the fused train step, and
splits every step into:

- **data-wait**: host-side minibatch preparation (the loader's run);
- **host**: Python and launch time of the step's ``run()`` (CUDA
  launches are asynchronous, so this is the enqueue cost, not the
  math);
- **device**: the remaining device tail, measured by fencing with
  ``torch.cuda.synchronize`` on the step's device after ``run()``
  returns (on the CPU every operation has finished when it returns, so
  this share is ~0 there);
- **snapshot**: the stall a workflow's snapshotter reports (its
  ``stall_s``), when the workflow has one.  The port's workflows have
  none until the snapshotter is ported (ROADMAP queue A item 8), so
  this slice stays absent from their summaries.

It also counts examples/sec over a sliding window and the card's peak
memory (``torch.cuda.max_memory_allocated``).  The recompile count
keeps its key and its series for the JAX package's readers, and is
always 0 here: PyTorch runs eagerly and the kernels are built once at
first use, so nothing recompiles.  Everything is emitted twice: into the
process-global :class:`~veles_tpu_torch.observability.registry
.MetricsRegistry` and as ``train.step`` spans into the
:class:`~veles_tpu_torch.logger.EventLog`.

Fencing serializes the launch queue, which is what makes the breakdown
honest, and is why the profiler is opt-in
(:meth:`veles_tpu_torch.workflow.Workflow.attach_profiler`): a timed run
keeps it detached.
"""

import collections
import time

from ..logger import events
from .registry import REGISTRY

__all__ = ["StepProfiler", "RATE_WINDOW", "MEM_POLL_STEPS"]

#: examples/sec sliding window (steps)
RATE_WINDOW = 256
#: device-memory watermark poll period (steps)
MEM_POLL_STEPS = 16


def _find_step(workflow):
    step = getattr(workflow, "fused_step", None)
    if step is not None:
        return step
    for unit in workflow:
        if getattr(unit, "view_group", None) == "TRAINER":
            return unit
    raise ValueError("no training step found in %r (pass step=...)"
                     % workflow)


def _find_loader(workflow):
    loader = getattr(workflow, "loader", None)
    if loader is not None and hasattr(loader, "run"):
        return loader
    return None


def _transient(method):
    """Wrap a bound method in a plain function marked ``transient_`` so
    ``Pickleable.__getstate__`` drops the instrumentation instead of
    dragging the profiler (registry children, locks) into a pickle."""
    def call():
        return method()
    call.transient_ = True
    return call


class StepProfiler:
    """Wraps ``loader.run``/``step.run`` of one workflow with timing and
    memory accounting.  ``detach()`` restores both."""

    def __init__(self, workflow=None, step=None, loader=None,
                 registry=None, fence=True, name=None):
        if step is None:
            step = _find_step(workflow)
        if loader is None and workflow is not None:
            loader = _find_loader(workflow)
        self.workflow = workflow
        self.step = step
        self.loader = loader
        self.fence = fence
        self.name = name or (workflow.name if workflow is not None
                             else type(step).__name__)
        reg = registry or REGISTRY
        lbl = {"workflow": self.name}
        self._c_steps = reg.counter(
            "veles_training_steps_total",
            "Training/eval steps executed", ("workflow",)).labels(**lbl)
        self._c_examples = reg.counter(
            "veles_training_examples_total",
            "Examples consumed by training steps",
            ("workflow",)).labels(**lbl)
        self._c_recompiles = reg.counter(
            "veles_training_recompiles_total",
            "JAX jit cache misses observed on the step's functions",
            ("workflow",)).labels(**lbl)
        self._h_phase = reg.histogram(
            "veles_training_step_phase_seconds",
            "Per-step time split: data_wait | host | device",
            ("workflow", "phase"))
        self._h_data = self._h_phase.labels(phase="data_wait", **lbl)
        self._h_host = self._h_phase.labels(phase="host", **lbl)
        self._h_device = self._h_phase.labels(phase="device", **lbl)
        self._h_snapshot = self._h_phase.labels(phase="snapshot", **lbl)
        self._g_rate = reg.gauge(
            "veles_training_examples_per_sec",
            "Sliding-window training throughput",
            ("workflow",)).labels(**lbl)
        self._g_mem = reg.gauge(
            "veles_device_peak_memory_bytes",
            "Per-device HBM peak watermark",
            ("workflow", "device"))
        # per-instance totals for summary() (the registry children are
        # process-global and shared across same-named workflows)
        self.steps = 0
        self.examples = 0
        self.recompiles = 0       # eager PyTorch: nothing recompiles
        self.data_wait_s = 0.0
        self.host_s = 0.0
        self.device_s = 0.0
        self.peak_memory = {}
        self._rate = collections.deque(maxlen=RATE_WINDOW)
        self._pending_data_wait = 0.0
        self._last_served = int(getattr(loader, "samples_served", 0)
                                or 0)
        self._orig_step_run = step.run
        self._orig_loader_run = loader.run if loader is not None else None
        # stable wrapper objects: detach() compares identities
        self._step_wrapper = _transient(self._step_run)
        self._loader_wrapper = _transient(self._loader_run_wrapped)
        step.run = self._step_wrapper
        if loader is not None:
            loader.run = self._loader_wrapper
        # the snapshot capture stall as a slice of its own
        self.snapshotter = getattr(workflow, "snapshotter", None) \
            if workflow is not None else None
        self.snapshot_s = 0.0
        self._orig_snap_run = self._snap_wrapper = None
        if self.snapshotter is not None:
            self._orig_snap_run = self.snapshotter.run
            self._snap_wrapper = _transient(self._snap_run)
            self.snapshotter.run = self._snap_wrapper

    # -- instrumentation -----------------------------------------------------
    def _device(self):
        """The step's :class:`~veles_tpu_torch.backends.Device`."""
        return getattr(self.step, "device", None)

    def _loader_run_wrapped(self):
        t0 = time.perf_counter()
        try:
            return self._orig_loader_run()
        finally:
            # attributed to the NEXT step: the loader prepares the
            # minibatch the step consumes
            self._pending_data_wait += time.perf_counter() - t0

    def _consumed_examples(self):
        ld = self.loader
        if ld is not None and hasattr(ld, "samples_served"):
            served = int(ld.samples_served)
            n, self._last_served = max(0, served - self._last_served), \
                served
            return n
        size = getattr(self.step, "minibatch_size", None)
        return int(size) if size is not None else 0

    def _fence(self):
        """Wait until the step's queued device work is done
        (``torch.cuda.synchronize`` on its card; nothing on the CPU)."""
        device = self._device()
        if device is not None:
            device.sync()

    def _step_run(self):
        data_wait = self._pending_data_wait
        self._pending_data_wait = 0.0
        t0 = time.perf_counter()
        try:
            result = self._orig_step_run()
        except Exception:
            # a crashed step still counts its host time; re-raise
            self.host_s += time.perf_counter() - t0
            raise
        t1 = time.perf_counter()
        if self.fence:
            self._fence()
        t2 = time.perf_counter()
        host, device = t1 - t0, t2 - t1
        n = self._consumed_examples()
        self.steps += 1
        self.examples += n
        self.data_wait_s += data_wait
        self.host_s += host
        self.device_s += device
        self._c_steps.inc()
        if n:
            self._c_examples.inc(n)
        self._h_data.observe(data_wait)
        self._h_host.observe(host)
        self._h_device.observe(device)
        self._rate.append((t2, n))
        if len(self._rate) >= 2:
            span = self._rate[-1][0] - self._rate[0][0]
            if span > 0:
                self._g_rate.set(sum(c for _, c in self._rate) / span)
        if self.steps % MEM_POLL_STEPS == 1:
            self._poll_memory()
        events.span("train.step", data_wait + host + device,
                    workflow=self.name,
                    data_wait_ms=round(data_wait * 1e3, 3),
                    host_ms=round(host * 1e3, 3),
                    device_ms=round(device * 1e3, 3),
                    examples=n, recompiles=0)
        return result

    def _snap_run(self):
        """The snapshotter accounts its own training-thread stall
        (``stall_s``): read the delta, so a call it throttled away adds
        nothing."""
        snap = self.snapshotter
        before = float(getattr(snap, "stall_s", 0.0) or 0.0)
        result = self._orig_snap_run()
        stalled = float(getattr(snap, "stall_s", 0.0) or 0.0) - before
        if stalled > 0:
            self.snapshot_s += stalled
            self._h_snapshot.observe(stalled)
        return result

    def _poll_memory(self):
        """The card's peak allocation (``torch.cuda
        .max_memory_allocated``); the CPU reports none."""
        device = self._device()
        if device is None:
            return
        peak = device.memory_stats().get("peak_bytes_in_use")
        if peak:
            key = str(device.torch_device)
            self.peak_memory[key] = max(self.peak_memory.get(key, 0),
                                        int(peak))
            self._g_mem.labels(workflow=self.name,
                               device=key).set_max(peak)

    # -- lifecycle / reading -------------------------------------------------
    def detach(self):
        """Restore the wrapped run() methods (idempotent; tolerant of
        being attached on top of an earlier profiler: the original
        callable is restored rather than the class default)."""
        for obj, wrapper, orig in (
                (self.step, self._step_wrapper, self._orig_step_run),
                (self.loader, self._loader_wrapper,
                 self._orig_loader_run),
                (self.snapshotter, self._snap_wrapper,
                 self._orig_snap_run)):
            if obj is None:
                continue
            if obj.__dict__.get("run") is wrapper:
                del obj.__dict__["run"]
                if orig is not None and \
                        getattr(orig, "__func__", None) is not \
                        type(obj).run:
                    obj.__dict__["run"] = orig

    def summary(self):
        """Aggregate breakdown for results JSON / humans."""
        self._poll_memory()
        total = self.data_wait_s + self.host_s + self.device_s
        out = {"steps": self.steps, "examples": self.examples,
               "recompiles": self.recompiles,
               "data_wait_s": round(self.data_wait_s, 4),
               "host_s": round(self.host_s, 4),
               "device_s": round(self.device_s, 4)}
        if self.snapshot_s:
            out["snapshot_stall_s"] = round(self.snapshot_s, 4)
        if total > 0:
            out["examples_per_sec"] = round(self.examples / total, 1)
            out["phase_pct"] = {
                "data_wait": round(100 * self.data_wait_s / total, 1),
                "host": round(100 * self.host_s / total, 1),
                "device": round(100 * self.device_s / total, 1)}
            if self.snapshot_s:
                loop = total + self.snapshot_s
                out["phase_pct"]["snapshot"] = round(
                    100 * self.snapshot_s / loop, 1)
        if self.peak_memory:
            out["device_peak_memory_bytes"] = dict(self.peak_memory)
        return out
