"""Array: host numpy storage paired with a device ``torch.Tensor``.

The port's counterpart of ``veles_tpu/memory.py`` (a re-design of the
reference's Array, veles/memory.py:110-511, and its Watcher
device-memory accounting, :56-107).  The same validity protocol:

- ``map_read``   — make the host copy current (device→host only if stale);
- ``map_write``  — make host current and mark it dirty;
- ``map_invalidate`` — mark host dirty *without* a device pull (host will be
  fully overwritten — reference memory.py:137 fast path);
- ``unmap``      — if host is dirty, push it to the device.

Mutating through ``arr.mem[...]`` between map_write/unmap is exactly the
reference idiom (memory.py:137-141).  Device values are created lazily on
first ``devmem`` access, on the device given to :meth:`Array.initialize`.
The two copies never share storage (an upload copies, a download
copies), even on the CPU backend, where ``torch.from_numpy`` would
alias them: the port updates some device tensors in place.
"""

import threading

import numpy
import torch

from .pickling import Pickleable

__all__ = ["Array", "Watcher"]


class Watcher:
    """Process-wide device-memory accounting (reference memory.py:56-107):
    bytes of live Array devmems."""

    _lock = threading.RLock()  # reentrant: Array.__del__ may fire mid-GC
    #                            inside add/remove on the same thread
    bytes_in_use = 0
    peak_bytes = 0

    @classmethod
    def add(cls, nbytes):
        with cls._lock:
            cls.bytes_in_use += nbytes
            cls.peak_bytes = max(cls.peak_bytes, cls.bytes_in_use)

    @classmethod
    def remove(cls, nbytes):
        with cls._lock:
            cls.bytes_in_use -= nbytes

    @classmethod
    def reset(cls):
        with cls._lock:
            cls.bytes_in_use = 0
            cls.peak_bytes = 0


def _torch_device(device):
    """A backends.Device, a torch.device or a name -> torch.device."""
    dev = getattr(device, "torch_device", device)
    return torch.device(dev)


class Array(Pickleable):
    """Host numpy array + device tensor with validity tracking."""

    def __init__(self, data=None, shallow_pickle=False):
        super().__init__()
        self._mem = None
        self.shallow_pickle = shallow_pickle
        if data is not None:
            self.mem = data

    def init_unpickled(self):
        super().init_unpickled()
        self._devmem_ = None
        self._device_ = None
        self._host_dirty_ = True
        self._device_dirty_ = False
        self._accounted_ = 0

    def initialize(self, device):
        """Place future uploads on ``device`` (a backends.Device, a
        torch.device or a name); a device value elsewhere moves there."""
        dev = _torch_device(device)
        if self._devmem_ is not None and self._devmem_.device != dev:
            self.map_read()
            self._release_devmem()
            self._host_dirty_ = True
        self._device_ = dev
        return self

    @property
    def device(self):
        return self._device_

    # -- host side -----------------------------------------------------------
    @property
    def mem(self):
        return self._mem

    @mem.setter
    def mem(self, value):
        if value is None:
            self.reset()
            return
        self._mem = numpy.asarray(value)
        self._host_dirty_ = True
        self._device_dirty_ = False

    def reset(self, new_mem=None):
        """Drop both copies (reference memory.py:331)."""
        self._release_devmem()
        self._mem = new_mem
        self._host_dirty_ = new_mem is not None
        self._device_dirty_ = False

    def __bool__(self):
        return self._mem is not None or self._devmem_ is not None

    def _current(self):
        return self._mem if self._mem is not None else self._devmem_

    @property
    def shape(self):
        m = self._current()
        return tuple(m.shape) if m is not None else ()

    @property
    def dtype(self):
        if self._mem is not None:
            return self._mem.dtype
        return self._devmem_.dtype if self._devmem_ is not None else None

    @property
    def size(self):
        m = self._current()
        return int(numpy.prod(m.shape)) if m is not None else 0

    @property
    def nbytes(self):
        if self._mem is not None:
            return self._mem.nbytes
        return _tensor_bytes(self._devmem_)

    @property
    def sample_size(self):
        """Elements per leading-axis sample (reference memory.py)."""
        if not self.shape:
            return 0
        return self.size // self.shape[0]

    def __len__(self):
        return self.shape[0] if self.shape else 0

    def __getitem__(self, idx):
        self.map_read()
        return self._mem[idx]

    def __setitem__(self, idx, value):
        self.map_write()
        self._mem[idx] = value

    # -- map/unmap protocol --------------------------------------------------
    def map_read(self):
        if self._device_dirty_ and self._devmem_ is not None:
            self._mem = self._devmem_.detach().to(
                "cpu", copy=True).numpy()
            self._device_dirty_ = False
        return self._mem

    def map_write(self):
        self.map_read()
        self._host_dirty_ = True
        return self._mem

    def map_invalidate(self):
        if self._mem is None and self._devmem_ is not None:
            # need a host buffer of the right shape, contents irrelevant
            self._mem = numpy.empty(
                tuple(self._devmem_.shape),
                torch.empty((), dtype=self._devmem_.dtype).numpy().dtype)
        self._host_dirty_ = True
        self._device_dirty_ = False
        return self._mem

    def unmap(self):
        if self._host_dirty_ and self._mem is not None:
            self._upload()
        return self

    # -- device side ---------------------------------------------------------
    @property
    def devmem(self):
        """The device tensor (uploads lazily if the host copy is newer)."""
        if self._host_dirty_ or self._devmem_ is None:
            if self._mem is None:
                return None
            self._upload()
        return self._devmem_

    @devmem.setter
    def devmem(self, value):
        """Accept a fresh device value (the output of a step); the host
        copy becomes stale until map_read."""
        self._release_devmem()
        self._devmem_ = value
        if value is not None:
            self._device_ = value.device
            self._account(value)
            self._device_dirty_ = True
            self._host_dirty_ = False

    def _upload(self):
        if self._device_ is None:
            raise RuntimeError(
                "%r has no device: call initialize(device) before reading "
                "devmem" % self)
        self._release_devmem()
        self._devmem_ = torch.tensor(self._mem, device=self._device_)
        self._account(self._devmem_)
        self._host_dirty_ = False
        self._device_dirty_ = False

    def _account(self, value):
        self._accounted_ = _tensor_bytes(value)
        Watcher.add(self._accounted_)

    def _release_devmem(self):
        if self._devmem_ is not None:
            Watcher.remove(self._accounted_)
            self._accounted_ = 0
            self._devmem_ = None

    def __del__(self):
        try:
            self._release_devmem()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    # -- pickling ------------------------------------------------------------
    def __getstate__(self):
        """Device values are pulled to host before pickling (reference
        memory.py:284-299); shallow_pickle drops the payload for huge
        datasets.  Inside a checkpoint extraction context
        (checkpoint/tensors.py) a large payload is diverted into the sink
        instead: the device-current tensor (copied to the host once, by
        the sink) or the host array."""
        from .checkpoint.tensors import TensorStub, active_sink
        sink = active_sink()
        if sink is not None and not self.shallow_pickle:
            if self._device_dirty_ and self._devmem_ is not None:
                payload = self._devmem_
            else:
                payload = self._mem
            if isinstance(payload, torch.Tensor):
                nbytes = _tensor_bytes(payload)
            else:        # None or a stub: nothing to divert
                nbytes = getattr(payload, "nbytes", None)
            if nbytes is not None and nbytes >= sink.min_bytes:
                state = super().__getstate__()
                state["_mem"] = TensorStub(sink.add(payload, copy=True))
                return state
        self.map_read()
        state = super().__getstate__()
        if self.shallow_pickle:
            state["_mem"] = None
        return state

    def __repr__(self):
        return "<Array %s %s host_dirty=%s device=%s>" % (
            self.shape, self.dtype, self._host_dirty_,
            None if self._devmem_ is None else self._devmem_.device)


def _tensor_bytes(t):
    return 0 if t is None else t.numel() * t.element_size()
