"""Device backends: the layer that binds the unit graph to hardware.

The port's counterpart of ``veles_tpu/backends.py`` (a re-design of the
reference's Device base + BackendRegistry, veles/backends.py:166-197).
A Device owns one ``torch.device``; units read it from the Device they
are initialized with and put their tensors there.

Backend names: ``cuda`` (the card), ``cpu`` (the explicit host backend
the tests use; kernels take their plain PyTorch versions there) and
``auto``, which means ``cuda``: with no card visible it raises instead
of running on the host (:func:`.device.resolve_device`).  Selection
precedence mirrors the reference (veles/backends.py:184-197): explicit
name > ``$VELES_BACKEND`` > ``root.common.engine.backend``.

f32 stays IEEE f32 on the card (TF32 off), so the JAX package's
``precision_level`` knob, which chose the TPU's bf16 pass count, has no
counterpart here.  There is no numpy pseudo-device yet.
"""

import os

import torch

from .config import root
from .device import resolve_device

__all__ = ["BackendRegistry", "Device", "CUDADevice", "CPUDevice"]


class BackendRegistry(type):
    """Metaclass registering Device subclasses by their ``BACKEND`` name
    (reference backends.py:166-181)."""

    backends = {}

    def __init__(cls, name, bases, clsdict):
        super().__init__(name, bases, clsdict)
        backend = clsdict.get("BACKEND")
        if backend is not None:
            BackendRegistry.backends[backend] = cls


class Device(metaclass=BackendRegistry):
    """Base device.  ``Device(backend="cuda")`` dispatches to the
    registered subclass the way the reference's ``__new__`` does
    (backends.py:190-197); ``Device()`` means the card."""

    BACKEND = None

    def __new__(cls, *args, **kwargs):
        if cls is not Device:
            return super().__new__(cls)
        backend = kwargs.get("backend") or os.environ.get(
            "VELES_BACKEND", root.common.engine.get("backend", "auto"))
        if backend == "auto":
            backend = "cuda"
        try:
            impl = BackendRegistry.backends[backend]
        except KeyError:
            raise ValueError(
                "unknown backend %r (have: %s)" %
                (backend, ", ".join(sorted(BackendRegistry.backends))))
        return super().__new__(impl)

    def __init__(self, **kwargs):
        self.torch_device = resolve_device(self.BACKEND)

    # Devices ride along in pickles only as stubs: a restored workflow is
    # re-attached to a fresh Device by initialize(device=...)
    def __getstate__(self):
        return {}

    def __setstate__(self, state):
        self.torch_device = None

    @property
    def backend_name(self):
        return self.BACKEND

    @property
    def exists(self):
        return True

    def __repr__(self):
        return "<%s %s>" % (type(self).__name__, self.torch_device)

    def sync(self):
        """Barrier until all queued work on the device completes."""

    def memory_stats(self):
        """Bytes in use and their peak on the device, where known."""
        return {}


class CUDADevice(Device):
    """The card.  Refuses to exist where torch sees no CUDA device: an
    explicit or default request for the card never degrades to the host
    (the reference raises on a missing CUDA device, backends.py:452-467)."""

    BACKEND = "cuda"

    def sync(self):
        torch.cuda.synchronize(self.torch_device)

    def memory_stats(self):
        return {"bytes_in_use":
                torch.cuda.memory_allocated(self.torch_device),
                "peak_bytes_in_use":
                torch.cuda.max_memory_allocated(self.torch_device)}


class CPUDevice(Device):
    """The host, asked for explicitly (``backend="cpu"``): the tests'
    backend, where every kernel wrapper runs its plain version."""

    BACKEND = "cpu"
