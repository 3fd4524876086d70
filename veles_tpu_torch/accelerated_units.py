"""Accelerated units: graph nodes whose compute runs on a Device.

The port's counterpart of ``veles_tpu/accelerated_units.py`` (a re-design
of the reference's AcceleratedUnit, veles/accelerated_units.py:130).
The JAX package jits a pure ``kernel`` per unit; PyTorch runs eagerly,
so here ``kernel`` is called as it is, on the tensors of the unit's
device.  A unit initialized without a device takes ``Device()``, which
is the card and raises without one.
"""

from .backends import Device
from .config import root
from .memory import Array
from .units import Unit

__all__ = ["AcceleratedUnit"]


class AcceleratedUnit(Unit):
    """A unit whose work is a function of device tensors.

    Subclasses implement ``kernel(self, *tensors) -> tensors`` (or
    override ``run``) and declare their I/O with
    ``self.device_inputs = ["input", ...]`` and
    ``self.device_outputs = ["output", ...]`` (attribute names holding
    :class:`~veles_tpu_torch.memory.Array`).
    """

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.device = None
        self.device_inputs = []
        self.device_outputs = []

    def initialize(self, device=None, **kwargs):
        super().initialize(**kwargs)
        if device is None:
            device = Device()
        self.device = device
        for name in self.device_inputs + self.device_outputs:
            arr = getattr(self, name)
            if isinstance(arr, Array):
                arr.initialize(device)

    def kernel(self, *tensors):  # pragma: no cover - interface doc
        raise NotImplementedError

    def run(self):
        """Gather declared inputs, run ``kernel``, store the outputs."""
        ins = []
        for name in self.device_inputs:
            arr = getattr(self, name)
            ins.append(arr.devmem if isinstance(arr, Array) else arr)
        outs = self.kernel(*ins)
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        if len(outs) != len(self.device_outputs):
            raise ValueError(
                "%s.kernel returned %d outputs but device_outputs declares "
                "%d" % (type(self).__name__, len(outs),
                        len(self.device_outputs)))
        for name, val in zip(self.device_outputs, outs):
            arr = getattr(self, name)
            if isinstance(arr, Array):
                arr.devmem = val
            else:
                setattr(self, name, val)
        if bool(root.common.engine.get("sync_run", False)):
            self.device.sync()
