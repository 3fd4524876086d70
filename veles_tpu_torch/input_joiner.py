"""InputJoiner: concatenate N input Arrays along the feature axis.

The port's counterpart of ``veles_tpu/input_joiner.py`` (the
reference's veles/input_joiner.py:49 with its templated ``join``
kernel): each input flattened to ``[rows, features]``, then one
``torch.cat`` on the inputs' device.  The JAX unit's ``make_trace``
belongs to the graph compiler (ROADMAP queue A item 9).
"""

import numpy
import torch

from .backends import Device
from .memory import Array
from .units import Unit

__all__ = ["InputJoiner"]


class InputJoiner(Unit):
    """``output = concat(inputs..., axis=-1)`` on the device.

    Link inputs with ``link_inputs((unit_a, "output"), (unit_b,
    "output"))`` or assign ``input_<i>`` attributes directly (and set
    ``num_inputs``)."""

    MAPPING = "input_joiner"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.output = Array()
        self.num_inputs = 0
        self.device = None

    def link_inputs(self, *unit_attr_pairs):
        """(unit, attr) pairs in join order."""
        for unit, attr in unit_attr_pairs:
            name = "input_%d" % self.num_inputs
            self.link_attrs(unit, (name, attr))
            self.num_inputs += 1
        return self

    def initialize(self, device=None, **kwargs):
        """Place the output on ``device`` (default ``Device()``, the
        card) and preallocate it where the inputs' shapes are known, so
        downstream units can size themselves (the ForwardBase
        convention): the first input's rows, the sum of the flattened
        feature widths."""
        super().initialize(**kwargs)
        self.device = device if device is not None else Device()
        shapes = []
        for i in range(self.num_inputs):
            v = getattr(self, "input_%d" % i)
            shape = v.shape if isinstance(v, Array) else numpy.shape(v)
            if not shape:
                shapes = None
                break
            shapes.append(shape)
        if shapes and not self.output:
            width = sum(int(numpy.prod(s[1:])) for s in shapes)
            self.output.reset(numpy.zeros((shapes[0][0], width),
                                          numpy.float32))
        self.output.initialize(self.device)
        for i in range(self.num_inputs):
            v = getattr(self, "input_%d" % i)
            if isinstance(v, Array) and v.device is None:
                v.initialize(self.device)   # a host-made input

    def _value(self, i):
        v = getattr(self, "input_%d" % i)
        if isinstance(v, Array):
            return v.devmem
        return torch.as_tensor(v, device=self.device.torch_device)

    def run(self):
        flat = [x.reshape(x.shape[0], -1)
                for x in (self._value(i) for i in range(self.num_inputs))]
        self.output.devmem = torch.cat(flat, dim=-1)
