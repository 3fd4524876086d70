"""Gradient units for pooling layers.

The port's counterpart of ``veles_tpu/znicz/gd_pooling.py``:
GDMaxPooling (the error goes to the argmax element), GDAvgPooling
(spread over the window), GDMaxAbsPooling, and GDStochasticPooling /
GDStochasticAbsPooling (the error goes to the element the forward
drew).  All are paramless; the error routing is the vjp of the forward,
in graph mode as in the fused step.
"""

from .nn_units import GenericVJPBackward

__all__ = ["GDPoolingBase", "GDMaxPooling", "GDAvgPooling",
           "GDMaxAbsPooling", "GDStochasticPooling",
           "GDStochasticAbsPooling"]


class GDPoolingBase(GenericVJPBackward):
    hide_from_registry = True


class GDMaxPooling(GDPoolingBase):
    MAPPING = "max_pooling"


class GDAvgPooling(GDPoolingBase):
    MAPPING = "avg_pooling"


class GDMaxAbsPooling(GDPoolingBase):
    MAPPING = "maxabs_pooling"


class GDStochasticPooling(GDPoolingBase):
    """The backward through the same draw the forward made: its kept
    train graph, or ``apply_train`` again with its ``last_key``; a
    forward that has drawn no key yet goes through the eval ``apply``."""

    MAPPING = "stochastic_pooling"
    VJP_OF_DRAW = True


class GDStochasticAbsPooling(GDStochasticPooling):
    MAPPING = "stochastic_abs_pooling"
