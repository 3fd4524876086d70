"""Gradient units for pooling layers.

The port's counterpart of ``veles_tpu/znicz/gd_pooling.py``:
GDMaxPooling (the error goes to the argmax element), GDAvgPooling
(spread over the window) and GDMaxAbsPooling.  All are paramless; the
error routing is the vjp of the forward.
"""

from .nn_units import GenericVJPBackward

__all__ = ["GDPoolingBase", "GDMaxPooling", "GDAvgPooling",
           "GDMaxAbsPooling"]


class GDPoolingBase(GenericVJPBackward):
    hide_from_registry = True


class GDMaxPooling(GDPoolingBase):
    MAPPING = "max_pooling"


class GDAvgPooling(GDPoolingBase):
    MAPPING = "avg_pooling"


class GDMaxAbsPooling(GDPoolingBase):
    MAPPING = "maxabs_pooling"
