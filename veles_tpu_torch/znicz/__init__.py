"""Neural-network functions and units of the port (the counterpart of
``veles_tpu.znicz``): the unit engine's layers (all2all, conv, pooling,
LRN, dropout, activation units, multi-head attention, and the
structural units of ``misc_units``, whose classes this package exports
as the JAX one does) with their gradient-descent units, solvers,
evaluator, decision and fused train step; ``StandardWorkflow``; the
kernel modules (paged attention, the quantized and compensated GEMMs,
flash attention, LRN); and the samples."""

from .misc_units import (Cutter, GDCutter, ChannelSplitter,  # noqa: F401
                         ChannelMerger, ZeroFiller, Deconv, GDDeconv,
                         Depooling)
