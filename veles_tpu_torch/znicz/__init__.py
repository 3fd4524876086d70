"""Neural-network functions and units of the port (the counterpart of
``veles_tpu.znicz``): the unit engine's layers (all2all, conv, pooling,
LRN, dropout, activation units, multi-head attention, and the
structural units of ``misc_units``, whose classes this package exports
as the JAX one does) with their gradient-descent units, solvers,
evaluator, decision and fused train step; ``ResizableAll2All``; the
recurrent units (SimpleRNN, LSTM) with their BPTT units; the training
paths without gradients, the Kohonen map and the CD-1 RBM;
the training-control units (``LearningRateAdjuster``,
``WeightsRollback``, ``ImageSaver``); ``StandardWorkflow`` and its
MCDNN string notation; the kernel modules (paged attention, the
quantized and compensated GEMMs, flash attention, LRN); and the
samples."""

from .all2all import ResizableAll2All  # noqa: F401
from .misc_units import (Cutter, GDCutter, ChannelSplitter,  # noqa: F401
                         ChannelMerger, ZeroFiller, Deconv, GDDeconv,
                         Depooling)
from . import (image_saver, kohonen, lr_adjust, rbm,  # noqa: F401,E402
               rnn, rollback)
