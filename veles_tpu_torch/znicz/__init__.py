"""Neural-network functions and units of the port (the counterpart of
``veles_tpu.znicz``): the unit engine's layers (all2all, conv, pooling,
LRN, dropout, activation units, multi-head attention) with their
gradient-descent units, solvers, evaluator, decision and fused train
step; ``StandardWorkflow``; the kernel modules (paged attention, the
quantized and compensated GEMMs, flash attention, LRN); and the
samples."""
