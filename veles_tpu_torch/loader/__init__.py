"""Data layer: minibatch loaders (the port's counterpart of
``veles_tpu.loader``; reference veles/loader/, base protocol at
base.py:100-120).  The other loaders of the JAX package wait for the
slices that use them."""

from .base import (Loader, LoaderError, TEST, VALID, TRAIN, CLASS_NAME,
                   TRIAGE)                                  # noqa: F401
from .fullbatch import FullBatchLoader, FullBatchLoaderMSE  # noqa: F401
