"""Data layer: minibatch loaders (the port's counterpart of
``veles_tpu.loader``; reference veles/loader/, base protocol at
base.py:100-120): the in-memory ``FullBatchLoader`` family and the
on-disk ``ShardedBatchLoader``, and the ``MinibatchPrefetcher`` that
serves either ahead of the training step.  The other loaders of the JAX
package wait for the slices that use them (ROADMAP queue A item 11)."""

from .base import (Loader, LoaderError, TEST, VALID, TRAIN, CLASS_NAME,
                   TRIAGE)                                  # noqa: F401
from .fullbatch import FullBatchLoader, FullBatchLoaderMSE  # noqa: F401
from .shards import ShardedBatchLoader, write_shards        # noqa: F401
from .prefetch import MinibatchPrefetcher, PrefetchError    # noqa: F401
