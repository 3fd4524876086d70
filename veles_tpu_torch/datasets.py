"""Dataset acquisition helpers: the digits the MNIST sample trains on.

The port's copy of the digits half of ``veles_tpu/datasets.py``: the
first two tiers of its source, in provenance order:

1. ``"real"``: true MNIST IDX files under
   ``root.common.dirs.datasets/mnist``;
2. ``"fixture"``: the gz-IDX archives committed with the JAX package
   (``veles_tpu/fixtures/digits``, 12000 train and 2000 validation
   28x28 images), read IN PLACE by path from the checkout;
   ``$VELES_TPU_FIXTURES`` overrides the directory.

The JAX package's third tier, a synthetic twin generated in-process,
is not ported: a checkout always has the fixture.

Nothing here imports ``veles_tpu``: the fixture is a directory of data
files, found relative to this package.
"""

import gzip
import os
import struct

import numpy

from .config import root

__all__ = ["fixture_dir", "load_digits_idx"]

_IDX_NAMES = ["train-images-idx3-ubyte", "train-labels-idx1-ubyte",
              "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"]


def _dataset_dir():
    return os.path.expanduser(
        root.common.dirs.get("datasets", "~/.veles_tpu/datasets"))


def fixture_dir():
    """The committed IDX digits fixture beside this package, in the JAX
    package's directory tree (``veles_tpu/fixtures/digits``); override
    with ``$VELES_TPU_FIXTURES``."""
    env = os.environ.get("VELES_TPU_FIXTURES")
    return env or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "veles_tpu", "fixtures", "digits")


def _read_idx(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dtype = {0x08: numpy.uint8, 0x09: numpy.int8, 0x0B: numpy.int16,
                 0x0C: numpy.int32, 0x0D: numpy.float32,
                 0x0E: numpy.float64}[(magic >> 8) & 0xFF]
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = numpy.frombuffer(f.read(),
                                numpy.dtype(dtype).newbyteorder(">"))
        return data.reshape(shape).astype(dtype)


def _find_idx(d):
    paths = []
    for n in _IDX_NAMES:
        for cand in (os.path.join(d, n), os.path.join(d, n + ".gz")):
            if os.path.exists(cand):
                paths.append(cand)
                break
    return paths if len(paths) == 4 else None


def load_digits_idx(n_train=None, n_valid=None, fixture=True):
    """((train_images, train_labels), (valid_images, valid_labels),
    provenance) from the first tier that has all four files (module
    docstring); ``n_train`` / ``n_valid`` cut each split to its first
    rows (None keeps all).  ``fixture=False`` skips tier 2.  Raises
    FileNotFoundError when no tier has them."""
    tiers = [(os.path.join(_dataset_dir(), "mnist"), "real")]
    if fixture:
        tiers.append((fixture_dir(), "fixture"))
    for d, provenance in tiers:
        paths = _find_idx(d)
        if paths:
            ti, tl, vi, vl = (_read_idx(p) for p in paths)
            return ((ti[:n_train], tl[:n_train].astype(numpy.int32)),
                    (vi[:n_valid], vl[:n_valid].astype(numpy.int32)),
                    provenance)
    raise FileNotFoundError("no MNIST IDX files in %s"
                            % " or ".join(d for d, _ in tiers))
