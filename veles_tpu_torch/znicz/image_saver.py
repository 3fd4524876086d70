"""ImageSaver: write each epoch's misclassified validation samples.

The port of ``veles_tpu/znicz/image_saver.py`` (the Znicz image_saver
unit): on each validation minibatch it writes the samples whose argmax
of ``output`` differs from the label to
``directory/epoch_<n>/<true>_as_<predicted>_<i>.png``, at most
``limit`` an epoch, each scaled to 0-255 over its own range as the JAX
unit scales it (``sample_shape`` reshapes a flat row first).

It reads the minibatch the step just ran: the loader's
``materialize_minibatch`` fills the host Arrays of a minibatch the
fused step gathered on the device, and a prefetcher installs each
minibatch's indices into the loader only when the step consumes it.
The PNGs are written by :func:`write_png` (``zlib``, no imaging
library): 8-bit grayscale, or RGB for three channels.

    saver = ImageSaver(wf, directory="out", limit=8, sample_shape=(28, 28))
    saver.link_all(wf.fused_step, wf.loader)
    saver.link_from(wf.fused_step)
"""

import binascii
import os
import struct
import zlib

import numpy

from ..units import Unit
from .. import loader as loader_mod

__all__ = ["ImageSaver", "write_png"]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind, data):
    body = kind + data
    return struct.pack(">I", len(data)) + body + \
        struct.pack(">I", binascii.crc32(body) & 0xFFFFFFFF)


def write_png(path, img8):
    """Write ``img8`` (uint8, ``(h, w)`` grayscale or ``(h, w, 3)`` RGB)
    as a PNG: one IDAT of unfiltered rows."""
    img8 = numpy.ascontiguousarray(img8, numpy.uint8)
    if img8.ndim == 2:
        color = 0
    elif img8.ndim == 3 and img8.shape[2] == 3:
        color = 2
    else:
        raise ValueError("write_png takes (h, w) or (h, w, 3) images, got "
                         "%s" % (img8.shape,))
    h, w = img8.shape[:2]
    rows = img8.reshape(h, -1)
    raw = numpy.zeros((h, rows.shape[1] + 1), numpy.uint8)  # filter 0
    raw[:, 1:] = rows
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                            0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes())))
        f.write(_chunk(b"IEND", b""))


class ImageSaver(Unit):
    """Dumps misclassified validation samples, ``limit`` an epoch
    (``saved`` counts every file written)."""

    MAPPING = "image_saver"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.view_group = "SERVICE"
        self.directory = kwargs.get("directory", "image_saver")
        self.limit = int(kwargs.get("limit", 32))      # per epoch
        self.sample_shape = kwargs.get("sample_shape")  # e.g. (28, 28)
        self.minibatch_data = None   # linked from the loader
        self.minibatch_labels = None
        self.minibatch_size = None
        self.minibatch_class = None
        self.epoch_number = None
        self.output = None           # linked from the step or evaluator
        self.saved = 0
        self._epoch_saved = 0
        self._seen_epoch = -1

    def link_all(self, trainer, loader):
        self.loader = loader
        self.link_attrs(trainer, "output")
        self.link_attrs(loader, "minibatch_data", "minibatch_labels",
                        "minibatch_size", "minibatch_class",
                        "epoch_number")
        return self

    def run(self):
        if self.minibatch_class != loader_mod.VALID:
            return
        epoch = int(self.epoch_number)
        if epoch != self._seen_epoch:
            self._seen_epoch = epoch
            self._epoch_saved = 0
        if self._epoch_saved >= self.limit:
            return  # full: no host gather
        self.loader.materialize_minibatch()
        size = int(self.minibatch_size)
        out = numpy.asarray(self.output.map_read()
                            if hasattr(self.output, "map_read")
                            else self.output)[:size]
        labels = numpy.asarray(self.minibatch_labels.map_read()[:size])
        data = numpy.asarray(self.minibatch_data.map_read()[:size])
        pred = out.argmax(axis=-1)
        wrong = numpy.nonzero(pred != labels)[0]
        if not len(wrong):
            return
        epoch_dir = os.path.join(self.directory, "epoch_%d" % epoch)
        os.makedirs(epoch_dir, exist_ok=True)
        for i in wrong:
            if self._epoch_saved >= self.limit:
                break
            img = data[i]
            if self.sample_shape is not None:
                img = img.reshape(self.sample_shape)
            lo, hi = img.min(), img.max()
            img8 = ((img - lo) / (hi - lo + 1e-12) * 255).astype("uint8")
            if img8.ndim == 3 and img8.shape[-1] == 1:
                img8 = img8[..., 0]
            write_png(os.path.join(epoch_dir, "%s_as_%s_%d.png" % (
                labels[i], pred[i], self._epoch_saved)), img8)
            self._epoch_saved += 1
            self.saved += 1
