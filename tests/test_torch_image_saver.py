"""The image saver, the port against the JAX package, on the CPU.

- Both units fed the same ``output`` and minibatch (grayscale rows
  reshaped to 28x28, 8x8x1 images, 8x8x3 RGB images; a ``limit`` that
  cuts the epoch; a second epoch; a train minibatch, which writes
  nothing): the same file names, and the port's PNGs decode (Pillow, in
  this test only) to the JAX unit's pixels, exactly.
- ``write_png`` decodes with ``chip_smoke.read_png`` (the standard
  library) to the bytes it was given; it refuses a 4-channel image.
- tests/test_znicz_extra.py's ``test_image_saver`` on the port (MNIST
  300 + 100, 3 epochs, ``limit`` 8): files written, one each save, not
  blank, each PNG the minibatch row its name gives.
- The same run at ``prefetch_depth`` 0 and 2: the same file names and
  the same PNG bytes (the saver reads the minibatch the step ran, not
  one the prefetcher staged ahead).
- No module of the port imports PIL (also in tests/test_torch_imports.py).
"""

import os

import numpy
import pytest

from _chip_smoke_shared import chip_smoke
from _control_shared import mnist_control

read_png = chip_smoke.read_png


def _files(directory):
    found = {}
    for top, _, names in os.walk(directory):
        for name in names:
            path = os.path.join(top, name)
            found[os.path.relpath(path, directory)] = path
    return found


class _Loader:
    """What the units ask of a loader: ``materialize_minibatch``."""

    def materialize_minibatch(self):
        pass


def _feed(pkg, directory, batches, **kwargs):
    """A standalone ``ImageSaver`` of ``pkg`` run over ``batches`` of
    (class, epoch, data, labels, output)."""
    import importlib
    memory = importlib.import_module(pkg + ".memory")
    workflow = importlib.import_module(pkg + ".workflow")
    saver_mod = importlib.import_module(pkg + ".znicz.image_saver")
    saver = saver_mod.ImageSaver(workflow.Workflow(name="w"),
                                 directory=str(directory), **kwargs)
    saver.loader = _Loader()
    for cls, epoch, data, labels, out in batches:
        saver.minibatch_class = cls
        saver.epoch_number = epoch
        saver.minibatch_size = len(labels)
        saver.minibatch_data = memory.Array(data)
        saver.minibatch_labels = memory.Array(labels)
        saver.output = memory.Array(out)
        saver.run()
    return saver


SHAPES = {"gray 28x28": ((784,), (28, 28)), "8x8x1": ((8, 8, 1), None),
          "rgb 8x8x3": ((8, 8, 3), None)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_saver_matches_jax(tmp_path, shape):
    from PIL import Image
    row_shape, sample_shape = SHAPES[shape]
    rng = numpy.random.RandomState(7)
    batches = []
    for cls, epoch in ((1, 0), (1, 0), (2, 0), (1, 1)):
        n = 12
        data = rng.uniform(-1, 3, (n,) + row_shape).astype(numpy.float32)
        data[0] = 0.5          # a flat image: scaled by 1e-12
        labels = rng.randint(0, 4, n).astype(numpy.int32)
        out = rng.uniform(0, 1, (n, 4)).astype(numpy.float32)
        batches.append((cls, epoch, data, labels, out))
    kwargs = {"limit": 10}
    if sample_shape is not None:
        kwargs["sample_shape"] = sample_shape
    ref = _feed("veles_tpu", tmp_path / "jax", batches, **kwargs)
    port = _feed("veles_tpu_torch", tmp_path / "port", batches, **kwargs)
    assert port.saved == ref.saved
    # the first epoch stops at the limit; the train minibatch writes none
    assert port.saved == 10 + min(10, sum(
        int((b[4].argmax(-1) != b[3]).sum()) for b in batches[3:]))
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(got) == sorted(want) and len(got) == port.saved
    for name in want:
        pixels = numpy.asarray(Image.open(want[name]))
        assert numpy.asarray(Image.open(got[name])).tobytes() == \
            pixels.tobytes(), name
        decoded = read_png(got[name])
        assert decoded.shape == pixels.shape
        assert decoded.tobytes() == pixels.tobytes(), name


def test_write_png_round_trips(tmp_path):
    from veles_tpu_torch.znicz.image_saver import write_png
    rng = numpy.random.RandomState(3)
    for shape in ((5, 7), (6, 4, 3), (1, 1)):
        img = rng.randint(0, 256, shape).astype(numpy.uint8)
        path = str(tmp_path / ("%d.png" % len(shape)))
        write_png(path, img)
        assert read_png(path).tobytes() == img.tobytes()
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "x.png"), numpy.zeros((4, 4, 4),
                                                       numpy.uint8))


def _saver_run(directory, depth, epochs=3):
    from veles_tpu_torch.znicz.image_saver import ImageSaver
    wf, _, _ = mnist_control("veles_tpu_torch", epochs,
                             loader={"minibatch_size": 100,
                                     "prefetch_depth": depth})
    saver = ImageSaver(wf, directory=str(directory), limit=8,
                       sample_shape=(28, 28))
    saver.link_all(wf.fused_step, wf.loader)
    saver.link_from(wf.fused_step)
    wf.run()
    assert (wf.loader.prefetcher_ is None) == (depth == 0)
    return wf, saver


def test_image_saver_on_mnist(tmp_path):
    """tests/test_znicz_extra.py::test_image_saver on the port, and each
    PNG the minibatch row it names: the data row at its index, scaled as
    the unit scales, and a label that is that row's."""
    wf, saver = _saver_run(tmp_path, 0)
    assert saver.saved > 0
    files = _files(str(tmp_path))
    assert len(files) == saver.saved
    img = read_png(next(iter(files.values())))
    assert img.std() > 0, "saved image is blank"
    data = wf.loader.original_data.map_read()
    labels = wf.loader._dense_labels
    valid = wf.loader.class_lengths[1]
    for name, path in files.items():
        true, pred = os.path.basename(name).split("_as_")
        got = read_png(path)
        assert got.shape == (28, 28)
        assert int(pred.split("_")[0]) != int(true)
        # a validation row of this label scales to these pixels
        match = []
        for i in numpy.flatnonzero(labels[:valid] == int(true)):
            row = data[i].reshape(28, 28)
            lo, hi = row.min(), row.max()
            want = ((row - lo) / (hi - lo + 1e-12) * 255).astype("uint8")
            if want.tobytes() == got.tobytes():
                match.append(i)
        assert match, name
    per_epoch = {}
    for name in files:
        per_epoch.setdefault(name.split(os.sep)[0], []).append(name)
    assert all(len(v) <= 8 for v in per_epoch.values())


def test_prefetch_depth_writes_the_same_pngs(tmp_path):
    _, sync = _saver_run(tmp_path / "d0", 0)
    _, ahead = _saver_run(tmp_path / "d2", 2)
    a, b = _files(str(tmp_path / "d0")), _files(str(tmp_path / "d2"))
    assert sync.saved == ahead.saved == len(a) > 0
    assert sorted(a) == sorted(b)
    for name in a:
        with open(a[name], "rb") as f, open(b[name], "rb") as g:
            assert f.read() == g.read(), name
