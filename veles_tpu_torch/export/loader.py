"""PackageLoader: read a workflow package back and run inference.

The port of ``veles_tpu/export/loader.py``.  It reads ``contents.json``
and the ``.npy`` weights (fp16 promoted to fp32, as the JAX loader and
the native engine's npy reader do) and ``model.json``; the forward
chain is rebuilt from the port's units (:func:`.model.build_forwards`)
once a device, under a lock, where the JAX loader deserializes
``model.stablehlo`` (which the port ignores).  Runs on the card unless
given ``device="cpu"``.

    python -m veles_tpu_torch.export.loader pkg.zip input.npy|random \\
        [out.npy] [--device cpu] [--check-native]
"""

import io
import json
import threading
import zipfile

import numpy
import torch

from ..device import resolve_device
from . import model as _model

__all__ = ["NATIVE_TOL", "PackageLoader", "main"]

#: the runner's hold against the native engine (its naive C++ loops
#: sum in another order)
NATIVE_TOL = 5e-4


class PackageLoader:
    """The read side of :mod:`.packager` and :mod:`.model`."""

    def __init__(self, path):
        self.path = path
        with zipfile.ZipFile(path) as zf:
            self.contents = json.loads(zf.read("contents.json"))
            names = set(zf.namelist())
            self.arrays = {}
            for unit in self.contents["units"]:
                for attr, meta in unit.get("arrays", {}).items():
                    arr = numpy.load(io.BytesIO(zf.read(meta["file"])),
                                     allow_pickle=False)
                    if arr.dtype == numpy.float16:
                        arr = arr.astype(numpy.float32)  # fp16 promote
                    self.arrays.setdefault(unit["name"], {})[attr] = arr
            self.model_metadata = (
                json.loads(zf.read("model.json"))
                if "model.json" in names else None)
        self._built = {}            # (what, device) -> units / params
        self._built_lock = threading.Lock()

    @property
    def workflow_name(self):
        return self.contents["workflow"]

    @property
    def checksum(self):
        return self.contents.get("checksum")

    @property
    def sample_shape(self):
        return tuple(self._metadata()["input"]["sample_shape"])

    @property
    def static_batch(self):
        """The batch a static-batch package takes, or None (any)."""
        batch = self._metadata()["input"]["batch"]
        return None if isinstance(batch, str) else int(batch)

    def _metadata(self):
        if self.model_metadata is None:
            raise ValueError("package has no model.json metadata")
        return self.model_metadata

    def unit_params(self):
        """The parameters in forward order: ``[{name: array}, ...]``."""
        params = []
        for fwd in self._metadata()["forwards"]:
            unit_arrays = self.arrays.get(fwd["unit"], {})
            params.append({name: unit_arrays[name]
                           for name in fwd["params"]})
        return params

    def _once(self, what, device, make):
        key = (what, resolve_device(device))
        # double-checked lock: two concurrent FIRST requests must not
        # both build; the loser reuses the winner's
        built = self._built.get(key)
        if built is None:
            with self._built_lock:
                built = self._built.get(key)
                if built is None:
                    built = self._built[key] = make(key[1])
        return built

    def forwards(self, device=None):
        """The eval-mode forward chain on ``device`` (default: the
        card), built once a device."""
        return self._once("forwards", device, lambda dev: (
            _model.build_forwards(self._metadata(), self.arrays, dev)))

    def params(self, device=None):
        """:meth:`unit_params` as tensors on ``device``, copied once (a
        scheduler keeps its own copy: :meth:`run` alone uses these)."""
        return self._once("params", device, lambda dev: [
            {k: torch.from_numpy(v).to(dev) for k, v in p.items()}
            for p in self.unit_params()])

    def run(self, x, device=None):
        """The package's forward of a batch (any size unless the package
        is static-batch) on ``device`` (default: the card); -> numpy."""
        dev = resolve_device(device)
        units, params = self.forwards(dev), self.params(dev)
        x = numpy.ascontiguousarray(x, numpy.float32)
        batch = self.static_batch
        if batch is not None and x.shape[0] != batch:
            raise ValueError("a static-batch package takes %d rows, given "
                             "%d" % (batch, x.shape[0]))
        with torch.no_grad():
            y = _model.forward_fn(units)(params,
                                         torch.from_numpy(x).to(dev))
            return y.cpu().numpy()


def main(argv=None):
    """``python -m veles_tpu_torch.export.loader pkg.zip input.npy
    [out.npy]``: the minimal runner, on the card unless ``--device
    cpu``."""
    import argparse
    p = argparse.ArgumentParser(prog="veles_tpu_torch.export.loader")
    p.add_argument("package")
    p.add_argument("input", help=".npy batch, or 'random' for a smoke run")
    p.add_argument("output", nargs="?", default=None)
    p.add_argument("--device", default=None,
                   help="the card by default; 'cpu' for the host")
    p.add_argument("--check-native", action="store_true",
                   help="also replay the batch through the native engine "
                        "(native/, built) and fail past 5e-4 of it")
    args = p.parse_args(argv)
    loader = PackageLoader(args.package)
    if args.input == "random":
        meta = loader.model_metadata["input"]
        x = numpy.random.RandomState(0).uniform(
            -1, 1, [loader.static_batch or 2] +
            meta["sample_shape"]).astype(numpy.float32)
    else:
        x = numpy.load(args.input)
    out = loader.run(x, device=args.device)
    print("workflow %r: input %s -> output %s" %
          (loader.workflow_name, x.shape, out.shape))
    if args.output:
        numpy.save(args.output, out)
    if args.check_native:
        from .native import NativeWorkflow
        nat = NativeWorkflow(args.package)
        try:
            diff = float(numpy.abs(nat.run(x) - out).max())
        finally:
            nat.close()
        print("native engine: max |port - native| %.3g (limit %g)"
              % (diff, NATIVE_TOL))
        if not diff <= NATIVE_TOL:
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
