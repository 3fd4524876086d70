"""ctypes binding to the native C++ inference engine (native/).

The port's own copy of ``veles_tpu/export/native.py`` (the port imports
nothing of the JAX package).  Host only: no torch on its path.  The
engine is shared by both packages and reads the package zip either
writes.  The binding surface is a flat C ABI (native/src/capi.cc)
loaded via ctypes.  Build first::

    cmake -S native -B native/build -G Ninja && cmake --build native/build
"""

import ctypes
import os

import numpy

_LIB_CANDIDATES = (
    # explicit override first: a pip-installed package (site-packages)
    # has no source tree to search relative to — deploy/Dockerfile sets
    # this to its own build output
    os.environ.get("VELES_NATIVE_LIB"),
    os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        "native", "build", "libveles_native.so"),
)


def _find_library(path=None):
    candidates = (path,) if path else _LIB_CANDIDATES
    for cand in candidates:
        if cand and os.path.exists(cand):
            return cand
    return None


def available(path=None):
    return _find_library(path) is not None


class NativeWorkflow:
    """A package loaded into the native engine."""

    def __init__(self, package_path, library_path=None):
        lib_path = _find_library(library_path)
        if lib_path is None:
            raise FileNotFoundError(
                "libveles_native.so not built (cmake -S native -B "
                "native/build && cmake --build native/build)")
        lib = ctypes.CDLL(lib_path)
        lib.veles_load.restype = ctypes.c_void_p
        lib.veles_load.argtypes = [ctypes.c_char_p]
        lib.veles_run.restype = ctypes.c_long
        lib.veles_run.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_long, ctypes.POINTER(ctypes.c_long), ctypes.c_long,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long)]
        lib.veles_last_error.restype = ctypes.c_char_p
        lib.veles_workflow_name.restype = ctypes.c_char_p
        lib.veles_workflow_name.argtypes = [ctypes.c_void_p]
        lib.veles_free.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._handle = lib.veles_load(package_path.encode())
        if not self._handle:
            raise RuntimeError("native load failed: %s" %
                               lib.veles_last_error().decode())

    @property
    def name(self):
        return self._lib.veles_workflow_name(self._handle).decode()

    def run(self, x, out_capacity=None):
        """Forward the [batch, ...sample] float32 batch natively."""
        x = numpy.ascontiguousarray(x, numpy.float32)
        batch = x.shape[0]
        sample_shape = (ctypes.c_long * (x.ndim - 1))(*x.shape[1:])
        if out_capacity is None:
            out_capacity = max(4 * x.size, 1 << 20)
        out = numpy.empty(out_capacity, numpy.float32)
        out_shape = (ctypes.c_long * 8)()
        out_rank = ctypes.c_long()
        n = self._lib.veles_run(
            self._handle,
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            batch, sample_shape, x.ndim - 1,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out_capacity, out_shape, ctypes.byref(out_rank))
        if n < 0:
            raise RuntimeError("native run failed: %s" %
                               self._lib.veles_last_error().decode())
        shape = tuple(out_shape[i] for i in range(out_rank.value))
        return out[:n].reshape(shape).copy()

    def close(self):
        if self._handle:
            self._lib.veles_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
