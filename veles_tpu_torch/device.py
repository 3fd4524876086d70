"""Device policy: every entry point runs on the card unless told not to.

The counterpart of ``veles_tpu/backends.py`` (``TPUDevice`` refuses to
run on a CPU-only host, ``CPUDevice`` is the explicit test backend):

- ``device=None`` means CUDA.  With no card visible it raises — an entry
  point never silently degrades to the CPU;
- ``device="cpu"`` (or a ``torch.device("cpu")``) is the explicit
  opt-in the CPU tests use; the kernels' wrappers then take their plain
  PyTorch versions;
- f32 matrix products stay IEEE f32: TF32 is switched off for cuBLAS
  and cuDNN, because the JAX kernels ask for ``Precision.HIGHEST``.
"""

import torch

__all__ = ["resolve_device"]


def _strict_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None):
    """``None`` -> ``cuda`` (raises without a card); anything else ->
    ``torch.device(device)``, checked to be usable.  A CUDA device comes
    back with its index, so two resolutions compare equal."""
    _strict_f32()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r requested (the default) but torch sees no CUDA "
            "device; pass device='cpu' explicitly to run the plain "
            "PyTorch versions on the host" % str(dev))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r (want cuda or cpu)"
                         % str(dev))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
