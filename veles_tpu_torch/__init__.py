"""veles_tpu_torch: the PyTorch + CUDA port of veles_tpu.

The JAX package (``veles_tpu``) stays the reference; this package mirrors
its module paths (``veles_tpu/serving/decode.py`` has its counterpart at
``veles_tpu_torch/serving/decode.py``) and runs on an NVIDIA H100 through
hand-written CUDA kernels (``csrc/``) built with ``nvcc`` at first use.

It imports ``torch`` and never ``jax`` or anything of ``veles_tpu``.
Entry points run on the card unless the caller passes ``device="cpu"``
(:mod:`.device`).
"""

__version__ = "0.1.0"
