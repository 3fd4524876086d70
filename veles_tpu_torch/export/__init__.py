"""Export path: trained workflow -> package zip -> inference anywhere.

The port of ``veles_tpu/export``.  A package is the JAX package's zip,
byte for byte where it matters: ``contents.json`` (workflow name,
checksum, every unit's description and the names of its exported
arrays), ``<unit>/<attr>.npy`` (C order, fp16 or fp32) and
``model.json`` (the forward chain: each unit's class, parameter names
and structural ``config``).  The native engine (``native/``) and the JAX
package's ``PackageLoader`` read a package the port wrote, and the
port's :class:`PackageLoader` serves one the JAX package wrote.

The port writes no ``model.stablehlo`` and ignores one it finds: a
loaded package rebuilds its forward chain from ``model.json`` out of the
port's own units (:func:`build_forwards`), so on the card each unit
launches its hand kernels (K4 in the All2All family under
``precise_gemm``, K5 in LRN, K7 in attention).
"""

from .packager import package_export  # noqa: F401
from .model import (build_forwards, export_forward,  # noqa: F401
                    export_model, forward_fn)
from .loader import PackageLoader  # noqa: F401

__all__ = ["PackageLoader", "build_forwards", "export_forward",
           "export_model", "forward_fn", "package_export"]
