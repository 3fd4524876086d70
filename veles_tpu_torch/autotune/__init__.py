"""veles_tpu_torch.autotune — persistent search over kernel and serving
plans, the port's counterpart of ``veles_tpu/autotune``.

Every hand kernel's launch plan and the serving-geometry knobs declare
a small candidate grid under the JAX package's ten site names
(:mod:`.space`); a runner measures candidates in isolated fresh
subprocesses with hard wall-clock caps and correctness gating (a kernel
candidate held to the kernel's plain version; :mod:`.runner` /
:mod:`.probe`), and measured winners persist in a store keyed by (site,
shape class, the environment: torch and CUDA versions, the card, the
toolchain and the kernel sources) (:mod:`.store`), so tuning is paid
once a card and build.  Kernel call sites resolve through
:func:`resolve` with their own plan as the default — with the tuner off
(no ``root.common.autotune.dir`` / ``$VELES_AUTOTUNE_DIR``) every
output and launch is byte-for-byte unchanged.

Drive it with ``python -m veles_tpu_torch.autotune
tune|list|show|verify|resolve``.
"""

from .dispatch import (AUTOTUNE_DIR_ENV, default_store, describe,  # noqa: F401
                       reset_default_stores, resolve, resolve_config)
from .runner import (measure_candidate, measure_site,  # noqa: F401
                     run_isolated, tune_site)
from .space import SITES, SearchSpace, ladder, site  # noqa: F401
from .store import SCHEMA, SUFFIX, TuningStore, record_key  # noqa: F401
