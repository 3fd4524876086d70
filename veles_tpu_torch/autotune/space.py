"""Search spaces: what each tunable site is allowed to try.

The port's counterpart of ``veles_tpu/autotune/space.py``: the same ten
site names, each declaring *every* candidate up front with validity
constraints; the runner measures, and only a measured, correctness-
gated winner is ever persisted.  Where a JAX parameter named a TPU VMEM
tile the CUDA kernel does not have, the port's site declares the CUDA
kernel's own choice under the JAX site name:

===================== ===================================================
site                  parameters (dispatch at)
===================== ===================================================
lrn                   impl: ``kernel`` (K5/K6) or ``band`` (``lrn_mxu``)
                      (znicz/lrn.py)
flash_attention       fwd_block_k (K7's key tile), dq_block_k (K8's),
                      dkv_block_q (K9's query tile)
                      (znicz/flash_attention.py)
window_attention      the same under a causal window
                      (znicz/flash_attention.py)
precise_gemm          split: K4's split-K, the kernel's rule, none, or
                      256-deep K tiles a CTA (znicz/gemm.py)
paged_attention       block_size (the pools'), split: K1/K2's context
                      split, the plan's rule or a count
                      (znicz/paged_attention.py)
serving.bucket_ladder shape: pow2, coarse or dense (serving/scheduler.py)
serving.decode        max_batch, block_size (serving/decode.py)
serving.prefill_chunk chunk_tokens (serving/decode.py)
serving.spec_depth    spec_depth (serving/decode.py)
serving.kv_dtype      kv_dtype: f32 or int8 (serving/decode.py)
===================== ===================================================

Every site's ``default`` is exactly what the port does without a tuner
(cross-checked against the kernel constants and rules in
tests/test_torch_autotune.py), so a resolve with no tuning record — or
with the tuner off — reproduces current behavior byte for byte.  Where
the default depends on the call (the flash kernels' tiles by head dim,
the pools' block size) the site's ``default_for`` gives it; the
declared one is the D <= 64 class that attention training runs, and
the default block size.

This module imports neither torch nor the kernels: config-time code
(the CLI's ``list``, dispatch with the tuner off) stays light.
"""

import itertools

__all__ = ["SearchSpace", "SITES", "site", "ladder", "pow2_bucket",
           "flash_plan_tiles", "FLASH_TILES", "PRECISE_TILE_K",
           "PRECISE_MAX_WS", "PAGED_MAX_SPLIT_BLOCKS"]


def pow2_bucket(n):
    """The next power of two >= n — the shape-class bucket for dims
    that vary continuously (GEMM sizes), so one tuning record covers a
    band of shapes the same plan serves."""
    n = max(int(n), 1)
    b = 1
    while b < n:
        b <<= 1
    return b


def ladder(shape, max_batch):
    """Materialize a bucket-ladder shape into sizes, largest = max_batch.

    ``pow2`` reproduces ``serving.scheduler.bucket_sizes`` exactly
    (test-enforced — that equality is what makes the tuner-off path
    byte-identical); ``coarse`` trades padding for fewer warm runs,
    ``dense`` the reverse (pow2 + 3*2^k midpoints).
    """
    mb = int(max_batch)
    if mb < 1:
        raise ValueError("max_batch must be >= 1")
    if shape == "pow2":
        sizes, b = [], 1
        while b < mb:
            sizes.append(b)
            b <<= 1
        sizes.append(mb)
        return sizes
    if shape == "coarse":
        return sorted({1, max(mb // 4, 1), max(mb // 2, 1), mb})
    if shape == "dense":
        sizes, b = {mb}, 1
        while b < mb:
            sizes.add(b)
            if 3 * b // 2 < mb and b > 1:
                sizes.add(3 * b // 2)
            b <<= 1
        return sorted(sizes)
    raise ValueError("unknown ladder shape %r" % (shape,))


class SearchSpace:
    """One tunable site: parameter grid + validity constraint.

    ``params`` maps parameter name -> tuple of candidate values;
    ``default`` is the hand-picked config (always a valid candidate and
    always measured first — it is the baseline every speedup is
    reported against).  ``constraint(config, ctx)`` filters the cross
    product; ``classify(ctx)`` maps a concrete call context to the
    shape-class string the tuning store keys on.

    ``error_bound`` declares the numeric tolerance a LOSSY candidate
    must stay within to pass the probe's gate (e.g. logit RMSE for
    quantized KV pools).  ``None`` keeps the gate the site's own exact
    or stated one: an error bound is a property of the site's contract,
    declared here, never improvised per probe run.

    ``default_for(ctx)``, where the call decides the default (the flash
    tiles by head dim, the pools' block size), gives it for a context;
    ``default`` is then its value for the declared class.
    """

    def __init__(self, name, params, default, constraint=None,
                 classify=None, description="", error_bound=None,
                 default_for=None):
        self.name = name
        self.params = {k: tuple(v) for k, v in params.items()}
        self.default = dict(default)
        self._constraint = constraint
        self._classify = classify
        self._default_for = default_for
        self.description = description
        self.error_bound = (None if error_bound is None
                            else float(error_bound))

    def valid(self, config, ctx=None):
        if set(config) != set(self.params):
            return False
        if any(config[k] not in self.params[k] for k in config):
            return False
        return self._constraint(config, ctx or {}) \
            if self._constraint else True

    def default_for(self, ctx=None):
        """The default at a call context (a copy)."""
        if self._default_for is None:
            return dict(self.default)
        return dict(self._default_for(ctx or {}))

    def candidates(self, ctx=None):
        """Every valid config, the default at ``ctx`` (:meth:`default_for`)
        FIRST (the runner measures it as the baseline even when
        invalid-by-constraint — it is what ships, so it is always
        comparable)."""
        ctx = ctx or {}
        default = self.default_for(ctx)
        out = [default]
        names = sorted(self.params)
        for values in itertools.product(*(self.params[n] for n in names)):
            cfg = dict(zip(names, values))
            if cfg == default or not self.valid(cfg, ctx):
                continue
            out.append(cfg)
        return out

    def shape_class(self, ctx):
        """The store key's shape-class string for a call context."""
        if self._classify is None:
            return "any"
        return self._classify(ctx or {})


#: the flash kernels' tiles at each head-dim instantiation (DMAX 32, 64,
#: 128, 256; past 256 the wide path): K7's and K8's streamed key tile,
#: K9's streamed query tile — ``FwdPlan`` / ``DqPlan`` / ``DkvPlan`` in
#: csrc/flash_attention.cu
FLASH_TILES = {32: (64, 64, 64), 64: (32, 32, 32), 128: (32, 32, 32),
               256: (32, 16, 16), "wide": (64, 32, 32)}
#: the other instantiations a class has (the D <= 64 class attention
#: training runs: d_model 512 over 8 heads)
FLASH_ALT_TILES = {64: ((64,), (16,), (16,))}


def _flash_class(d):
    for dmax in (32, 64, 128, 256):
        if d <= dmax:
            return dmax
    return "wide"


def flash_plan_tiles(d):
    """The kernels' own tiles at head dim ``d``: the site default."""
    fwd, dq, dkv = FLASH_TILES[_flash_class(int(d))]
    return {"fwd_block_k": fwd, "dq_block_k": dq, "dkv_block_q": dkv}


def _flash_constraint(cfg, ctx):
    # only the tiles instantiated for the call's head-dim class launch
    d = int(ctx.get("d", 64))
    cls = _flash_class(d)
    own = FLASH_TILES[cls]
    alts = FLASH_ALT_TILES.get(cls, ((), (), ()))
    for i, key in enumerate(("fwd_block_k", "dq_block_k", "dkv_block_q")):
        if cfg[key] != own[i] and cfg[key] not in alts[i]:
            return False
    return True


#: K4's unit of compensated accumulation and the workspace a split
#: candidate may take (floats: 1 GB); the kernel's own rule keeps its
#: workspace under 256 MB (``vt_precise_matmul_split``)
PRECISE_TILE_K = 256
PRECISE_MAX_WS = 1 << 28


def _gemm_constraint(cfg, ctx):
    split = cfg["split"]
    if split in ("rule", "none"):
        return True
    tiles = -(-int(ctx.get("k", 512)) // PRECISE_TILE_K)
    return 2 <= tiles and split < tiles and \
        tiles * int(ctx.get("m", 512)) * int(ctx.get("n", 512)) <= \
        PRECISE_MAX_WS


#: the most blocks one K1/K2 split covers (their page-table entries and
#: scales sit in shared memory; paged_attention._MAX_SPLIT_BLOCKS)
PAGED_MAX_SPLIT_BLOCKS = 128


def _paged_max_blocks(ctx):
    bs = int(ctx.get("block_size", 8))
    return int(ctx.get("max_blocks", -(-int(ctx.get("max_context", 64))
                                       // bs)))


def _paged_constraint(cfg, ctx):
    # the page size is the pools' (the serving.decode site picks it);
    # a kernel record carries the size it was measured at
    if cfg["block_size"] != int(ctx.get("block_size", 8)):
        return False
    split = cfg["split"]
    if split == "rule":
        return True
    nb = _paged_max_blocks(ctx)
    return split <= nb and -(-nb // split) <= PAGED_MAX_SPLIT_BLOCKS


def _paged_class(ctx):
    bs = int(ctx.get("block_size", 8))
    return "h%d_d%d_len%d_b%d_bs%d%s" % (
        ctx["heads"], ctx["d"], pow2_bucket(_paged_max_blocks(ctx) * bs),
        pow2_bucket(ctx.get("batch", 1)), bs,
        "_int8" if ctx.get("quantized") else "")


def _decode_constraint(cfg, ctx):
    ctx_len = ctx.get("max_context")
    return ctx_len is None or cfg["block_size"] <= int(ctx_len)


#: the builtin sites; ``python -m veles_tpu_torch.autotune tune --site``
#: names these
SITES = {}


def _register(s):
    SITES[s.name] = s
    return s


_register(SearchSpace(
    "lrn",
    params={"impl": ("kernel", "band")},
    # unset use_pallas on the card runs the kernel pair (lrn.py); the
    # band form is the JAX package's "mxu" layout as a candidate
    default={"impl": "kernel"},
    classify=lambda ctx: "c%d_n%d" % (ctx["c"], ctx.get("n", 5)),
    description="cross-channel LRN: the K5/K6 kernel pair, or the band "
                "form (one [C, C] matmul)"))

_register(SearchSpace(
    "flash_attention",
    params={"fwd_block_k": (16, 32, 64), "dq_block_k": (16, 32, 64),
            "dkv_block_q": (16, 32, 64)},
    default=flash_plan_tiles(64),
    default_for=lambda ctx: flash_plan_tiles(ctx.get("d", 64)),
    constraint=_flash_constraint,
    classify=lambda ctx: "t%d_d%d%s" % (
        pow2_bucket(ctx["t"]), ctx["d"],
        "_causal" if ctx.get("causal") else ""),
    description="flash attention K7/K8 key tile and K9 query tile"))

_register(SearchSpace(
    "window_attention",
    params={"fwd_block_k": (16, 32, 64), "dq_block_k": (16, 32, 64),
            "dkv_block_q": (16, 32, 64)},
    default=flash_plan_tiles(64),
    default_for=lambda ctx: flash_plan_tiles(ctx.get("d", 64)),
    constraint=_flash_constraint,
    classify=lambda ctx: "t%d_d%d_w%d" % (
        pow2_bucket(ctx["t"]), ctx["d"], ctx.get("window", 0)),
    description="sliding-window attention K7/K8 key tile and K9 query "
                "tile"))

_register(SearchSpace(
    "precise_gemm",
    params={"split": ("rule", "none", 1, 2, 4, 8)},
    # the kernel's rule: split K over its 256-deep tiles when the
    # output grid leaves SMs idle (vt_precise_matmul_split)
    default={"split": "rule"},
    constraint=_gemm_constraint,
    classify=lambda ctx: "m%d_k%d_n%d_l%d" % (
        pow2_bucket(ctx["m"]), pow2_bucket(ctx["k"]),
        pow2_bucket(ctx["n"]), ctx.get("level", 1)),
    description="compensated-GEMM split-K: the kernel's rule, none, or "
                "256-deep K tiles a CTA"))

_register(SearchSpace(
    "paged_attention",
    params={"block_size": (4, 8, 16, 32),
            "split": ("rule", 1, 2, 4, 8, 16)},
    # paged_attention.DEFAULT_BLOCK_SIZE; paged_attention_plan's split
    default={"block_size": 8, "split": "rule"},
    default_for=lambda ctx: {"block_size": int(ctx.get("block_size", 8)),
                             "split": "rule"},
    constraint=_paged_constraint,
    classify=_paged_class,
    description="KV page size and the K1/K2 context split"))

_register(SearchSpace(
    "serving.bucket_ladder",
    params={"shape": ("pow2", "coarse", "dense")},
    default={"shape": "pow2"},       # scheduler.bucket_sizes
    classify=lambda ctx: "mb%d" % ctx["max_batch"],
    description="bucket-ladder shape: padding waste vs warm runs"))

_register(SearchSpace(
    "serving.decode",
    params={"max_batch": (4, 8, 16, 32), "block_size": (4, 8, 16, 32)},
    default={"max_batch": 8, "block_size": 8},
    constraint=_decode_constraint,
    classify=lambda ctx: "ctx%d" % pow2_bucket(ctx.get("max_context", 64)),
    description="decode scheduler geometry: concurrent rows + KV page "
                "size"))


def _chunk_constraint(cfg, ctx):
    # a chunk larger than the prompt ceiling degenerates to monolithic
    # prefill with extra padding — keep candidates distinct
    mp = ctx.get("max_prompt_len")
    return mp is None or cfg["chunk_tokens"] <= pow2_bucket(mp)


_register(SearchSpace(
    "serving.prefill_chunk",
    params={"chunk_tokens": (8, 16, 32, 64)},
    default={"chunk_tokens": 32},    # decode.DEFAULT_PREFILL_CHUNK
    constraint=_chunk_constraint,
    classify=lambda ctx: "mp%d" % pow2_bucket(
        ctx.get("max_prompt_len", 64)),
    description="prefill chunk size: short-request TTFT under "
                "head-of-line long prefills vs per-chunk dispatch "
                "overhead"))


def _spec_constraint(cfg, ctx):
    # speculating past the per-request token budget only writes
    # positions the accept step must discard — keep candidates distinct
    mn = ctx.get("max_new_tokens")
    return mn is None or cfg["spec_depth"] < max(int(mn), 2)


_register(SearchSpace(
    "serving.spec_depth",
    params={"spec_depth": (1, 2, 3, 4, 6, 8)},
    default={"spec_depth": 2},       # decode.DEFAULT_SPEC_DEPTH
    constraint=_spec_constraint,
    classify=lambda ctx: "mn%d" % pow2_bucket(
        ctx.get("max_new_tokens", 32)),
    description="speculative decoding depth: draft tokens per "
                "iteration — measured acceptance rate vs the "
                "multi-token verify pass's cost"))


_register(SearchSpace(
    "serving.kv_dtype",
    params={"kv_dtype": ("f32", "int8")},
    default={"kv_dtype": "f32"},     # decode pools exactly as shipped
    classify=lambda ctx: "ctx%d" % pow2_bucket(
        ctx.get("max_context", 64)),
    error_bound=1e-2,
    description="KV-pool precision: f32 pools exactly as shipped, or "
                "int8 blocks dequantized in-kernel — the lossy site, "
                "gated on the declared logit-RMSE bound instead of "
                "token equality"))


def site(name):
    try:
        return SITES[name]
    except KeyError:
        raise KeyError("unknown autotune site %r (known: %s)"
                       % (name, ", ".join(sorted(SITES))))
