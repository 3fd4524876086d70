"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test takes the ``cuda`` fixture, which skips when
torch sees no CUDA device (decided inside the fixture, never while the
module is imported, so every pytest worker collects the same tests).
On a machine with a card, run them without the JAX test configuration:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: paged attention ``max|kernel - plain| <= 1e-5`` (another
summation order and ``expf``); the quantized GEMM
``max|kernel - plain| <= 1e-5 * max|plain|`` (2xTF32 tensor-core
products, exact in the weights, summed in another order than cuBLAS's,
split-K ranges added in K order); the precise GEMM
``max|kernel - plain| <= 1e-6 * max(|a| @ |b|)`` (the same K tiles,
each summed in another order than cuBLAS's); flash attention (K7-K9)
out and lse ``<= 2e-5``, each gradient ``<= 5e-4 * max(1, max|plain|)``
(the JAX package's tests/test_flash_attention.py tolerances), and at
T = 16384 K7 within 2e-6 and K8/K9 within 1e-5 of max(1, max|plain|)
(the figures their per-tile joins of the tensor cores' sums are held
to); LRN (K5,
K6) ``<= 1e-5 * max(1, max|plain|)`` (the same formula, powf against
torch.pow a few ulps apart), bitwise equal wherever torch.pow takes its
general path (beta 0.75 and 0.6 here: the same powf, IEEE divide and
summation order), and ``F.local_response_norm`` agrees with K5 within
1e-5.  AlexNet (full widths at the JAX test's side
67) takes two train steps on the card and on the CPU: losses within
1e-4 relative, each parameter tensor within 1e-4 of its largest
magnitude (chip_smoke's limits); threefry bits on the card equal the
CPU's.  A KV block demoted from f32 and int8 pools on the card and
readmitted gives the CPU's wire bytes and pools bit for bit;
``restore_kv`` of a CPU checkpoint on the card resumes with the CPU
run's tokens.  Every non-default candidate of the ``precise_gemm``,
``paged_attention``, ``flash_attention`` and ``window_attention``
autotune sites holds to the plain versions at the same limits (K4's
every split bit-equal to the default as well); a tile no instantiation
has raises; tuned records reach the kernels through their call sites.
"""

import os
import sys

import numpy
import pytest
import torch

from veles_tpu_torch.parallel.ring import attention_reference
from veles_tpu_torch.znicz import flash_attention as fa
from veles_tpu_torch import prng
from veles_tpu_torch.znicz import gemm
from veles_tpu_torch.znicz import lrn
from veles_tpu_torch.znicz import paged_attention as pa

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _paged_inputs(dev, b, h, d, bs, nb, lengths, seed=0, pool=None):
    rng = numpy.random.RandomState(seed)
    n_pool = pool or b * nb + 1
    q = torch.tensor(rng.standard_normal((b, h, d)), dtype=torch.float32,
                     device=dev)
    kp = torch.tensor(rng.standard_normal((n_pool, bs, h, d)),
                      dtype=torch.float32, device=dev)
    vp = torch.tensor(rng.standard_normal((n_pool, bs, h, d)),
                      dtype=torch.float32, device=dev)
    ids = 1 + rng.permutation(n_pool - 1)[:b * nb]
    table = torch.tensor(ids.reshape(b, nb), dtype=torch.int32, device=dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, table, lens


def _quantized(kp, vp, quant):
    if not quant:
        return kp, vp, {}
    kp, ks = pa.quantize_pool(kp)
    vp, vs = pa.quantize_pool(vp)
    return kp, vp, {"k_scales": ks, "v_scales": vs}


def _paged_err(out, q, kp, vp, table, lens, **scales):
    ref = pa.paged_attention_reference(q, kp, vp, table, lens, **scales)
    return float((out - ref).abs().max())


@pytest.mark.parametrize("d", [16, 24, 128, 200, 256, 320, 512])
@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_matches_plain(cuda, d, quant):
    bs, nb = 4, 6
    lengths = [0, 1, bs - 1, bs + 1, nb * bs, 7]
    q, kp, vp, table, lens = _paged_inputs(cuda, len(lengths), 3, d, bs,
                                           nb, lengths, seed=d)
    kp, vp, scales = _quantized(kp, vp, quant)
    before = pa.paged_attention.launches
    out = pa.paged_attention(q, kp, vp, table, lens, **scales)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    ref = pa.paged_attention_reference(q, kp, vp, table, lens, **scales)
    assert float((out - ref).abs().max()) <= 1e-5
    assert torch.equal(out[0], torch.zeros_like(out[0]))   # length 0


@pytest.mark.parametrize("d", [257, 1024, 4096])
@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_head_dims_past_a_register_accumulator(cuda, d,
                                                               quant):
    """Past 128 column chunks a thread (f32 D > 512, int8 D > 2048) the
    accumulator sits in shared memory and q is read from it; D = 257
    takes scalar reads."""
    bs, nb = 4, 6
    lengths = [0, 1, bs + 1, nb * bs]
    q, kp, vp, table, lens = _paged_inputs(cuda, len(lengths), 2, d, bs,
                                           nb, lengths, seed=d)
    kp, vp, scales = _quantized(kp, vp, quant)
    out = pa.paged_attention(q, kp, vp, table, lens, **scales)
    torch.cuda.synchronize()
    assert _paged_err(out, q, kp, vp, table, lens, **scales) <= 1e-5
    assert torch.equal(out[0], torch.zeros_like(out[0]))


@pytest.mark.parametrize("d", [1, 5, 6, 12, 18])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
def test_paged_attention_ragged_head_dims_and_misaligned_pools(
        cuda, d, quant, offset):
    """Head dims off the 16-byte vector (8-, 4- and 1-byte copies,
    scalar reads) and pools whose base is off by one element."""
    bs, nb, h = 4, 40, 4
    lengths = [0, 1, bs + 1, 77, nb * bs]
    q, kp, vp, table, lens = _paged_inputs(cuda, len(lengths), h, d, bs,
                                           nb, lengths, seed=d + offset)
    kp, vp, scales = _quantized(kp, vp, quant)
    if offset:
        kp, vp = (torch.cat([p.flatten()[:1], p.flatten()])[1:].view(
            p.shape) for p in (kp, vp))
        assert kp.data_ptr() % 16 != 0
    out = pa.paged_attention(q, kp, vp, table, lens, **scales)
    torch.cuda.synchronize()
    assert _paged_err(out, q, kp, vp, table, lens, **scales) <= 1e-5


def test_paged_attention_large_score_row(cuda):
    """A row of 16384 tokens: the score row a dense softmax keeps in
    shared memory is gone, the online softmax streams it."""
    bs, nb = 64, 256
    lengths = [bs * nb, 5000, 0]
    q, kp, vp, table, lens = _paged_inputs(cuda, 3, 2, 32, bs, nb,
                                           lengths, seed=3)
    out = pa.paged_attention(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    ref = pa.paged_attention_reference(q, kp, vp, table, lens)
    assert float((out - ref).abs().max()) <= 1e-5


def test_paged_attention_refuses_what_the_kernel_cannot_take(cuda):
    q, kp, vp, table, lens = _paged_inputs(cuda, 2, 2, 8, 4, 3, [3, 5])
    with pytest.raises(ValueError):        # non-contiguous query
        pa.paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                           kp, vp, table, lens)
    with pytest.raises(ValueError):        # int64 lengths
        pa.paged_attention(q, kp, vp, table, lens.long())


@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_takes_a_60000_block_table(cuda, quant):
    """A 60000-block table (a dense score row of it would not fit the
    card's 227 KB of shared memory) runs: 469 splits of 128 blocks."""
    nb = 60000
    q, kp, vp, table, lens = _paged_inputs(cuda, 2, 2, 8, 1, nb,
                                           [nb, 41234], seed=4)
    kp, vp, scales = _quantized(kp, vp, quant)
    plan = pa._cached_plan(2, 2, 8, 1, nb, quant, q.device)
    assert plan.split > 1 and plan.split * plan.blocks_per_split >= nb
    merges = pa.paged_attention.merge_launches
    out = pa.paged_attention(q, kp, vp, table, lens, **scales)
    torch.cuda.synchronize()
    assert pa.paged_attention.merge_launches == merges + 1
    assert _paged_err(out, q, kp, vp, table, lens, **scales) <= 1e-5


def _split_case(dev, quant, seed=5):
    """A table that splits: lengths at, one before and one past each
    split boundary, and a length-0 row among long rows."""
    h, d, bs, nb = 2, 64, 16, 128
    plan = pa.paged_attention_plan(24, h, d, bs, nb, 132, quantized=quant)
    edge = plan.blocks_per_split * bs
    lengths = [nb * bs, 0]
    for k in range(1, plan.split):
        lengths += [k * edge - 1, k * edge, k * edge + 1]
    lengths = (lengths + [5] * 24)[:24]
    q, kp, vp, table, lens = _paged_inputs(dev, 24, h, d, bs, nb, lengths,
                                           seed=seed)
    kp, vp, scales = _quantized(kp, vp, quant)
    return (q, kp, vp, table, lens), scales


@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_split_boundaries(cuda, quant):
    args, scales = _split_case(cuda, quant)
    q, kp, _, table, _ = args
    assert pa._cached_plan(*q.shape, kp.shape[1], table.shape[1], quant,
                           cuda).split > 1
    before = (pa.paged_attention.launches, pa.paged_attention.merge_launches)
    out = pa.paged_attention(*args, **scales)
    torch.cuda.synchronize()
    assert (pa.paged_attention.launches,
            pa.paged_attention.merge_launches) == (before[0] + 1,
                                                   before[1] + 1)
    assert _paged_err(out, *args, **scales) <= 1e-5
    assert torch.equal(out[1], torch.zeros_like(out[1]))    # length 0


@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_split_equals_unsplit(cuda, quant):
    """The planned split against one CTA a row (split 1) and other
    tiles, through the launch helper with a forced plan: within 1e-5
    (another order of the same sums)."""
    args, scales = _split_case(cuda, quant, seed=6)
    ks, vs = scales.get("k_scales"), scales.get("v_scales")
    q, kp, vp, table, lens = args
    b, h, d = q.shape
    nb = table.shape[1]
    plan = pa._cached_plan(b, h, d, kp.shape[1], nb, quant, cuda)
    split = pa._paged_launch(*args, None, ks, vs, plan)
    for forced in (pa.PagedPlan(1, nb, plan.tile), pa.PagedPlan(1, nb, 5),
                   pa.PagedPlan(5, 26, 3)):
        other = pa._paged_launch(*args, None, ks, vs, forced)
        torch.cuda.synchronize()
        assert float((split - other).abs().max()) <= 1e-5, forced


@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_two_calls_bitwise_equal(cuda, quant):
    args, scales = _split_case(cuda, quant, seed=7)
    first = pa.paged_attention(*args, **scales)
    second = pa.paged_attention(*args, **scales)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_paged_attention_adds_no_host_sync(cuda):
    """The plan comes from static shapes: under sync debug mode "error"
    a call (split and unsplit, after a first call that cached each
    plan) raises nothing."""
    args, scales = _split_case(cuda, True, seed=8)
    small = _paged_inputs(cuda, 3, 2, 16, 4, 6, [0, 5, 24], seed=8)
    pa.paged_attention(*args, **scales)
    pa.paged_attention(*small)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = pa.paged_attention(*args, **scales)
        small_out = pa.paged_attention(*small)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert _paged_err(out, *args, **scales) <= 1e-5
    assert _paged_err(small_out, *small) <= 1e-5


def test_prefill_and_verify_wrappers_match_plain(cuda):
    bs, nb, h, d = 4, 5, 2, 16
    q, kp, vp, table, lens = _paged_inputs(cuda, 3, h, d, bs, nb,
                                           [0, 6, 9], seed=9)
    chunk = q[:, None].expand(3, 4, h, d)[0].contiguous()   # [4, H, D]
    out = pa.paged_prefill_attention(chunk, kp, vp, table[1], 3, 6)
    ref = pa.paged_prefill_attention_reference(chunk, kp, vp, table[1], 3,
                                               6)
    assert float((out - ref).abs().max()) <= 1e-5
    span = torch.stack([q, q.flip(0)], dim=1).contiguous()  # [3, 2, H, D]
    out = pa.paged_verify_attention(span, kp, vp, table, lens)
    ref = pa.paged_verify_attention_reference(span, kp, vp, table, lens)
    assert float((out - ref).abs().max()) <= 1e-5


@pytest.mark.parametrize("quant", [False, True])
def test_prefill_and_verify_wrappers_on_a_split_plan(cuda, quant):
    bs, nb, h, d = 16, 128, 2, 64
    q, kp, vp, table, lens = _paged_inputs(cuda, 3, h, d, bs, nb,
                                           [0, 700, 2000], seed=10)
    kp, vp, scales = _quantized(kp, vp, quant)
    chunk = torch.randn((8, h, d), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    assert pa._cached_plan(8, h, d, bs, nb, quant, cuda).split > 1
    assert pa._cached_plan(6, h, d, bs, nb, quant, cuda).split > 1
    merges = pa.paged_attention.merge_launches
    for start, length in ((0, 5), (1500, 1504), (2040, 2048)):
        out = pa.paged_prefill_attention(chunk, kp, vp, table[2], start,
                                         length, **scales)
        ref = pa.paged_prefill_attention_reference(
            chunk, kp, vp, table[2], start, length, **scales)
        assert float((out - ref).abs().max()) <= 1e-5
    span = torch.stack([q, q.flip(0)], dim=1).contiguous()  # [3, 2, H, D]
    out = pa.paged_verify_attention(span, kp, vp, table, lens, **scales)
    ref = pa.paged_verify_attention_reference(span, kp, vp, table, lens,
                                              **scales)
    assert float((out - ref).abs().max()) <= 1e-5
    assert pa.paged_attention.merge_launches == merges + 4


@pytest.mark.parametrize("shape", [(1, 64, 128), (16, 128, 64),
                                   (37, 70, 50), (130, 300, 257)])
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_matmul_matches_plain(cuda, shape, dtype):
    m, k, n = shape
    rng = numpy.random.RandomState(m + k + n)
    a = torch.tensor(rng.standard_normal((m, k)), dtype=torch.float32,
                     device=cuda)
    w = torch.tensor(rng.standard_normal((k, n)), dtype=torch.float32,
                     device=cuda)
    w_q, s = gemm.quantize_weight(w, dtype)
    before = gemm.quantized_matmul.launches
    out = gemm.quantized_matmul(a, w_q, s)
    torch.cuda.synchronize()
    assert gemm.quantized_matmul.launches == before + 1
    ref = gemm.quantized_matmul_reference(a, w_q, s)
    assert out.shape == (m, n)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_quantized_matmul_refuses_what_the_kernel_cannot_take(cuda):
    a = torch.ones((4, 8), device=cuda)
    w_q, s = gemm.quantize_weight(torch.ones((8, 6), device=cuda))
    with pytest.raises(ValueError):        # non-contiguous weights
        gemm.quantized_matmul(a, w_q.t().contiguous().t(), s)
    with pytest.raises(ValueError):        # f64 activations
        gemm.quantized_matmul(a.double(), w_q, s)
    with pytest.raises(ValueError):        # weights on the host
        gemm.quantized_matmul(a, w_q.cpu(), s)


def _qmm_inputs(dev, m, k, n, dtype, seed):
    rng = numpy.random.RandomState(seed)
    a = torch.tensor(rng.standard_normal((m, k)), dtype=torch.float32,
                     device=dev)
    w = torch.tensor(rng.standard_normal((k, n)), dtype=torch.float32,
                     device=dev)
    w[:, 3] = 0.0                          # an all-zero output channel
    w_q, s = gemm.quantize_weight(w, dtype)
    return a, w_q, s


def _qmm_close(out, a, w_q, s):
    ref = gemm.quantized_matmul_reference(a, w_q, s)
    assert out.shape == ref.shape
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    return ref


@pytest.mark.parametrize("m", [1, 16, 17, 256])
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_matmul_at_decode_and_prefill_rows(cuda, m, dtype):
    """K = N = 4096: 1 and 16 rows take the 16-row tile, 17 and 256 the
    64-row one; each grid is thinner than the card, so K splits and the
    fold launches (counted); two identical calls give the same bits."""
    a, w_q, s = _qmm_inputs(cuda, m, 4096, 4096, dtype, seed=m)
    tile, split, k_split = gemm.quantized_matmul_plan(m, 4096, 4096, cuda)
    assert tile == (16 if m <= 16 else 64)
    assert split > 1 and (split - 1) * k_split < 4096 <= split * k_split
    launches = gemm.quantized_matmul.launches
    folds = gemm.quantized_matmul.fold_launches
    out = gemm.quantized_matmul(a, w_q, s)
    again = gemm.quantized_matmul(a, w_q, s)
    torch.cuda.synchronize()
    assert gemm.quantized_matmul.launches == launches + 2
    assert gemm.quantized_matmul.fold_launches == folds + 2
    assert torch.equal(out, again)
    _qmm_close(out, a, w_q, s)


@pytest.mark.parametrize("shape", [(16, 1000, 4096), (17, 4096, 4100),
                                   (5, 2048, 4097), (256, 1000, 520)])
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_matmul_split_and_unsplit_match_plain(cuda, shape, dtype):
    """N not a multiple of 16 (4-byte copies at 4100 and 520, byte loads
    at 4097), K = 1000 leaving a partial 64-deep stage; the planned call
    (split) and the same call over one K range both hold the limit."""
    m, k, n = shape
    a, w_q, s = _qmm_inputs(cuda, m, k, n, dtype, seed=k + n)
    tile, split, k_split = gemm.quantized_matmul_plan(m, k, n, cuda)
    assert split > 1
    launches = gemm.quantized_matmul.launches
    folds = gemm.quantized_matmul.fold_launches
    planned = gemm.quantized_matmul(a, w_q, s)
    unsplit = gemm._quantized_launch(a, w_q, s, (tile, 1, k))
    torch.cuda.synchronize()
    assert gemm.quantized_matmul.launches == launches + 2
    assert gemm.quantized_matmul.fold_launches == folds + 1
    _qmm_close(planned, a, w_q, s)
    _qmm_close(unsplit, a, w_q, s)


def test_quantized_matmul_fp8_every_finite_byte(cuda):
    """fp8 weights over every finite e4m3 bit pattern; column 0 holds
    only subnormals (0x01-0x07 and their negatives) and is held to its
    own largest output."""
    rng = numpy.random.RandomState(11)
    finite = numpy.array([b for b in range(256) if b & 0x7F != 0x7F],
                         numpy.uint8)
    sub = numpy.array([b for b in finite if b & 0x78 == 0 and b & 7],
                      numpy.uint8)
    m, k, n = 16, 2048, 384
    q = finite[rng.randint(0, len(finite), (k, n))]
    q[:, 0] = sub[rng.randint(0, len(sub), k)]
    q[:len(finite), 1] = finite
    w_q = torch.tensor(q, device=cuda).view(gemm.fp8_dtype())
    s = torch.tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32,
                     device=cuda)
    a = torch.tensor(rng.standard_normal((m, k)), dtype=torch.float32,
                     device=cuda)
    out = gemm.quantized_matmul(a, w_q, s)
    torch.cuda.synchronize()
    ref = _qmm_close(out, a, w_q, s)
    assert float((out[:, 0] - ref[:, 0]).abs().max()) <= \
        1e-5 * float(ref[:, 0].abs().max())


def _precise_inputs(dev, m, k, n, seed):
    rng = numpy.random.RandomState(seed)
    a = torch.tensor(rng.standard_normal((m, k)), dtype=torch.float32,
                     device=dev)
    b = torch.tensor(rng.standard_normal((k, n)), dtype=torch.float32,
                     device=dev)
    return a, b


@pytest.mark.parametrize("shape", [(60, 784, 100), (60, 100, 10),
                                   (784, 60, 100), (1, 513, 1),
                                   (130, 70, 190), (257, 1000, 65)])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_precise_matmul_matches_plain(cuda, shape, level):
    m, k, n = shape
    a, b = _precise_inputs(cuda, m, k, n, seed=m + k + n)
    scale = float((a.abs() @ b.abs()).max())
    # row-major operands, then both transposed (strided views)
    for x, y in ((a, b), (a.t().contiguous().t(), b.t().contiguous().t())):
        before = gemm.precise_matmul.launches
        out = gemm.precise_matmul(x, y, level)
        torch.cuda.synchronize()
        assert gemm.precise_matmul.launches == before + 1
        ref = gemm.precise_matmul_reference(x, y, level)
        assert out.shape == (m, n)
        assert float((out - ref).abs().max()) <= 1e-6 * scale


def test_precise_matmul_backward_is_the_kernel(cuda):
    a, b = _precise_inputs(cuda, 60, 784, 100, seed=1)
    w = b.clone().requires_grad_(True)
    before = gemm.precise_matmul.launches
    y = gemm.precise_matmul(a, w, 1)
    (y * y).sum().backward()            # a needs no gradient: one call
    torch.cuda.synchronize()
    assert gemm.precise_matmul.launches == before + 2
    want = gemm.precise_matmul_reference(a.t(), 2 * y.detach(), 1)
    scale = float((a.abs().t() @ (2 * y.detach()).abs()).max())
    assert float((w.grad - want).abs().max()) <= 1e-6 * scale


def test_precise_matmul_compensation_on_the_card(cuda):
    """Huge +/-3e7 tiles bracket small ones: level 1 recovers what plain
    accumulation of the tile partials loses (tests/test_precise_gemm.py)."""
    rng = numpy.random.RandomState(1)
    row = numpy.zeros(1024, numpy.float32)
    row[0:256] = 3e7
    row[256:512] = rng.uniform(-1, 1, 256)
    row[512:768] = -3e7
    row[768:] = rng.uniform(-1, 1, 256)
    a = numpy.tile(row[None, :], (8, 1))
    b = numpy.ones((1024, 8), numpy.float32)
    exact = a.astype(numpy.float64) @ b.astype(numpy.float64)
    err = {}
    for level in (0, 1, 2):
        out = gemm.precise_matmul(torch.tensor(a, device=cuda),
                                  torch.tensor(b, device=cuda), level)
        err[level] = numpy.abs(out.cpu().numpy() - exact).max()
    assert err[0] > 0.1, err
    assert err[1] < err[0] / 1e4, err
    assert err[2] <= err[1] * 1.01, err


def test_precise_matmul_klein_second_carry_on_the_card(cuda):
    """Level 2's second carry must matter where Neumaier's carry rounds
    off (the case of tests/test_torch_precise_gemm.py): a 2**40 tile,
    ten triples of tiles x, y, -x (x in [1, 2), y ~ 1e-9), a -2**40
    tile.  Level 1 loses every y, level 2 keeps them:
    ``err[2] < err[1] / 1e4`` against the exact (``math.fsum``) sum."""
    import math
    rng = numpy.random.RandomState(2)
    reps, bk = 10, 256
    tiles = 2 + 3 * reps
    a = numpy.zeros((8, tiles * bk), numpy.float32)
    for i in range(8):
        vals = [2.0 ** 40]
        for _ in range(reps):
            x = rng.uniform(1, 2)
            vals += [x, rng.uniform(2.0 ** -31, 2.0 ** -30), -x]
        vals.append(-2.0 ** 40)
        for t, v in enumerate(vals):
            a[i, t * bk + rng.randint(bk)] = v
    cols = 2.0 ** numpy.arange(8, dtype=numpy.float32)
    b = numpy.tile(cols[None, :], (tiles * bk, 1))
    exact = numpy.array([math.fsum(r) for r in a.astype(numpy.float64)])
    exact = exact[:, None] * cols[None, :].astype(numpy.float64)
    err = {}
    for level in (1, 2):
        out = gemm.precise_matmul(torch.tensor(a, device=cuda),
                                  torch.tensor(b, device=cuda), level)
        err[level] = numpy.abs(out.cpu().numpy() - exact).max()
    assert err[1] > 0.5 * numpy.abs(exact).max(), err
    assert err[2] < err[1] / 1e4, err


def test_precise_matmul_refuses_what_the_kernel_cannot_take(cuda):
    a, b = _precise_inputs(cuda, 4, 8, 6, seed=0)
    with pytest.raises(ValueError):        # f64 operand
        gemm.precise_matmul(a.double(), b.double(), 1)
    with pytest.raises(ValueError):        # operands on two devices
        gemm.precise_matmul(a, b.cpu(), 1)
    with pytest.raises(ValueError):        # no such level
        gemm.precise_matmul(a, b, 3)


@pytest.mark.parametrize("shape", [(60, 784, 100), (37, 1000, 10)])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_precise_matmul_split_is_bit_equal_to_unsplit(cuda, shape, level):
    """A shape whose output grid is smaller than the card splits K over
    its 256-deep tiles (and launches the fold); the top-left corner of
    operands too large to split gives the same bits."""
    m, k, n = shape
    a_big, b_big = _precise_inputs(cuda, 2048, k, 1024, seed=k + level)
    a, b = a_big[:m].contiguous(), b_big[:, :n].contiguous()
    launches = gemm.precise_matmul.launches
    folds = gemm.precise_matmul.fold_launches
    small = gemm.precise_matmul(a, b, level)
    assert gemm.precise_matmul.fold_launches == folds + 1
    big = gemm.precise_matmul(a_big, b_big, level)
    torch.cuda.synchronize()
    assert gemm.precise_matmul.fold_launches == folds + 1
    assert gemm.precise_matmul.launches == launches + 2
    assert torch.equal(small, big[:m, :n])


@pytest.mark.parametrize("shape", [(60, 1027, 10), (200, 515, 37),
                                   (33, 9, 130), (300, 2049, 70)])
@pytest.mark.parametrize("layout", ["", "at", "bt", "at bt", "offset"])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_precise_matmul_ragged_layouts(cuda, shape, layout, level):
    """K not a multiple of 256 or of 4, N = 10 (rows not 16-byte
    aligned: the 4-byte copies), either operand a transposed view, and
    operands whose base is off the 16-byte grid, split or not."""
    m, k, n = shape
    a, b = _precise_inputs(cuda, m, k + 1, n + 1, seed=m + k + n)
    a, b = a[:, 1:], b[1:, 1:]          # "offset": bases one float in
    if layout != "offset":
        a, b = a.contiguous(), b.contiguous()
    if "at" in layout:
        a = a.t().contiguous().t()
    if "bt" in layout:
        b = b.t().contiguous().t()
    out = gemm.precise_matmul(a, b, level)
    ref = gemm.precise_matmul_reference(a, b, level)
    torch.cuda.synchronize()
    scale = float((a.abs() @ b.abs()).max())
    assert float((out - ref).abs().max()) <= 1e-6 * scale


def _mnist(precise, device):
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.prng import RandomGenerator
    from veles_tpu_torch.znicz.samples import mnist
    prng.get().seed(42)
    saved = root.common.engine.get("precise_gemm", 0)
    root.common.engine.precise_gemm = precise
    try:
        wf = mnist.create_workflow(
            loader={"minibatch_size": 60, "n_train": 600, "n_valid": 200,
                    "prng": RandomGenerator().seed(3)},
            decision={"max_epochs": 2, "silent": True})
    finally:
        root.common.engine.precise_gemm = saved
    wf.initialize(device=Device(backend=device))
    return wf


@pytest.mark.parametrize("precise", [0, 1])
def test_mnist_training_on_the_card_matches_the_cpu(cuda, precise):
    """Two epochs of the MNIST sample: the card and the CPU agree on the
    validation error and on the weights within 1e-4; with
    ``precise_gemm=1`` every train step launches K4 five times (two
    forwards, three backward products) and every eval step twice."""
    card, host = _mnist(precise, "cuda"), _mnist(precise, "cpu")
    before = gemm.precise_matmul.launches
    card.run()
    launches = gemm.precise_matmul.launches - before
    host.run()
    step = card.fused_step
    assert launches == precise * (5 * step.train_steps +
                                  2 * step.eval_steps)
    assert card.gather_results()["best_validation_error_pt"] == \
        host.gather_results()["best_validation_error_pt"]
    for f_card, f_host in zip(card.forwards, host.forwards):
        for name, value in f_card.host_params.items():
            assert numpy.abs(value - f_host.host_params[name]).max() <= 1e-4


def _flash_inputs(dev, b, t, h, d, seed, packed=True):
    """q, k, v (strided views of one packed projection, or contiguous)
    and dO, ``randn * 0.5``."""
    rng = numpy.random.RandomState(seed)
    qkv = torch.tensor(rng.standard_normal((b, t, 3 * h * d)) * 0.5,
                       dtype=torch.float32, device=dev)
    q, k, v = (x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    if not packed:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    do = torch.tensor(rng.standard_normal((b, t, h, d)) * 0.5,
                      dtype=torch.float32, device=dev)
    return q, k, v, do


def _rel(a, r):
    return float((a - r).abs().max()) / max(1.0, float(r.abs().max()))


@pytest.mark.parametrize("case", [
    (2, 7, 2, 4, False, None), (2, 8, 2, 8, True, None),
    (2, 256, 2, 16, True, 5), (1, 256, 2, 16, True, 1),
    (1, 256, 2, 16, True, 64), (1, 256, 2, 16, True, 100),
    (1, 256, 2, 16, True, 256), (1, 256, 2, 8, True, 40),
    (2, 300, 3, 128, True, None), (2, 200, 3, 33, True, 70),
    (8, 2048, 8, 64, False, None), (8, 2048, 8, 64, True, 512),
    (2, 7, 2, 129, False, None), (2, 256, 2, 129, True, None),
    (2, 256, 2, 192, True, 40), (2, 7, 2, 192, True, None),
    (2, 256, 2, 256, False, None), (2, 7, 2, 256, True, 40),
    (1, 300, 2, 256, True, None), (1, 16384, 2, 64, True, 512)])
def test_flash_attention_kernels_match_plain(cuda, case):
    b, t, h, d, causal, window = case
    q, k, v, do = _flash_inputs(cuda, b, t, h, d, seed=t + d,
                                packed=(t % 2 == 0))
    kw = dict(causal=causal, window=window)
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_dq.launches,
              fa.flash_attention_dkv.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, **kw)
    delta = fa.flash_delta(do, ref_out)
    dq = fa.flash_attention_dq(q, k, v, do, ref_lse, delta, **kw)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, ref_lse, delta, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == tuple(n + 1 for n in before)
    assert float((out - ref_out).abs().max()) <= 2e-5
    assert float((lse - ref_lse).abs().max()) <= 2e-5
    assert _rel(dq, fa.flash_dq_reference(q, k, v, do, ref_lse, delta,
                                          **kw)) <= 5e-4
    ref_dk, ref_dv = fa.flash_dkv_reference(q, k, v, do, ref_lse, delta,
                                            **kw)
    assert _rel(dk, ref_dk) <= 5e-4 and _rel(dv, ref_dv) <= 5e-4


def test_flash_attention_autograd_is_the_kernels(cuda):
    """flash_attention's forward is one K7 launch, its backward one K8
    and one K9; the grads are attention_reference's; two runs give the
    same bits (no atomics)."""
    q, k, v, _ = _flash_inputs(cuda, 2, 256, 2, 16, seed=3)
    grads = []
    for _ in range(2):
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        before = fa.flash_attention_fwd.launches, \
            fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches
        out = fa.flash_attention(*leaves, causal=True, window=40)
        grads.append(torch.autograd.grad((torch.sin(out) * out).sum(),
                                         leaves))
        torch.cuda.synchronize()
        assert (fa.flash_attention_fwd.launches,
                fa.flash_attention_dq.launches,
                fa.flash_attention_dkv.launches) == \
            tuple(n + 1 for n in before)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    ref = attention_reference(*leaves, causal=True, window=40)
    want = torch.autograd.grad((torch.sin(ref) * ref).sum(), leaves)
    for g1, g2, w in zip(*grads, want):
        assert torch.equal(g1, g2)
        assert float((g1 - w).abs().max()) <= 5e-4


def test_flash_attention_refuses_what_the_kernels_cannot_take(cuda):
    q, k, v, do = _flash_inputs(cuda, 1, 16, 2, 8, seed=0)
    with pytest.raises(ValueError):        # f64 operands
        fa.flash_attention_fwd(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):        # operands on two devices
        fa.flash_attention_fwd(q, k.cpu(), v)
    with pytest.raises(ValueError):        # head dim not unit stride
        fa.flash_attention_fwd(q.transpose(2, 3).contiguous().transpose(
            2, 3), k, v)
    with pytest.raises(ValueError):        # a window without causal
        fa.flash_attention_fwd(q, k, v, causal=False, window=4)


@pytest.mark.parametrize("d", [192, 256, 257, 320, 512, 1024])
def test_flash_attention_head_dims_past_128_on_the_card(cuda, d):
    """Head dims 192 and 256 (the kernels' 256 instantiation) and 257 to
    1024 (the wide path: operands streamed over D in chunks, output
    columns over grid.y): every entry against its plain version, each
    launching its kernel once, and the autograd Function against
    ``attention_reference``."""
    q, k, v, do = _flash_inputs(cuda, 1, 100, 2, d, seed=d)
    kw = dict(causal=True, window=70)
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_dq.launches,
              fa.flash_attention_dkv.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, **kw)
    assert float((out - ref_out).abs().max()) <= 2e-5
    assert float((lse - ref_lse).abs().max()) <= 2e-5
    delta = fa.flash_delta(do, ref_out)
    assert _rel(fa.flash_attention_dq(q, k, v, do, ref_lse, delta, **kw),
                fa.flash_dq_reference(q, k, v, do, ref_lse, delta,
                                      **kw)) <= 5e-4
    for got, want in zip(
            fa.flash_attention_dkv(q, k, v, do, ref_lse, delta, **kw),
            fa.flash_dkv_reference(q, k, v, do, ref_lse, delta, **kw)):
        assert _rel(got, want) <= 5e-4
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == tuple(n + 1 for n in before)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, **kw)
    grads = torch.autograd.grad((torch.sin(out) * out).sum(), leaves)
    ref_leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    ref = attention_reference(*ref_leaves, **kw)
    assert float((out - ref).abs().max()) <= 2e-5
    want = torch.autograd.grad((torch.sin(ref) * ref).sum(), ref_leaves)
    for g, w in zip(grads, want):
        assert _rel(g, w) <= 5e-4


def test_flash_kernels_are_bitwise_repeatable(cuda):
    """Two identical K7, K8 and K9 calls at the main path's shape give the
    same bits (each output is owned by one CTA, summed in a fixed order,
    no atomics)."""
    q, k, v, do = _flash_inputs(cuda, 8, 2048, 8, 64, seed=11)
    for kw in ({}, {"causal": True, "window": 512}):
        ref_out, lse = fa.flash_fwd_reference(q, k, v, **kw)
        delta = fa.flash_delta(do, ref_out)
        runs = [fa.flash_attention_fwd(q, k, v, **kw)
                + (fa.flash_attention_dq(q, k, v, do, lse, delta, **kw),)
                + fa.flash_attention_dkv(q, k, v, do, lse, delta, **kw)
                for _ in range(2)]
        torch.cuda.synchronize()
        for a, b in zip(*runs):
            assert torch.equal(a, b)


@pytest.mark.parametrize("window", [None, 512])
def test_flash_forward_accumulation_at_t16384(cuda, window):
    """K7 sums out and lse over up to T / 32 streamed key tiles: each
    tile's P.V starts at zero in the tensor cores and joins the f32
    register sum as ``acc * alpha + tile``, so the long chains hold 2e-6,
    10x inside the limit of 2e-5 (the form's own figure; the errors are
    printed)."""
    q, k, v, _ = _flash_inputs(cuda, 1, 16384, 1, 64, seed=6)
    kw = dict(causal=window is not None, window=window)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, **kw)
    errs = {"out": float((out - ref_out).abs().max()),
            "lse": float((lse - ref_lse).abs().max())}
    print("T=16384 window=%s: max|kernel - plain| %s" % (window, errs))
    assert max(errs.values()) <= 2e-6


@pytest.mark.parametrize("window", [None, 512])
def test_flash_backward_accumulation_at_t16384(cuda, window):
    """K8 / K9 sum dq, dk and dv over up to T / 16 streamed tiles: each
    tile's sum starts at zero in the tensor cores and joins the f32
    register sum with an IEEE add, so the long chains hold 1e-5 of
    max(1, max|plain|), 50x inside the limit of 5e-4 (the form's own
    figure; the error is printed)."""
    q, k, v, do = _flash_inputs(cuda, 1, 16384, 1, 64, seed=5)
    kw = dict(causal=window is not None, window=window)
    ref_out, lse = fa.flash_fwd_reference(q, k, v, **kw)
    delta = fa.flash_delta(do, ref_out)
    errs = {"dq": _rel(fa.flash_attention_dq(q, k, v, do, lse, delta, **kw),
                       fa.flash_dq_reference(q, k, v, do, lse, delta, **kw))}
    got = fa.flash_attention_dkv(q, k, v, do, lse, delta, **kw)
    want = fa.flash_dkv_reference(q, k, v, do, lse, delta, **kw)
    errs.update(dk=_rel(got[0], want[0]), dv=_rel(got[1], want[1]))
    print("T=16384 window=%s: max|kernel - plain| / max(1, max|plain|) %s"
          % (window, errs))
    assert max(errs.values()) <= 1e-5


def test_needle_training_on_the_card_matches_the_cpu(cuda):
    """Two epochs of the attention unit on the needle task (T=8, D=8, 2
    heads, as the JAX test trains it): the card (K7-K9) and the CPU
    (plain versions) agree on every epoch's n_err within 1 and on the
    weights within 1e-4; the card launched K7 once a step, K8 and K9
    once a train step."""
    wfs = {dev: chip_smoke.attention_workflow(
        600, 8, 8, 2, minibatch=50, epochs=2, device=dev, use_pallas=True)
        for dev in ("cuda", "cpu")}
    before = fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches
    wfs["cuda"].run()
    torch.cuda.synchronize()
    k7 = fa.flash_attention_fwd.launches - before[0]
    k8 = fa.flash_attention_dq.launches - before[1]
    wfs["cpu"].run()
    step = wfs["cuda"].fused_step
    assert (k7, k8) == (step.train_steps + step.eval_steps, step.train_steps)
    errs = {dev: wf.decision.epoch_n_err for dev, wf in wfs.items()}
    assert max(abs(a - b) for a, b in zip(errs["cuda"], errs["cpu"])) <= 1
    for f_card, f_host in zip(wfs["cuda"].forwards, wfs["cpu"].forwards):
        for name, value in f_card.host_params.items():
            assert numpy.abs(value - f_host.host_params[name]).max() <= 1e-4


def test_attention_unit_at_head_dim_256_on_the_card_matches_the_cpu(cuda):
    """The attention unit at d_model 512 with 2 heads (head dim 256) takes
    two train steps through K7-K9 on the card and through the plain
    versions on the CPU: losses and weights within chip_smoke's step
    limits."""
    wfs = {dev: chip_smoke.attention_workflow(
        16, 256, 512, 2, minibatch=4, epochs=1, device=dev,
        use_pallas=True, n_valid=4) for dev in ("cuda", "cpu")}
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
              fa.flash_attention_dkv.launches)
    card = chip_smoke.train_steps(wfs["cuda"], 2)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches - before[0],
            fa.flash_attention_dq.launches - before[1],
            fa.flash_attention_dkv.launches - before[2]) == (2, 2, 2)
    host = chip_smoke.train_steps(wfs["cpu"], 2)
    chip_smoke.steps_agree("attention D=256", card, chip_smoke.host_weights(
        wfs["cuda"]), host, chip_smoke.host_weights(wfs["cpu"]))


def test_attention_unit_at_head_dim_512_on_the_card_matches_the_cpu(cuda):
    """The attention unit at d_model 512 with one head (head dim 512, the
    kernels' wide path) takes two train steps through K7-K9 on the card
    and through the plain versions on the CPU: losses and weights within
    chip_smoke's step limits."""
    wfs = {dev: chip_smoke.attention_workflow(
        16, 256, 512, 1, minibatch=4, epochs=1, device=dev,
        use_pallas=True, n_valid=4) for dev in ("cuda", "cpu")}
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
              fa.flash_attention_dkv.launches)
    card = chip_smoke.train_steps(wfs["cuda"], 2)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches - before[0],
            fa.flash_attention_dq.launches - before[1],
            fa.flash_attention_dkv.launches - before[2]) == (2, 2, 2)
    host = chip_smoke.train_steps(wfs["cpu"], 2)
    chip_smoke.steps_agree("attention D=512", card, chip_smoke.host_weights(
        wfs["cuda"]), host, chip_smoke.host_weights(wfs["cpu"]))


def _lrn_err(a, r):
    return float((a - r).abs().max()) / max(1.0, float(r.abs().max()))


@pytest.mark.parametrize("c", [1, 7, 32, 96, 256, 5000])
@pytest.mark.parametrize("n", [1, 2, 4, 5])
def test_lrn_kernels_match_plain(cuda, n, c):
    gen = torch.Generator(device=cuda).manual_seed(n * 10000 + c)
    x = torch.randn((3, 5, 7, c), generator=gen, device=cuda) * 2.0
    g = torch.randn((3, 5, 7, c), generator=gen, device=cuda)
    params = (n, 0.5, 0.75, 2.0)
    before = lrn.lrn.launches, lrn.lrn_backward.launches
    y = lrn.lrn(x, *params)
    dx = lrn.lrn_backward(x, g, *params)
    torch.cuda.synchronize()
    assert (lrn.lrn.launches, lrn.lrn_backward.launches) == \
        (before[0] + 1, before[1] + 1)
    assert _lrn_err(y, lrn.lrn_reference(x, *params)) <= 1e-5
    assert _lrn_err(dx, lrn.lrn_backward_reference(x, g, *params)) <= 1e-5


def test_lrn_kernels_at_alexnet_shapes(cuda):
    for shape in ((128, 55, 55, 96), (128, 27, 27, 256)):
        gen = torch.Generator(device=cuda).manual_seed(shape[-1])
        x = torch.randn(shape, generator=gen, device=cuda) * 2.0
        g = torch.randn(shape, generator=gen, device=cuda)
        assert _lrn_err(lrn.lrn(x), lrn.lrn_reference(x)) <= 1e-5
        assert _lrn_err(lrn.lrn_backward(x, g),
                        lrn.lrn_backward_reference(x, g)) <= 1e-5


def test_lrn_pair_backward_is_k6(cuda):
    """``lrn_pair``'s forward launches K5 once and its backward K6 once;
    the gradient is K6's plain version's."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((4, 6, 6, 96), generator=gen, device=cuda)
    g = torch.randn((4, 6, 6, 96), generator=gen, device=cuda)
    xl = x.clone().requires_grad_(True)
    before = lrn.lrn.launches, lrn.lrn_backward.launches
    y = lrn.lrn_pair(xl, 4, 0.5)
    assert (lrn.lrn.launches, lrn.lrn_backward.launches) == \
        (before[0] + 1, before[1])
    (dx,) = torch.autograd.grad(y, xl, g)
    torch.cuda.synchronize()
    assert (lrn.lrn.launches, lrn.lrn_backward.launches) == \
        (before[0] + 1, before[1] + 1)
    assert _lrn_err(dx, lrn.lrn_backward_reference(x, g, 4, 0.5)) <= 1e-5


def test_local_response_norm_agrees_with_k5(cuda):
    """The library yardstick computes K5's function on the card too."""
    for n in (2, 5):
        gen = torch.Generator(device=cuda).manual_seed(n)
        x = torch.randn((8, 13, 13, 96), generator=gen, device=cuda) * 3.0
        lib = torch.nn.functional.local_response_norm(
            x.permute(0, 3, 1, 2), n, 0.3, 0.75, 1.5).permute(0, 2, 3, 1)
        assert _lrn_err(lrn.lrn(x, n, 0.3, 0.75, 1.5), lib) <= 1e-5


def test_lrn_refuses_what_the_kernels_cannot_take(cuda):
    x = torch.randn((2, 3, 3, 16), device=cuda)
    with pytest.raises(ValueError):        # f64
        lrn.lrn(x.double())
    with pytest.raises(ValueError):        # rows not dense
        lrn.lrn(x.permute(0, 3, 1, 2))
    with pytest.raises(ValueError):        # no channels
        lrn.lrn(torch.zeros((2, 0), device=cuda))
    with pytest.raises(ValueError):        # operands on two devices
        lrn.lrn_backward(x, x.cpu())
    with pytest.raises(ValueError):        # g of another shape
        lrn.lrn_backward(x, x[:1])


# Bit equality: where torch.pow takes its general path (beta 0.75 and
# 0.6 here; not 0.5, 1, 2 or 3) K5 and K6 give the plain versions' bits.

def _lrn_bitwise(x, g, params):
    """K5 and K6 against their plain versions, bit for bit, each launched
    once."""
    before = lrn.lrn.launches, lrn.lrn_backward.launches
    y = lrn.lrn(x, *params)
    dx = lrn.lrn_backward(x, g, *params)
    torch.cuda.synchronize()
    assert (lrn.lrn.launches, lrn.lrn_backward.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(y, lrn.lrn_reference(x, *params))
    assert torch.equal(dx, lrn.lrn_backward_reference(x, g, *params))


def _lrn_xg(dev, shape, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=dev) * 2.0,
            torch.randn(shape, generator=gen, device=dev))


@pytest.mark.parametrize("c", [1, 7, 32, 96, 256, 5000])
@pytest.mark.parametrize("n", [1, 2, 4, 5])
def test_lrn_kernels_equal_plain_bitwise(cuda, n, c):
    _lrn_bitwise(*_lrn_xg(cuda, (3, 5, 7, c), n * 10000 + c),
                 (n, 0.5, 0.75, 2.0))


@pytest.mark.parametrize("label,shape", chip_smoke.LRN_SHAPES)
def test_lrn_kernels_bitwise_at_the_main_paths_shapes(cuda, label, shape):
    """AlexNet's two LRN layers at minibatch 128 and the LRN convnet's
    two at minibatch 100."""
    _lrn_bitwise(*_lrn_xg(cuda, shape, shape[-1]), chip_smoke.LRN_PARAMS)


@pytest.mark.parametrize("case", range(len(chip_smoke.LRN_SMALL)))
def test_lrn_kernels_bitwise_at_chip_smokes_small_cases(cuda, case):
    shape, params = chip_smoke.LRN_SMALL[case]
    _lrn_bitwise(*_lrn_xg(cuda, shape, 300 + case), params)


@pytest.mark.parametrize("c", [5, 96, 1030])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 9])
def test_lrn_kernels_bitwise_every_window(cuda, n, c):
    """n 1-5 unrolled, 7 and 9 at run time; C % 4 != 0 (scalar copies),
    whole rows of quads, and rows split into chunks."""
    _lrn_bitwise(*_lrn_xg(cuda, (4, 3, c), 70 * n + c), (n, 0.5, 0.75, 2.0))


@pytest.mark.parametrize("c", [96, 7])
def test_lrn_kernels_bitwise_on_misaligned_bases(cuda, c):
    """Dense rows whose base is 4 bytes past a 16-byte boundary take the
    scalar instantiation, x and g alike."""
    gen = torch.Generator(device=cuda).manual_seed(c)
    rows = 37
    buf = torch.randn(2 * rows * c + 3, generator=gen, device=cuda) * 2.0
    x = buf[1:1 + rows * c].view(rows, c)
    g = buf[rows * c + 2:2 * rows * c + 2].view(rows, c)
    assert x.data_ptr() % 16 and g.data_ptr() % 16
    _lrn_bitwise(x, g, (5, 0.5, 0.75, 2.0))
    aligned = x.clone()
    _lrn_bitwise(aligned, g, (5, 0.5, 0.75, 2.0))


@pytest.mark.parametrize("rows", [1, 2, 7, 9, 1001])
def test_lrn_kernels_bitwise_on_ragged_row_counts(cuda, rows):
    """Row counts that fill no whole tile (C = 96: 8 rows a tile), a
    single row among them."""
    _lrn_bitwise(*_lrn_xg(cuda, (rows, 96), rows), (5, 1e-4, 0.75, 2.0))


def test_lrn_kernels_bitwise_past_one_wave_of_ctas(cuda):
    """Many more CTAs than the card holds at once (C = 32: a CTA takes 32
    rows, so 8449 CTAs against about 1300 resident, the last ragged)."""
    _lrn_bitwise(*_lrn_xg(cuda, (8448 * 32 + 5, 32), 17),
                 (5, 1e-4, 0.75, 2.0))


@pytest.mark.parametrize("c", [1025, 4100, 20000])
def test_lrn_kernels_bitwise_on_split_rows(cuda, c):
    """Rows past 1024 channels are cut into chunks whose pads carry their
    neighbours' squares and inner terms: any C, 20000 the widest here."""
    _lrn_bitwise(*_lrn_xg(cuda, (3, c), c), (5, 0.5, 0.75, 2.0))
    _lrn_bitwise(*_lrn_xg(cuda, (2, c), c + 1), (7, 0.5, 0.6, 1.5))


def test_lrn_kernels_are_bitwise_repeatable(cuda):
    """Two calls of each kernel at AlexNet's first LRN give the same bits
    (every element is one thread's, computed in a fixed order)."""
    x, g = _lrn_xg(cuda, (128, 55, 55, 96), 3)
    runs = [(lrn.lrn(x), lrn.lrn_backward(x, g)) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_threefry_bits_on_the_card_equal_the_cpu(cuda):
    key = prng.fold_in(prng.key(42), 11)
    for shape in ((7,), (128, 4096), (1000003,)):
        assert torch.equal(prng.random_bits(key, shape, cuda).cpu(),
                           prng.random_bits(key, shape, "cpu"))
        assert torch.equal(prng.bernoulli(key, 0.5, shape, cuda).cpu(),
                           prng.bernoulli(key, 0.5, shape, "cpu"))


def test_alexnet_steps_on_the_card_match_the_cpu(cuda):
    """Two AlexNet train steps (full widths, side 67, minibatch 8,
    dropout on) through K5/K6 on the card and their plain versions on
    the CPU."""
    loader = {"minibatch_size": 8, "n_train": 16, "n_valid": 8,
              "n_classes": 20, "side": 67}
    wfs = {dev: chip_smoke.alexnet_workflow(dev, use_pallas=True, epochs=1,
                                            **loader)
           for dev in ("cuda", "cpu")}
    before = lrn.lrn.launches, lrn.lrn_backward.launches
    card = chip_smoke.train_steps(wfs["cuda"], 2)
    torch.cuda.synchronize()
    assert (lrn.lrn.launches - before[0],
            lrn.lrn_backward.launches - before[1]) == (4, 4)
    host = chip_smoke.train_steps(wfs["cpu"], 2)
    chip_smoke.steps_agree("alexnet", card, chip_smoke.host_weights(
        wfs["cuda"]), host, chip_smoke.host_weights(wfs["cpu"]))
    keys = [[f.last_key for f in wf.forwards if f.stochastic]
            for wf in wfs.values()]
    assert keys[0] == keys[1] and len(keys[0]) == 2


# -- the int8-KV append (csrc/kv_append.cu) -----------------------------------

def _append_case(label):
    return next(c for c in chip_smoke.append_cases() if c[0] == label)[1:]


def _append_bitwise(q, s, blk, off, vals):
    """Kernel and plain version from clones of the same pool: every block
    but the trash block and every scale bitwise equal; the kernel's pool
    is returned for further appends."""
    kq, ks, rq, rs = q.clone(), s.clone(), q.clone(), s.clone()
    before = pa.kv_append_int8.launches
    pa.kv_append_int8(kq, ks, blk, off, vals)
    pa.kv_append_int8_reference(rq, rs, blk, off, vals)
    torch.cuda.synchronize()
    assert pa.kv_append_int8.launches == before + 1
    assert torch.equal(kq[1:], rq[1:])
    assert torch.equal(ks[1:], rs[1:])
    return kq, ks


@pytest.mark.parametrize("index_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("label", ["prefill", "verify", "realistic"])
def test_kv_append_int8_bitwise_at_the_phase2_shapes(cuda, label,
                                                     index_dtype):
    """chip_smoke's three phase-2 shapes, two appends in a row (the
    second reads the scales the first left)."""
    shape, blk, off = _append_case(label)
    q, s, tblk, toff, vals = chip_smoke.append_inputs(torch, cuda, shape,
                                                      blk, off, seed=3)
    tblk, toff = tblk.to(index_dtype), toff.to(index_dtype)
    q, s = _append_bitwise(q, s, tblk, toff, vals)
    _append_bitwise(q, s, tblk, toff, vals * 3.0)


def test_kv_append_int8_reopens_a_block_at_offset_zero(cuda):
    """A write at offset 0 wipes the block's earlier tenant: the bytes
    equal an append into a zeroed pool."""
    shape, blk, off = _append_case("prefill")
    q, s, tblk, toff, vals = chip_smoke.append_inputs(torch, cuda, shape,
                                                      blk, off, seed=4)
    assert bool((q[tblk[0]] != 0).any())
    kq, ks = _append_bitwise(q, s, tblk, toff, vals)
    zq, zs = torch.zeros_like(q), torch.zeros_like(s)
    pa.kv_append_int8(zq, zs, tblk, toff, vals)
    live = tblk[tblk > 0].unique()
    assert torch.equal(kq[live], zq[live])
    assert torch.equal(ks[live], zs[live])


def test_kv_append_int8_scale_grows_mid_block(cuda):
    """Values that grow along a block make each write raise the scale
    and rescale the rows before it."""
    bs, h, d = 16, 4, 16
    q = torch.zeros((3, bs, h, d), dtype=torch.int8, device=cuda)
    s = torch.zeros((3, h), dtype=torch.float32, device=cuda)
    blk = torch.tensor([1] * bs + [2] * 5, device=cuda)
    off = torch.tensor(list(range(bs)) + list(range(5)), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    growth = torch.arange(1, bs + 6, device=cuda, dtype=torch.float32)
    vals = (torch.randn((bs + 5, h, d), generator=gen, device=cuda)
            * growth[:, None, None] ** 2)
    kq, ks = _append_bitwise(q, s, blk, off, vals)
    amax = vals[:bs].abs().amax(dim=(0, 2)) / 127.0
    assert float((ks[1] - amax).abs().max()) <= 1e-6 * float(amax.max())
    assert int(kq[1, 0].abs().max()) < 127      # rescaled down


def test_kv_append_int8_all_zero_rows(cuda):
    """An all-zero row opening a block (scale 0, stored as is), then a
    zero row mid-block, then a row that opens the scale."""
    bs, h, d = 8, 2, 16
    q = torch.full((2, bs, h, d), 5, dtype=torch.int8, device=cuda)
    s = torch.full((2, h), 0.5, dtype=torch.float32, device=cuda)
    blk = torch.ones(4, dtype=torch.int32, device=cuda)
    off = torch.arange(4, dtype=torch.int32, device=cuda)
    vals = torch.zeros((4, h, d), device=cuda)
    vals[2] = torch.linspace(-2.0, 3.0, h * d, device=cuda).reshape(h, d)
    kq, ks = _append_bitwise(q, s, blk, off, vals)
    assert int(kq[1, :2].abs().max()) == 0 and int(kq[1, 2].abs().max()) > 0
    assert int(kq[1, 4:].abs().max()) == 0      # reopened: wiped


def _append_pool(dev, shape, seed):
    """A pool holding earlier content, as chip_smoke's."""
    rng = numpy.random.RandomState(seed)
    return (torch.tensor(rng.randint(-127, 128, shape), dtype=torch.int8,
                         device=dev),
            torch.tensor(rng.uniform(0, 0.05, (shape[0], shape[2])),
                         dtype=torch.float32, device=dev))


@pytest.mark.parametrize("index_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("d", [16, 128, 256])
@pytest.mark.parametrize("bs", [16, 32, 64])
def test_kv_append_int8_growing_runs_from_mid_block(cuda, bs, d,
                                                    index_dtype):
    """One sequence from offset 5 of a block holding an earlier call's
    content over three blocks, its values growing with the position, so
    the scale grows on most writes (runs of up to 64 writes: two warp
    segments at block size 64); then a second call continues the same
    blocks."""
    n = 2 * bs + 7
    pos = 5 + numpy.arange(n)
    table = numpy.array([6, 2, 8])
    q, s = _append_pool(cuda, (9, bs, 2, d), seed=bs + d)
    blk = torch.tensor(table[pos // bs], device=cuda).to(index_dtype)
    off = torch.tensor(pos % bs, device=cuda).to(index_dtype)
    gen = torch.Generator(device=cuda).manual_seed(bs + d)
    growth = torch.arange(1, n + 1, device=cuda, dtype=torch.float32)
    vals = (torch.randn((n, 2, d), generator=gen, device=cuda)
            * growth[:, None, None] ** 2)
    q, s = _append_bitwise(q, s, blk, off, vals)
    _append_bitwise(q, s, blk, off, vals * 3.0)


def test_kv_append_int8_reopen_mid_call_and_trash_padding(cuda):
    """A [2, 24] call: row 0 fills a block from offset 8 and reopens the
    next at offset 0 in mid-call; row 1 writes 19 positions and pads the
    rest into the trash block."""
    bs = 16
    pos = numpy.arange(24)
    blk = numpy.stack([numpy.array([3, 5])[(pos + 8) // bs],
                       numpy.where(pos < 19, numpy.array([7, 2])[
                           numpy.minimum(pos // bs, 1)], 0)])
    off = numpy.stack([(pos + 8) % bs, pos % bs])
    q, s = _append_pool(cuda, (9, bs, 4, 16), seed=7)
    gen = torch.Generator(device=cuda).manual_seed(7)
    vals = torch.randn((2, 24, 4, 16), generator=gen, device=cuda)
    for dtype in (torch.int64, torch.int32):
        _append_bitwise(q, s, torch.tensor(blk, device=cuda).to(dtype),
                        torch.tensor(off, device=cuda).to(dtype), vals)


@pytest.mark.parametrize("index_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("rows", [32, 64])
def test_kv_append_int8_decode_step_with_more_runs_than_warps(cuda, rows,
                                                              index_dtype):
    """A decode step of 32 or 64 rows at block size 16, one position a row
    into a block of its own (row 3 pads into the trash block): a chunk
    holds more runs than its CTA has warps, so each warp takes runs in
    turn, rewriting its shared arrays between them; two steps in a
    row."""
    rng = numpy.random.RandomState(rows)
    blk = (1 + rng.permutation(2 * rows)[:rows])[:, None]
    blk[3] = 0
    q, s = _append_pool(cuda, (2 * rows + 1, 16, 4, 16), seed=rows)
    tblk = torch.tensor(blk, device=cuda).to(index_dtype)
    toff = torch.tensor(rng.randint(1, 16, (rows, 1)),
                        device=cuda).to(index_dtype)
    gen = torch.Generator(device=cuda).manual_seed(rows)
    vals = torch.randn((rows, 1, 4, 16), generator=gen, device=cuda)
    q, s = _append_bitwise(q, s, tblk, toff, vals)
    _append_bitwise(q, s, tblk, toff + 1 - (toff == 15).to(index_dtype) * 15,
                    vals * 3.0)


@pytest.mark.parametrize("d", [12, 5])
def test_kv_append_int8_ragged_head_dims_and_misaligned_values(cuda, d):
    """Head dims that take 4-byte and 1-byte lanes, and values that start
    4 bytes past an aligned address."""
    blk = torch.tensor([1] * 8 + [2] * 3, device=cuda)
    off = torch.tensor(list(range(8)) + list(range(3)), device=cuda)
    q, s = _append_pool(cuda, (5, 8, 3, d), seed=d)
    buf = torch.randn(11 * 3 * d + 1, device=cuda)
    _append_bitwise(q, s, blk, off, buf[:-1].view(11, 3, d))
    _append_bitwise(q, s, blk, off, buf[1:].view(11, 3, d))


def test_kv_append_int8_chunked_equals_one_call_and_adds_no_sync(cuda):
    """The README prefill written in 32-position chunks gives the bytes
    of one call, and a call under sync debug mode "error" raises
    nothing."""
    shape, blk, off = _append_case("prefill")
    q, s, tblk, toff, vals = chip_smoke.append_inputs(torch, cuda, shape,
                                                      blk, off, seed=6)
    whole_q, whole_s = q.clone(), s.clone()
    pa.kv_append_int8(whole_q, whole_s, tblk, toff, vals)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for start in range(0, tblk.numel(), 32):
            pa.kv_append_int8(q, s, tblk[start:start + 32],
                              toff[start:start + 32],
                              vals[start:start + 32])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(q[1:], whole_q[1:]) and torch.equal(s[1:],
                                                           whole_s[1:])


# -- the tiered KV cache and KV checkpoints -----------------------------------

@pytest.mark.parametrize("tier", ["host", "disk"])
@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_tier_round_trip_on_the_card_equals_the_cpu(cuda, tmp_path,
                                                    kv_dtype, tier):
    """The same seeded pools on the card and on the CPU: each block's
    demote (gather, ``pack_block``, put) and readmit (get,
    ``unpack_block``, scatter) gives the same wire bytes and the same
    pools, bit for bit."""
    from veles_tpu_torch.kvtier import TieredKVStore
    runs = []
    for i, dev in enumerate((cuda, torch.device("cpu"))):
        store = (TieredKVStore(host_bytes=1 << 30) if tier == "host"
                 else TieredKVStore(disk_dir=str(tmp_path / str(i))))
        runs.append(chip_smoke.tier_round_trip(
            torch, dev, kv_dtype, (64, 16, 8, 128), [3, 17, 40], store,
            on_host=True))
    assert runs[0][0] == runs[1][0]
    assert len(runs[0][1]) == (8 if kv_dtype == "int8" else 4)
    for a, b in zip(runs[0][1], runs[1][1]):
        assert a.dtype == b.dtype and numpy.array_equal(a, b)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_restore_kv_on_the_card_resumes_with_the_cpu_tokens(cuda, tmp_path,
                                                            kv_dtype):
    """A scheduler cut mid-generation on the CPU restores into one on the
    card: the pools land on the card, and each resumed sequence (K1, or
    K2 and the append) emits the CPU run's tokens."""
    from veles_tpu_torch.checkpoint import load_state
    from veles_tpu_torch.serving import DecodeScheduler
    from veles_tpu_torch.znicz.samples.flagship import FlagshipDecodeModel
    geo = dict(stages=2, experts=2, d=16, heads=2, hidden=32, vocab=32,
               seed=0, kv_dtype=kv_dtype)
    geom = dict(max_batch=4, block_size=4, max_prompt_len=8,
                max_new_tokens=16, kv_dtype=kv_dtype)
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7]]
    cpu_model = FlagshipDecodeModel(**geo, device="cpu")
    cpu_model.step_host_delay = 0.02
    src = DecodeScheduler(cpu_model, name="ckcpu", device="cpu", **geom)
    try:
        futures = [src.submit(p, 16) for p in prompts]
        chip_smoke._wait_rows(src, len(prompts))
        path = src.checkpoint_kv(str(tmp_path))
        whole = [f.result(60)["tokens"] for f in futures]
    finally:
        src.close()
    by_row = {s["row"]: [int(t) for t in s["prompt"]]
              for s in load_state(path)["sessions"]}
    assert len(by_row) == len(prompts)
    launches = pa.paged_attention.launches
    dst = DecodeScheduler(FlagshipDecodeModel(**geo), name="ckcard", **geom)
    try:
        restored = dst.restore_kv(path)
        assert all(t.device.type == "cuda" for t in dst._pool_tensors())
        for row, future in restored.items():
            assert future.result(60)["tokens"] == \
                whole[prompts.index(by_row[row])], row
    finally:
        dst.close()
    assert pa.paged_attention.launches > launches


# -- the autotune sites' candidates (the plans a tuning record may pick) ------

def _site_candidates(name, ctx):
    from veles_tpu_torch.autotune import space
    return space.site(name).candidates(ctx)


@pytest.mark.parametrize("shape", [(60, 784, 100), (37, 1000, 10),
                                   (300, 2049, 70), (512, 4096, 512)])
@pytest.mark.parametrize("level", [1, 2])
def test_precise_gemm_site_candidates_bitwise_and_plain(cuda, shape,
                                                        level):
    """Each ``precise_gemm`` split (the rule, none, runs of 1-8 K tiles)
    gives the default's bits, within 1e-6 of ``max(|a| @ |b|)`` of the
    plain version; a split launches the fold, none does not."""
    m, k, n = shape
    a, b = _precise_inputs(cuda, m, k, n, seed=m + k)
    cands = _site_candidates("precise_gemm", {"m": m, "k": k, "n": n,
                                              "level": level})
    assert len(cands) >= 2
    want = gemm._precise_launch(a, b, level, gemm.split_runs(
        "rule", m, n, k, cuda))
    plain = gemm.precise_matmul_reference(a, b, level)
    scale = float((a.abs() @ b.abs()).max())
    for cfg in cands:
        runs = gemm.split_runs(cfg["split"], m, n, k, cuda)
        folds = gemm.precise_matmul.fold_launches
        out = gemm._precise_launch(a, b, level, runs)
        torch.cuda.synchronize()
        assert gemm.precise_matmul.fold_launches == folds + bool(runs)
        assert torch.equal(out, want), cfg
        assert float((out - plain).abs().max()) <= 1e-6 * scale, cfg


@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_site_candidates_match_plain(cuda, quant):
    """Each ``paged_attention`` split at chip_smoke's realistic shape
    (B=32 H=8 D=128, 128 blocks of 16) within 1e-5 of the plain
    version."""
    label, (b, h, d, bs, nb), lengths = chip_smoke.paged_cases()[1]
    q, kp, vp, table, lens = _paged_inputs(cuda, b, h, d, bs, nb, lengths,
                                           seed=11)
    kp, vp, scales = _quantized(kp, vp, quant)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    cands = _site_candidates("paged_attention", {
        "batch": b, "heads": h, "d": d, "block_size": bs,
        "max_blocks": nb, "quantized": quant})
    assert len(cands) == 6
    for cfg in cands:
        plan = pa.plan_for_split(cfg["split"], b, h, d, bs, nb, sms,
                                 quantized=quant)
        merges = pa.paged_attention.merge_launches
        out = pa._paged_launch(q, kp, vp, table, lens, None,
                               scales.get("k_scales"),
                               scales.get("v_scales"), plan)
        torch.cuda.synchronize()
        assert pa.paged_attention.merge_launches == \
            merges + (plan.split > 1)
        assert _paged_err(out, q, kp, vp, table, lens, **scales) <= 1e-5, \
            cfg


@pytest.mark.parametrize("case", [(2, 300, 2, 64, True, None),
                                  (1, 130, 3, 48, False, None),
                                  (8, 2048, 8, 64, False, None),
                                  (8, 2048, 8, 64, True, 512),
                                  (2, 200, 2, 40, True, 70)])
def test_flash_site_candidates_match_plain(cuda, case):
    """Each ``flash_attention`` / ``window_attention`` candidate at head
    dims 33-64 (K7's key tile 32 or 64, K8's 32 or 16, K9's query tile
    32 or 16): out and lse within 2e-5, each gradient within 5e-4 of
    max(1, max|plain|)."""
    b, t, h, d, causal, window = case
    q, k, v, do = _flash_inputs(cuda, b, t, h, d, seed=t + d)
    kw = dict(causal=causal, window=window)
    name = "window_attention" if window else "flash_attention"
    ctx = {"t": t, "d": d, "causal": causal, "window": window}
    cands = _site_candidates(name, ctx)
    assert len(cands) == 8
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, **kw)
    delta = fa.flash_delta(do, ref_out)
    ref_dq = fa.flash_dq_reference(q, k, v, do, ref_lse, delta, **kw)
    ref_dk, ref_dv = fa.flash_dkv_reference(q, k, v, do, ref_lse, delta,
                                            **kw)
    for tiles in cands:
        out, lse = fa.flash_attention_fwd(q, k, v, tiles=tiles, **kw)
        dq = fa.flash_attention_dq(q, k, v, do, ref_lse, delta,
                                   tiles=tiles, **kw)
        dk, dv = fa.flash_attention_dkv(q, k, v, do, ref_lse, delta,
                                        tiles=tiles, **kw)
        torch.cuda.synchronize()
        assert float((out - ref_out).abs().max()) <= 2e-5, tiles
        assert float((lse - ref_lse).abs().max()) <= 2e-5, tiles
        assert _rel(dq, ref_dq) <= 5e-4, tiles
        assert _rel(dk, ref_dk) <= 5e-4 and _rel(dv, ref_dv) <= 5e-4, tiles


def test_a_tile_no_instantiation_has_raises(cuda):
    """A tuned choice that cannot launch raises; nothing falls back."""
    from veles_tpu_torch.autotune import space
    q, k, v, do = _flash_inputs(cuda, 1, 64, 1, 128, seed=3)
    bad = dict(space.flash_plan_tiles(128), fwd_block_k=64)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fa.flash_attention_fwd(q, k, v, tiles=bad)
    a, b = _precise_inputs(cuda, 8, 300, 8, seed=1)
    with pytest.raises(RuntimeError, match="CUDA error"):
        gemm._precise_launch(a, b, 1, 3)       # 2 K tiles, 3 runs


def test_tuned_plans_reach_the_kernels(cuda, tmp_path):
    """Records in a tuning directory reach K4's split and the flash
    tiles through the ordinary entry points; the tuner off gives the
    plans back, and every output is bit-equal to an explicit call."""
    from veles_tpu_torch.autotune import dispatch, space, store
    from veles_tpu_torch.config import root
    st = store.TuningStore(str(tmp_path))
    st.put("precise_gemm", "m64_k1024_n128_l1", {"split": 2},
           default={"split": "rule"}, speedup=1.0)
    tiles = {"fwd_block_k": 64, "dq_block_k": 16, "dkv_block_q": 16}
    st.put("flash_attention", "t512_d64_causal", tiles,
           default=space.flash_plan_tiles(64), speedup=1.0)
    a, b = _precise_inputs(cuda, 60, 784, 100, seed=2)
    q, k, v, do = _flash_inputs(cuda, 2, 300, 2, 64, seed=4)
    prior = root.common.autotune.get("dir", None)
    try:
        root.common.autotune.dir = str(tmp_path)
        dispatch.reset_default_stores()
        assert gemm.precise_split(60, 100, 784, 1, cuda) == 2
        tuned = gemm.precise_matmul(a, b, 1)
        assert fa.flash_tiles(q, True) == tiles
        out = fa.flash_attention(q, k, v, causal=True)
        want = fa.flash_attention_fwd(q, k, v, True, tiles=tiles)[0]
        assert torch.equal(out, want)
    finally:
        root.common.autotune.dir = prior
        dispatch.reset_default_stores()
    assert gemm.precise_split(60, 100, 784, 1, cuda) == 4   # the rule
    assert torch.equal(tuned, gemm.precise_matmul(a, b, 1))
    assert fa.flash_tiles(q, True) == space.flash_plan_tiles(64)
