"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test takes the ``cuda`` fixture, which skips when
torch sees no CUDA device (decided inside the fixture, never while the
module is imported, so every pytest worker collects the same tests).
On a machine with a card, run them without the JAX test configuration:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: paged attention ``max|kernel - plain| <= 1e-5`` (another
summation order and ``expf``); the quantized GEMM
``max|kernel - plain| <= 1e-5 * max|plain|`` (per-element f32 FMA
chains against cuBLAS's blocked sums).
"""

import numpy
import pytest
import torch

from veles_tpu_torch.znicz import gemm
from veles_tpu_torch.znicz import paged_attention as pa

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


@pytest.mark.parametrize("d", [16, 24, 128, 200, 256])
@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_matches_plain(cuda, d, quant):
    bs, nb = 4, 6
    lengths = [0, 1, bs - 1, bs + 1, nb * bs, 7]
    q, kp, vp, table, lens = _paged_inputs(cuda, len(lengths), 3, d, bs,
                                           nb, lengths, seed=d)
    scales = {}
    if quant:
        kp, ks = pa.quantize_pool(kp)
        vp, vs = pa.quantize_pool(vp)
        scales = {"k_scales": ks, "v_scales": vs}
    before = pa.paged_attention.launches
    out = pa.paged_attention(q, kp, vp, table, lens, **scales)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    ref = pa.paged_attention_reference(q, kp, vp, table, lens, **scales)
    assert float((out - ref).abs().max()) <= 1e-5
    assert torch.equal(out[0], torch.zeros_like(out[0]))   # length 0


def test_paged_attention_large_score_row(cuda):
    """A score row past 48 KB of shared memory takes the opt-in path."""
    bs, nb = 64, 256                     # 16384 scores = 64 KB
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
    big = torch.zeros((2, 60000), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):        # score row past 227 KB
        pa.paged_attention(q, kp[:, :1].contiguous(),
                           vp[:, :1].contiguous(), big, lens)


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
