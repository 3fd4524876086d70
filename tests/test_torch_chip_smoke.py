"""The bookkeeping of ``chip_smoke.py`` that needs no card.

- The traced busy time counts each kernel once.  ``key_averages()``
  lists a host op (``aten::mm``, an autograd Function such as
  ``_PreciseMatmul``) with the time of the kernels it launched as its
  own self device time, and lists those kernels again as device rows;
  summing every row counted each kernel twice.  A traced run's record
  names the device copies and cuDNN's layout transforms, and sums the
  int64 elementwise kernels (dropout's threefry draws).  A traced run
  whose trace holds no device time is traced again on a fresh run, up
  to ``TRACE_TRIES``; one with no device time in every try fails.  A
  traced run sums K1's and K2's launches (and their merge), K3's and
  K4's products and folds, and the int8-KV append's.  A kernel's profile
  whose launch count is short of the calls' lost records and is taken
  again.
- The ``kernels`` line holds every kernel of the main paths (slice 3's
  flash attention K7-K9 and slice 4's LRN pair K5/K6 included), refuses
  one that never launched there or was never measured, and carries K4's
  level 0 (on no main path: ``precise_gemm=0`` means plain matmuls)
  inside the level-1 entry.  K3's and K4's entries carry the profiler's
  device time, the split and the CUDA-core bound (K3 its tile too); a
  record without them fails.
- The int8-KV append's phase-2 cases are the README prefill (padded
  into the trash block), a verify span and a realistic prefill, each
  block's writes one contiguous run; phase 3b's two turns share the
  system prefix and fit the README server.
- Phase 3c's traffic overflows its tiered pool (so turn 1's chains must
  leave the card) and fits the README server; its realistic pool is
  phase 2's 1.07 GB; a path that launched no paged attention (or, int8,
  no append, or f32, an append) fails, as does a differing answer; a
  block's demote and readmit is bitwise on the CPU and a readmit that
  differs fails.
- The helpers of the AlexNet and LRN convnet phases: the LRN form is set
  on the LRN layers only, and ``steps_agree`` refuses a step that
  differs past its limits.
- The work a masked attention call needs is counted from the mask, and
  the needle loader makes the JAX test's data.
- Phase 3e (the autotuner and the build cache) runs in ``main()`` after
  phase 3d and before phase 4b, inside the build cache the fleet of 3d
  shares; its cases are the sites it must tune, each with a choice; its
  tuning step runs through real isolated subprocesses (on the CPU
  here); and its fresh-process verdict refuses a restart that ran
  ``nvcc``, missed the build cache, changed the cache's listing,
  resolved a site untuned or served a token off the oracle.
- The rehearsals of the later phases are files of their own, so that
  ``pytest-xdist --dist loadfile`` spreads them over its workers:
  ``test_torch_chip_smoke_3f.py`` (exported packages),
  ``_4e.py`` (graph mode), ``_4f.py`` (snapshots), ``_4g.py`` (STL-10
  and VideoAE) and ``_4h.py`` (stochastic pooling); what they share is
  in ``tests/_chip_smoke_shared.py``.
"""

import os
import sys

import numpy
import pytest
import torch

from _chip_smoke_shared import ROOT, chip_smoke


class _Row:
    def __init__(self, key, us, count, device):
        self.key, self.self_device_time_total, self.count = key, us, count
        self.device_type = device


def test_device_busy_counts_each_kernel_once():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    rows = [_Row("_PreciseMatmul", 22.8, 468, cpu),
            _Row("_PreciseMatmulBackward", 4.1, 400, cpu),
            _Row("precise_matmul_kernel<1>", 26.9, 868, cuda),
            _Row("aten::mm", 5.4, 1068, cpu),
            _Row("sgemm", 5.4, 1068, cuda),
            _Row("Memcpy HtoD", 0.2, 234, cuda),
            _Row("aten::empty", 0.0, 99, cpu)]
    got = chip_smoke.device_rows(rows)
    assert [k for _, _, k in got] == ["precise_matmul_kernel<1>", "sgemm",
                                      "Memcpy HtoD"]
    assert sum(t for t, _, _ in got) == pytest.approx(32.5)


class _Prof:
    def __init__(self, rows):
        self.rows = rows

    def key_averages(self):
        return self.rows

    def events(self):
        return self.rows


def test_trace_record_names_copies_transforms_and_int64_work():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    rows = [_Row("sm80_xmma_fprop_implicit_gemm_f32", 400.0, 36, cuda),
            _Row("cudnn::engines_precompiled::nhwcToNchwKernel<float>", 7.0,
                 368, cuda),
            _Row("elementwise_kernel<direct_copy_kernel_cuda>", 1.5, 154,
                 cuda),
            _Row("vectorized_elementwise_kernel<4, BitwiseXorFunctor<long>>",
                 2.0, 40, cuda),
            _Row("aten::copy_", 9.0, 10, cpu)]
    rec = chip_smoke._trace_record(_Prof(rows), "t", "card", 0.5, top=2)
    assert rec["device_busy_ms"] == pytest.approx(0.4105)
    assert [e["kernel"] for e in rec["top"]] == [
        "sm80_xmma_fprop_implicit_gemm_f32",
        "cudnn::engines_precompiled::nhwcToNchwKernel<float>"]
    assert [e["count"] for e in rec["copies"]] == [368, 154]
    assert rec["int64_elementwise_ms"] == pytest.approx(0.002)
    assert rec["int64_elementwise_launches"] == 40


def _fake_tracer(monkeypatch, traces):
    """``torch.profiler.profile`` replaced by one that hands out the row
    lists of ``traces`` in turn; -> a torch stand-in whose
    ``cuda.synchronize`` does nothing."""
    import contextlib
    import types
    traces = iter(traces)

    @contextlib.contextmanager
    def profile(**_):
        yield _Prof(next(traces))
    monkeypatch.setattr(torch.profiler, "profile", profile)
    return types.SimpleNamespace(
        cuda=types.SimpleNamespace(synchronize=lambda: None))


def test_a_lost_trace_is_taken_again_on_a_fresh_run(monkeypatch):
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    lost = [_Row("aten::mm", 5.0, 10, cpu)]
    kept = lost + [_Row("sgemm", 5.0, 10, cuda)]
    fake = _fake_tracer(monkeypatch, [lost, kept])
    made, ran, closed = [], [], []

    def make():
        made.append(len(made))
        return (lambda: ran.append(made[-1])), (lambda: closed.append(1))
    rec = chip_smoke._traced(fake, "t", "card", make)
    assert rec["tries"] == 2 and rec["device_launches"] == 10
    assert made == ran == [0, 1] and len(closed) == 2


def test_a_run_with_no_device_time_fails_every_try(monkeypatch):
    cpu = torch.autograd.DeviceType.CPU
    n = chip_smoke.TRACE_TRIES
    fake = _fake_tracer(monkeypatch,
                        [[_Row("aten::mm", 5.0, 10, cpu)]] * (n + 1))
    made = []

    def make():
        made.append(1)
        return (lambda: None), (lambda: None)
    with pytest.raises(chip_smoke.TraceLost, match="ran nothing on the card"):
        chip_smoke._traced(fake, "t", "card", make)
    assert len(made) == n


def test_trace_record_sums_k3_and_k4():
    cuda = torch.autograd.DeviceType.CUDA
    rows = [_Row("void (anonymous namespace)::quantized_matmul_kernel<"
                 "(anonymous namespace)::Int8, Tile<16, 32>>", 3000.0, 496,
                 cuda),
            _Row("void (anonymous namespace)::quantized_matmul_kernel<"
                 "(anonymous namespace)::Int8, Tile<64, 64>>", 1500.0, 128,
                 cuda),
            _Row("(anonymous namespace)::quantized_fold_kernel", 500.0, 20,
                 cuda),
            _Row("precise_matmul_kernel<1, true, true>", 2000.0, 10, cuda)]
    rec = chip_smoke._trace_record(_Prof(rows), "t", "card", 0.5)
    assert rec["k3_ms"] == pytest.approx(4.5) and rec["k3_launches"] == 624
    assert rec["k3_fold_ms"] == pytest.approx(0.5)
    assert rec["k3_fold_launches"] == 20
    assert rec["k4_ms"] == pytest.approx(2.0) and rec["k4_launches"] == 10
    assert rec["k4_fold_ms"] == 0 and rec["k4_fold_launches"] == 0


def test_trace_record_sums_k5_and_k6():
    """The LRN pair's device time and launches over every instantiation
    of each kernel, none where the run took the band form."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = [_Row("void (anonymous namespace)::lrn_fwd_kernel<5, true>("
                 "float const*, float*, (anonymous namespace)::Plan, float, "
                 "float, float)", 800.0, 4, cuda),
            _Row("void (anonymous namespace)::lrn_fwd_kernel<0, false>",
                 100.0, 2, cuda),
            _Row("void (anonymous namespace)::lrn_bwd_kernel<5, true>",
                 1200.0, 4, cuda),
            _Row("sgemm", 5000.0, 10, cuda)]
    rec = chip_smoke._trace_record(_Prof(rows), "t", "card", 0.5)
    assert rec["k5_ms"] == pytest.approx(0.9) and rec["k5_launches"] == 6
    assert rec["k6_ms"] == pytest.approx(1.2) and rec["k6_launches"] == 4
    rec = chip_smoke._trace_record(_Prof(rows[3:]), "t", "card", 0.5)
    assert (rec["k5_ms"], rec["k5_launches"], rec["k6_launches"]) == \
        (0, 0, 0)


def test_trace_record_sums_the_append():
    """The int8-KV append's device time and launches over both index
    types, none in a run with f32 pools."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = [_Row("void (anonymous namespace)::kv_append_int8_kernel<long>"
                 "(signed char*, float*, long const*, long const*, float "
                 "const*, int, int, int, int)", 40.0, 4, cuda),
            _Row("void (anonymous namespace)::kv_append_int8_kernel<int>",
                 10.0, 2, cuda),
            _Row("sgemm", 5000.0, 10, cuda)]
    rec = chip_smoke._trace_record(_Prof(rows), "t", "card", 0.5)
    assert rec["append_ms"] == pytest.approx(0.05)
    assert rec["append_launches"] == 6
    rec = chip_smoke._trace_record(_Prof(rows[2:]), "t", "card", 0.5)
    assert (rec["append_ms"], rec["append_launches"]) == (0, 0)


def test_append_cases_and_turn_prompts():
    """Each append case writes every block in one contiguous run (what
    the kernel relies on), the prefill pads into the trash block, the
    verify span is [16, 5]; phase 3b's turns share a 64-token prefix
    and fit the README server."""
    cases = {label: (shape, blk, off)
             for label, shape, blk, off in chip_smoke.append_cases()}
    assert list(cases) == ["prefill", "verify", "realistic"]
    for label, (shape, blk, off) in cases.items():
        flat = blk.reshape(-1).tolist()
        runs = [b for i, b in enumerate(flat)
                if b and (i == 0 or flat[i - 1] != b)]
        assert len(runs) == len(set(runs)), label
        assert max(flat) < shape[0] and off.max() < shape[1]
    assert cases["prefill"][1].shape == (128,)
    assert (cases["prefill"][1][100:] == 0).all()
    assert cases["verify"][1].shape == (16, 5)
    assert cases["realistic"][2].shape == (2048,)
    assert cases["realistic"][0][2:] == (8, 128)
    turn1 = chip_smoke.turn1_prompts()
    answers = [[1] * chip_smoke.NEW_TOKENS for _ in turn1]
    turn2 = chip_smoke.turn2_prompts(turn1, answers)
    assert len(turn1) == len(turn2) == chip_smoke.N_REQUESTS
    system = turn1[0][:chip_smoke.SYSTEM_TOKENS]
    for p, q in zip(turn1, turn2):
        assert p[:64] == system and 72 <= len(p) <= 88
        assert q[:len(p)] == p and len(q) == len(p) + 32 + 8
        assert len(q) <= chip_smoke.README_SERVER["max_prompt_len"]


def test_phase3c_traffic_and_sizes():
    cs = chip_smoke
    fillers = cs.filler_prompts()
    assert len(fillers) == cs.N_FILLERS == len({tuple(f) for f in fillers})
    assert all(len(f) == cs.FILLER_TOKENS for f in fillers)
    bs = cs.README_SERVER["block_size"]
    context = (cs.README_SERVER["max_prompt_len"]
               + cs.README_SERVER["max_new_tokens"])
    assert cs.TIER_BLOCKS - 1 >= -(-context // bs)    # one max context fits

    def blocks(prompts, new):
        return sum(-(-(len(p) + new) // bs) for p in prompts)
    # turn 1's conversations and the fillers cannot all stay on the card
    turn1 = cs.turn1_prompts()
    assert blocks(turn1, cs.NEW_TOKENS) + blocks(
        fillers, cs.FILLER_NEW) > 2 * cs.TIER_BLOCKS
    assert cs.TIER_HOST_BLOCKS < blocks(turn1, cs.NEW_TOKENS)
    nb, bs_real, h, hd = cs.REAL_POOL
    assert 4 * nb * bs_real * h * hd * 4 == 1 << 30      # 1.07 GB of f32
    assert cs.REAL_SESSIONS * -(-(cs.REAL_PROMPT + cs.REAL_NEW)
                                // bs_real) < nb


def test_phase3c_refuses_missing_launches_and_wrong_answers():
    class Counted:
        def __init__(self, n):
            self.launches = n

    class Pa:
        def __init__(self, paged, append):
            self.paged_attention = Counted(paged)
            self.kv_append_int8 = Counted(append)
    assert chip_smoke._read_launches(Pa(3, 0), "f32", "f32") == {
        "paged_attention": 3, "kv_append_int8": 0}
    assert chip_smoke._read_launches(Pa(3, 2), "int8", "int8")[
        "kv_append_int8"] == 2
    for paged, append, kv in ((0, 0, "f32"), (3, 1, "f32"), (3, 0, "int8"),
                              (0, 2, "int8")):
        with pytest.raises(AssertionError, match="did not run"):
            chip_smoke._read_launches(Pa(paged, append), kv, kv)
    chip_smoke._held("x", [[1, 2]], [[1, 2]], "oracle")
    with pytest.raises(AssertionError, match="differ from oracle"):
        chip_smoke._held("x", [[1, 2], [3]], [[1, 2], [4]], "oracle")


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_tier_round_trip_is_bitwise_and_refuses_a_bad_readmit(
        monkeypatch, tmp_path, kv_dtype):
    from veles_tpu_torch.kvtier import TieredKVStore
    from veles_tpu_torch.serving import decode
    cpu = torch.device("cpu")
    wires, host, steps = chip_smoke.tier_round_trip(
        torch, cpu, kv_dtype, (16, 4, 2, 8), [2, 5],
        TieredKVStore(disk_dir=str(tmp_path)), on_host=True)
    assert len(wires) == len(steps) == 2 and wires[0] != wires[1]
    assert all(len(s) == len(chip_smoke.ROUND_TRIP_STEPS) for s in steps)
    assert host[0].shape == (16, 4, 2, 8)
    real = decode._scatter

    def off_by_one(pools, blocks, host):
        real(pools, blocks if blocks is None else blocks - 1, host)
    monkeypatch.setattr(decode, "_scatter", off_by_one)
    with pytest.raises(AssertionError, match="differs from the demoted"):
        chip_smoke.tier_round_trip(torch, cpu, kv_dtype, (16, 4, 2, 8),
                                   [2], TieredKVStore(host_bytes=1 << 20))


def test_trace_record_sums_k1_k2_and_their_merge():
    """Paged attention's device time and launches: K1 over every f32
    instantiation, K2 over every int8 one, the merge of split calls
    apart; none where the run launched none."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = [_Row("void (anonymous namespace)::paged_decode_kernel<float, "
                 "4, false>((anonymous namespace)::Args)", 700.0, 60, cuda),
            _Row("void (anonymous namespace)::paged_decode_kernel<float, "
                 "1, false>((anonymous namespace)::Args)", 20.0, 2, cuda),
            _Row("void (anonymous namespace)::paged_decode_kernel<signed "
                 "char, 16, true>((anonymous namespace)::Args)", 300.0, 30,
                 cuda),
            _Row("void (anonymous namespace)::paged_merge_kernel(float "
                 "const*, float*, int, int, int, int)", 40.0, 8, cuda),
            _Row("sgemm", 5000.0, 10, cuda)]
    rec = chip_smoke._trace_record(_Prof(rows), "t", "card", 0.5)
    assert rec["k1_ms"] == pytest.approx(0.72) and rec["k1_launches"] == 62
    assert rec["k2_ms"] == pytest.approx(0.3) and rec["k2_launches"] == 30
    assert rec["paged_merge_ms"] == pytest.approx(0.04)
    assert rec["paged_merge_launches"] == 8
    rec = chip_smoke._trace_record(_Prof(rows[4:]), "t", "card", 0.5)
    assert (rec["k1_launches"], rec["k2_launches"],
            rec["paged_merge_launches"]) == (0, 0, 0)


def test_a_profile_that_lost_launches_is_taken_again(monkeypatch):
    cuda = torch.autograd.DeviceType.CUDA
    short = [_Row("quantized_matmul_kernel", 50.0, 15, cuda)]
    full = [_Row("quantized_matmul_kernel", 200.0, 20, cuda),
            _Row("quantized_fold_kernel", 40.0, 20, cuda)]
    fake = _fake_tracer(monkeypatch, [short, full])
    calls = []
    ms = chip_smoke._device_ms(fake, lambda: calls.append(1), iters=20,
                               launches=2)
    assert ms == pytest.approx(0.012) and len(calls) == 41
    fake = _fake_tracer(monkeypatch, [short] * chip_smoke.TRACE_TRIES)
    with pytest.raises(AssertionError, match="15 device launches, 40"):
        chip_smoke._device_ms(fake, lambda: None, iters=20, launches=2)
    # without a count, any profile with device time is taken
    fake = _fake_tracer(monkeypatch, [short])
    assert chip_smoke._device_ms(fake, lambda: None, iters=5) == \
        pytest.approx(0.01)


def test_per_launch_device_time_takes_the_launches_the_profile_holds(
        monkeypatch):
    """A one-kernel call's mean over the records the profile kept: 15 of
    20 launches seen at 50 us in all is 3.33 us a launch, not 2.5; a
    profile with no device time is taken again."""
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU
    short = [_Row("lrn_fwd_kernel<5, true>", 50.0, 15, cuda)]
    fake = _fake_tracer(monkeypatch, [[_Row("aten::empty", 1.0, 20, cpu)],
                                      short])
    ms = chip_smoke._device_ms(fake, lambda: None, iters=20,
                               per_launch=True)
    assert ms == pytest.approx(50.0 / 15 / 1e3)


def _rec(ms):
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": 2 * ms,
            "bound_ms": ms / 10, "bound_by": "bytes", "library_ms": None,
            "shape": "M=60 K=784 N=100"}


def _paged_rec(ms):
    """A K1/K2 record: its device time, the plan's split, the library
    yardstick (SDPA over the dense cache)."""
    return dict(_rec(ms), device_ms=ms / 3, split=1, library_ms=ms * 2)


def _k4_rec(ms):
    """A K4 record: its device time, whether it split, the CUDA-core
    bound beside the 3xTF32 one."""
    return dict(_rec(ms), device_ms=ms / 2, split=ms < 1,
                cuda_core_bound_ms=ms / 4)


def _k3_rec(ms):
    """A K3 record: its device time, the plan's tile and split, the
    CUDA-core bound beside the 2xTF32 one."""
    return dict(_rec(ms), device_ms=ms / 4, tile_m=16, split=1,
                k_split=64, cuda_core_bound_ms=ms / 8)


def _flash_rec(ms):
    """A K7-K9 record: its device time and head-dim tile, and the 3xTF32
    bound beside the CUDA-core one."""
    return dict(_rec(ms), device_ms=ms / 2, d_tile=64,
                tf32x3_bound_ms=ms / 6, cuda_core_bound_ms=ms / 3)


def _lrn_rec(ms):
    """A K5/K6 record: its device time, and whether it equals the plain
    version bit for bit."""
    return dict(_rec(ms), device_ms=ms / 2, bitwise=True)


PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114lrn_fwd_kernelILi5ELb1EEEvPKfPfNS_4PlanEfff' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114lrn_fwd_kernelILi5ELb1EEEvPKfPfNS_4PlanEfff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 38 registers, used 1 barriers, 432 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114lrn_bwd_kernelILi0ELb0EEEvPKfS2_PfNS_4PlanEfffff' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114lrn_bwd_kernelILi0ELb0EEEvPKfS2_PfNS_4PlanEfffff
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 440 bytes cmem[0]
"""  # noqa: E501


def test_ptxas_report_names_each_instantiation(monkeypatch):
    """One record an entry function: registers and spilled bytes, the
    name demangled where a demangler is found and kept as it is else."""
    monkeypatch.setattr(chip_smoke.shutil, "which", lambda *a, **k: None)
    report = chip_smoke.ptxas_report(PTXAS_LOG)
    assert [r[1:] for r in report] == [[38, 0, 0], [64, 12, 8]]
    assert report[0][0].startswith("_ZN12_GLOBAL__N_114lrn_fwd_kernel")
    assert chip_smoke.ptxas_report("no ptxas lines") == []
    monkeypatch.undo()
    if chip_smoke.shutil.which("c++filt"):
        names = [r[0] for r in chip_smoke.ptxas_report(PTXAS_LOG)]
        assert names == ["lrn_fwd_kernel<5, true>",
                         "lrn_bwd_kernel<0, false>"]


def _source_ab_without_a_card(monkeypatch, kernel):
    """tools/source_ab.py's main for ``kernel`` with no card: it must stop
    before building anything."""
    import importlib.util
    import pathlib
    path = pathlib.Path(chip_smoke.__file__).parent / "tools" / \
        "source_ab.py"
    spec = importlib.util.spec_from_file_location("source_ab", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tool, "build", lambda _: pytest.fail("built"))
    monkeypatch.setattr(sys, "argv", ["source_ab.py", kernel])
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main()


def test_lrn_ab_refuses_to_run_without_a_card(monkeypatch):
    """tools/source_ab.py times K5/K6 on the card only: without one it
    stops before building anything."""
    _source_ab_without_a_card(monkeypatch, "lrn")


def test_paged_ab_refuses_to_run_without_a_card(monkeypatch):
    """tools/source_ab.py times K1/K2 on the card only: without one it
    stops before building anything."""
    _source_ab_without_a_card(monkeypatch, "paged_attention")


def test_paged_cases_cover_the_main_path_and_the_long_context():
    """K1/K2's timed shapes: the main path's (one launch, no split), the
    realistic batch and the long context, whose dense score row would
    pass 227 KB of shared memory and which splits."""
    from veles_tpu_torch.znicz import paged_attention as pa
    cases = {label: (shape, lengths)
             for label, shape, lengths in chip_smoke.paged_cases()}
    assert list(cases) == ["main", "realistic", "long"]
    assert cases == {label: (shape, lengths) for label, shape, lengths
                     in chip_smoke.paged_cases()}     # seeded
    (b, h, d, bs, nb), lengths = cases["main"]
    assert len(lengths) == b and max(lengths) <= 160 <= nb * bs
    assert pa.paged_attention_plan(b, h, d, bs, nb, 132).split == 1
    (b, h, d, bs, nb), lengths = cases["long"]
    assert lengths == [65536, 40000] and nb * bs * 4 > 232448
    for quant in (False, True):
        assert pa.paged_attention_plan(b, h, d, bs, nb, 132,
                                       quantized=quant).split > 1


def test_kernels_line_holds_what_ran_and_refuses_what_did_not():
    slice1 = ("paged_attention_f32", "paged_attention_int8",
              "quantized_matmul_int8", "quantized_matmul_fp8")
    slice3 = ("flash_attention_fwd", "flash_attention_dq",
              "flash_attention_dkv")
    slice4 = ("lrn_fwd", "lrn_bwd")
    kernels = {name: {"main": _rec(0.1), "realistic": [_rec(0.4)]}
               for name in slice1 + slice3 + slice4}
    for name in slice1[:2]:
        kernels[name] = {"main": _paged_rec(0.03),
                         "realistic": [dict(_paged_rec(0.3), split=3)]}
    for name in slice1[2:]:
        kernels[name] = {"main": _k3_rec(0.1),
                         "realistic": [dict(_k3_rec(0.4), split=8)]}
    for name in slice3:
        kernels[name] = {"main": _flash_rec(0.6),
                         "realistic": [_flash_rec(0.3)]}
    for name in slice4:
        kernels[name] = {"main": _lrn_rec(0.2), "realistic": [_lrn_rec(0.1)]}
    kernels["kv_append_int8"] = {"main": _lrn_rec(0.01),
                                 "realistic": [_lrn_rec(0.05)]}
    k4 = {level: {"main": [_k4_rec(0.08 + level), _k4_rec(0.07)],
                  "realistic": [_k4_rec(7.0)]} for level in (0, 1, 2)}
    launches = dict({name: 64 for name in slice1},
                    precise_matmul_l1=26700, precise_matmul_l2=26700,
                    flash_attention_fwd=600, flash_attention_dq=450,
                    flash_attention_dkv=450, lrn_fwd=700, lrn_bwd=300,
                    kv_append_int8=1000)
    line = chip_smoke.kernels_line(kernels, k4, launches)
    names = [e["name"] for e in line["kernels"]]
    assert names == list(slice1) + ["precise_matmul_l1",
                                    "precise_matmul_l2"] + list(slice4) + \
        list(slice3) + ["kv_append_int8"]
    ids = [e["id"] for e in line["kernels"]]
    assert sorted(set(ids)) == ["K%d" % i for i in range(1, 10)] + \
        ["append"]
    keys = {"name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"}
    for entry in line["kernels"]:
        assert keys <= set(entry) and entry["launches"] > 0
    l1 = line["kernels"][4]
    assert l1["ms"] == 1.08 and l1["level0"] is k4[0]
    assert l1["device_ms"] == 0.54 and l1["cuda_core_bound_ms"] == 0.27
    assert l1["split"] is False
    assert l1["source"] == "veles_tpu_torch/csrc/precise_matmul.cu"
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.kernels_line(kernels, k4,
                                dict(launches, precise_matmul_l2=0))
    # a measured kernel whose main path left no count fails the run
    missing = dict(launches)
    del missing["quantized_matmul_fp8"]
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.kernels_line(kernels, k4, missing)
    # and so does a kernel of the path that was never measured
    unmeasured = dict(kernels)
    del unmeasured["paged_attention_int8"]
    with pytest.raises(AssertionError, match="not measured"):
        chip_smoke.kernels_line(unmeasured, k4, launches)
    by_name = {e["name"]: e for e in line["kernels"]}
    for name, kid in zip(slice1[:2], ("K1", "K2")):
        entry = by_name[name]
        assert entry["id"] == kid and entry["route"] == "cuda"
        assert entry["source"] == "veles_tpu_torch/csrc/paged_attention.cu"
        assert entry["device_ms"] == pytest.approx(0.01)
        assert entry["split"] == 1 and entry["library_ms"] == 0.06
        assert entry["realistic"][0]["split"] == 3
        # a K1/K2 record without its device time, its split or its
        # library yardstick fails the line
        for key in ("device_ms", "split", "library_ms"):
            bare = dict(kernels)
            rec = dict(kernels[name]["main"])
            del rec[key]
            bare[name] = dict(kernels[name], main=rec)
            with pytest.raises(AssertionError, match="lacks " + key):
                chip_smoke.kernels_line(bare, k4, launches)
    for name in slice1[2:]:
        entry = by_name[name]
        assert entry["id"] == "K3" and entry["device_ms"] == 0.025
        assert entry["split"] == 1 and entry["tile_m"] == 16
        assert entry["cuda_core_bound_ms"] == 0.0125
        assert entry["realistic"][0]["split"] == 8
        for key in ("device_ms", "split"):
            bare = dict(kernels)
            rec = dict(kernels[name]["main"])
            del rec[key]
            bare[name] = dict(kernels[name], main=rec)
            with pytest.raises(AssertionError, match="lacks " + key):
                chip_smoke.kernels_line(bare, k4, launches)
    for name, kid in zip(slice3, ("K7", "K8", "K9")):
        entry = by_name[name]
        assert entry["id"] == kid and entry["route"] == "cuda"
        assert entry["source"] == "veles_tpu_torch/csrc/flash_attention.cu"
        assert entry["replaces"].startswith(
            "veles_tpu/znicz/flash_attention.py:")
        assert entry["device_ms"] == 0.3 and entry["d_tile"] == 64
        assert entry["tf32x3_bound_ms"] == pytest.approx(0.1)
        assert entry["cuda_core_bound_ms"] == pytest.approx(0.2)
        # a K7-K9 record without its device time or either bound fails
        # the line
        for key in ("device_ms", "tf32x3_bound_ms", "cuda_core_bound_ms"):
            bare = dict(kernels)
            rec = dict(kernels[name]["main"])
            del rec[key]
            bare[name] = dict(kernels[name], main=rec)
            with pytest.raises(AssertionError, match="lacks " + key):
                chip_smoke.kernels_line(bare, k4, launches)
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.kernels_line(kernels, k4,
                                dict(launches, flash_attention_dkv=0))
    without_k8 = dict(kernels)
    del without_k8["flash_attention_dq"]
    with pytest.raises(AssertionError, match="not measured"):
        chip_smoke.kernels_line(without_k8, k4, launches)
    for name, kid in zip(slice4, ("K5", "K6")):
        entry = by_name[name]
        assert entry["id"] == kid and entry["route"] == "cuda"
        assert entry["source"] == "veles_tpu_torch/csrc/lrn.cu"
        assert entry["replaces"].startswith("veles_tpu/znicz/lrn.py:")
        assert entry["device_ms"] == 0.1 and entry["bitwise"] is True
        # a K5/K6 record without its device time or its bitwise flag
        # fails the line
        for key in ("device_ms", "bitwise"):
            bare = dict(kernels)
            rec = dict(kernels[name]["main"])
            del rec[key]
            bare[name] = dict(kernels[name], main=rec)
            with pytest.raises(AssertionError, match="lacks " + key):
                chip_smoke.kernels_line(bare, k4, launches)
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.kernels_line(kernels, k4, dict(launches, lrn_bwd=0))
    without_k5 = dict(kernels)
    del without_k5["lrn_fwd"]
    with pytest.raises(AssertionError, match="not measured"):
        chip_smoke.kernels_line(without_k5, k4, launches)
    # the int8-KV append: a hand kernel that is no TPU kernel, no library
    # call computes it
    entry = by_name["kv_append_int8"]
    assert entry["route"] == "cuda" and entry["library_ms"] is None
    assert entry["source"] == "veles_tpu_torch/csrc/kv_append.cu"
    assert entry["replaces"].startswith("none: not a TPU kernel")
    assert entry["launches"] == 1000 and entry["bitwise"] is True
    for key in ("device_ms", "bitwise"):
        bare = dict(kernels)
        rec = dict(kernels["kv_append_int8"]["main"])
        del rec[key]
        bare["kv_append_int8"] = dict(kernels["kv_append_int8"], main=rec)
        with pytest.raises(AssertionError, match="lacks " + key):
            chip_smoke.kernels_line(bare, k4, launches)
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.kernels_line(kernels, k4,
                                dict(launches, kv_append_int8=0))


@pytest.mark.parametrize("t,causal,window", [
    (7, False, None), (256, True, None), (256, True, 40), (100, True, 1),
    (64, True, 500)])
def test_visible_pairs_count_the_mask(t, causal, window):
    rows = torch.arange(t)[:, None]
    cols = torch.arange(t)[None, :]
    allowed = torch.ones((t, t), dtype=torch.bool)
    if causal:
        allowed = cols <= rows
        if window is not None:
            allowed &= cols > rows - window
    assert chip_smoke._visible(t, causal, window) == int(allowed.sum())


def test_needle_loader_makes_the_jax_tests_data():
    """The JAX test's loop (tests/test_attention_unit.py:124-137) and
    the loader's vectorized marking give the same bytes and split."""
    import numpy
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.loader.base import TRAIN, VALID
    from veles_tpu_torch.workflow import Workflow
    n, t, d, c = 60, 8, 8, 4
    loader = chip_smoke.needle_loader(n, t, d, c)(Workflow(name="w"),
                                                  minibatch_size=10)
    loader.initialize(device=Device(backend="cpu"))
    rng = numpy.random.RandomState(3)
    x = rng.uniform(-0.2, 0.2, (n, t, d)).astype(numpy.float32)
    labels = rng.randint(0, c, n)
    pos = rng.randint(0, t, n)
    for i in range(n):
        x[i, pos[i], 0] = 2.0
        x[i, pos[i], 1 + labels[i]] = 2.0
    assert loader.original_data.map_read().tobytes() == x.tobytes()
    assert list(loader.original_labels) == list(labels)
    assert (loader.class_lengths[VALID], loader.class_lengths[TRAIN]) == \
        (15, 45)
    # a second loader of the size shares the data, left as it was made
    again = chip_smoke.needle_loader(n, t, d, c, n_valid=20)(
        Workflow(name="w"), minibatch_size=10)
    again.initialize(device=Device(backend="cpu"))
    assert again.original_data.mem is loader.original_data.mem
    assert again.original_data.map_read().tobytes() == x.tobytes()
    assert again.class_lengths[VALID] == 20


def test_lrn_form_is_set_on_the_lrn_layers_only():
    from veles_tpu_torch.znicz.standard_workflow import _find_pair
    layers = chip_smoke.LRN_NET_LAYERS
    for layer in layers:
        _find_pair(layer["type"])       # every type is registered
    assert chip_smoke._with_lrn_form(layers, None) == list(layers)
    band = chip_smoke._with_lrn_form(layers, False)
    for was, now in zip(layers, band):
        if was["type"] == "norm":
            assert now["->"] == dict(was["->"], use_pallas=False)
        else:
            assert now == was
    assert "use_pallas" not in layers[1]["->"]     # not changed in place


def test_steps_agree_holds_its_limits():
    import numpy
    w = [{"weights": numpy.full((3, 2), 0.5, numpy.float32)}, {}]
    near = [{"weights": w[0]["weights"] + 4e-5}, {}]
    far = [{"weights": w[0]["weights"] + 6e-5}, {}]
    loss_diff, w_diff = chip_smoke.steps_agree("ok", [2.0, 1.5], near,
                                               [2.0001, 1.5], w)
    assert loss_diff == pytest.approx(0.0001 / 2.0001)
    assert w_diff == pytest.approx(8e-5, rel=1e-2)
    with pytest.raises(AssertionError):
        chip_smoke.steps_agree("weights", [2.0], far, [2.0], w)
    with pytest.raises(AssertionError):
        chip_smoke.steps_agree("loss", [2.0], w, [2.001], w)


@pytest.fixture
def pristine_recorder():
    from veles_tpu_torch.observability.flight import RECORDER
    RECORDER.reset()
    yield RECORDER
    RECORDER.reset()


def test_phase3d_burst_timelines_hold_every_request(pristine_recorder):
    """Phase 3d reads one closed timeline a request of a burst over
    ``GET /api/flagship/requests`` and refuses a request whose timeline
    never closed."""
    from veles_tpu_torch.serving import InferenceServer
    from veles_tpu_torch.znicz.samples.flagship import FlagshipDecodeModel
    model = FlagshipDecodeModel(stages=1, experts=2, d=8, heads=2,
                                hidden=8, vocab=16, device="cpu")
    server = InferenceServer({"flagship": model}, device="cpu",
                             max_batch=2, block_size=4, max_prompt_len=8,
                             max_new_tokens=4)
    try:
        answers, _ = chip_smoke._post_all(server.url, [[1, 2], [3, 4, 5]],
                                          new_tokens=3)
        rec = chip_smoke.burst_timelines(server.url, answers, "cpu")
        assert rec["timelines"] == 2
        assert rec["attribution"]["flagship/f32"]["count"] == 2
        pristine_recorder.record("torn", "queue.enter")
        pristine_recorder.annotate("torn", model="flagship")
        with pytest.raises(AssertionError, match="not closed"):
            chip_smoke.burst_timelines(server.url, answers, "cpu")
    finally:
        server.stop()


def test_phase3d_migration_keeps_one_trace_id(pristine_recorder):
    """Each migrated session's trace must hold migrate.export before
    migrate.import and close ok; a trace missing its import fails."""
    rec = pristine_recorder
    first = {}
    for sid, tid in (("m0", "t0"), ("m1", "t1")):
        first[sid] = (307, {}, {"X-Trace-Id": tid})
        for kind in ("queue.enter", "migrate.export", "migrate.import",
                     "retire"):
            rec.record(tid, kind)
        rec.finish(tid, status="ok")
    out = chip_smoke.migration_timelines("f32", first, ["m0", "m1"])
    assert out["m1"]["trace_id"] == "t1"
    first["m2"] = (307, {}, {"X-Trace-Id": "t2"})
    rec.record("t2", "migrate.export")
    rec.record("t2", "retire")
    rec.finish("t2", status="ok")
    with pytest.raises(AssertionError, match="one migrated timeline"):
        chip_smoke.migration_timelines("f32", first, ["m0", "m2"])


def _phase_names():
    """The phase_done names in ``main()``'s source, in order."""
    import ast
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    calls = [node for node in ast.walk(main)
             if isinstance(node, ast.Call) and
             getattr(node.func, "id", None) == "phase_done"]
    return [c.args[0].value for c in sorted(calls, key=lambda c: c.lineno)]


def test_phase3e_is_in_mains_order():
    names = [n.split()[0] for n in _phase_names()]
    assert names == ["2", "3", "3b", "3c", "4", "3d", "3e", "4b", "4c",
                     "4d", "3f", "4e", "4f", "4g", "4h", "4i", "4j", "4k",
                     "5"]
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    # 3d's fleet and 3e share one fresh build cache, removed after
    assert "cache_dir=cache_dir)" in src
    assert "autotune_phase(torch, card, cache_dir, dev)" in src


def test_tune_cases_are_the_sites_3e_must_tune():
    from veles_tpu_torch.autotune import space
    sites = [site for _, site, _ in chip_smoke.TUNE_CASES]
    assert sites.count("precise_gemm") == 2
    assert sites.count("paged_attention") == 2
    assert {"lrn", "flash_attention", "serving.prefill_chunk"} <= set(sites)
    for label, site, ctx in chip_smoke.TUNE_CASES:
        assert len(space.site(site).candidates(ctx)) >= 2, label
    realistic = chip_smoke.paged_cases()[1][1]
    assert (chip_smoke.PAGED_REALISTIC["batch"],
            chip_smoke.PAGED_REALISTIC["heads"],
            chip_smoke.PAGED_REALISTIC["d"],
            chip_smoke.PAGED_REALISTIC["block_size"],
            chip_smoke.PAGED_REALISTIC["max_blocks"]) == realistic
    label, site, chunk = chip_smoke.TUNE_CASES[-1]
    assert site == "serving.prefill_chunk"
    # the fresh process's server resolves the class the tune wrote
    assert space.site("serving.prefill_chunk").shape_class(chunk) == \
        "mp%d" % space.pow2_bucket(
            chip_smoke.README_SERVER["max_prompt_len"])


def test_tune_phase_tunes_through_isolated_subprocesses(tmp_path):
    """The tuning step on the CPU (the plain versions): a record with
    the default's and the winner's times, read back by a resolve."""
    from veles_tpu_torch.autotune import dispatch
    from veles_tpu_torch.autotune.store import TuningStore
    tune, cache = str(tmp_path / "tune"), str(tmp_path / "cc")
    os.makedirs(cache)
    cases = (("small LRN", "lrn", {"rows": 64, "c": 8, "n": 5}),)
    recs = chip_smoke.tune_phase("cpu", tune, cache, cases=cases,
                                 device="cpu")
    rec, = recs
    assert rec["gate"] == "passed" and rec["candidates"] == 2
    assert rec["default"] == {"impl": "kernel"}
    assert rec["default_ms"] > 0 and rec["winner_ms"] > 0
    got = TuningStore(tune).get("lrn", rec["shape_class"])
    assert got["config"] == rec["winner"]
    assert dispatch.AUTOTUNE_DIR_ENV not in chip_smoke._restart_env(
        cache, None)


def _restart_record():
    return {"sources": {"precise_gemm MNIST": "tuned",
                        "lrn AlexNet": "tuned"},
            "nvcc_runs": 0, "cache": {"misses": 0, "hits": 6},
            "chunk_source": "tuned", "mismatched": [],
            "mnist": {"weights_diff": 1e-7, "k4_launches": 12}}


def test_phase3e_restart_verdict_counts_nvcc_runs():
    listing = ["a.so", "b.so", "warmup_manifest.json"]
    chip_smoke.restart_verdict(_restart_record(), listing, list(listing))
    for change, match in (({"nvcc_runs": 1}, "1 nvcc runs"),
                          ({"cache": {"misses": 2, "hits": 4}},
                           "2 build-cache misses"),
                          ({"sources": {"lrn AlexNet": "default"}},
                           "not resolved tuned"),
                          ({"chunk_source": "default"}, "auto"),
                          ({"mismatched": [3]}, "differ from the oracle"),
                          ({"mnist": {"weights_diff": 1e-3,
                                      "k4_launches": 12}}, "MNIST weights"),
                          ({"mnist": {"weights_diff": 0.0,
                                      "k4_launches": 0}}, "no K4")):
        rec = dict(_restart_record(), **change)
        with pytest.raises(AssertionError, match=match):
            chip_smoke.restart_verdict(rec, listing, list(listing))
    with pytest.raises(AssertionError, match="listing changed"):
        chip_smoke.restart_verdict(_restart_record(), listing,
                                   listing + ["c.so"])
