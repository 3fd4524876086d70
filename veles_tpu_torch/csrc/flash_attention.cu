// Flash attention for Hopper (sm_90a), f32: the forward (K7) and the two
// passes of the backward (K8: dq; K9: dk and dv).
//
// Replaces the kernels of veles_tpu/znicz/flash_attention.py:
//   K7 _fwd_kernel (:141, launched by _flash_fwd_bh, pallas_call :250);
//   K8 _dq_kernel  (:265, launched by _flash_bwd_bh, pallas_call :402);
//   K9 _dkv_kernel (:307, launched by _flash_bwd_bh, pallas_call :422).
// Each computes what its TPU kernel computes, in the layout of the port's
// public function: q, k, v, dO are [B, T, H, D] f32 tensors read through
// their batch, time and head strides (the head dim is unit stride), so the
// strided views the packed QKV projection yields cost no copy.  out, dq,
// dk and dv are written as contiguous [B, T, H, D]; lse and delta are
// compact [B * H, T] rows (the TPU's 128-lane broadcast of the row stats
// was a VMEM tiling artifact).
//
// Masks: none; causal (query i sees keys j <= i); causal with a window W
// (i sees j in (i - W, i]).  Only the tiles the mask lets a CTA see are
// visited, so windowed work is O(T * W), as the TPU kernel's banded grid
// makes it.  A ragged T is masked in the kernels: every T takes them.
//
// What bounds them on the card: the multiply-adds (4 T^2 D a head
// forward, 6 T^2 D for dq, 8 T^2 D for dk/dv, halved by a causal mask);
// the bytes are O(T D).  All three run them on the tensor cores in 3xTF32
// (three TF32 products a step, 495 TFLOP/s for 3x the useful
// operations); TF32 alone stays off, so every result keeps f32's
// accuracy.  The sections below say how.  No TMA, no wgmma.
//
// Every output is owned by one CTA, which walks its tiles in a fixed
// order with no atomics: two runs give the same bits.  expf / logf are
// the full-precision ones.  Head dims 1-256: instantiations at 32, 64,
// 128 and 256, zero-padded below; past 256 the wide path (its section
// below) streams every operand over D in chunks.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -INFINITY;

// one [B, T, H, D] operand: element (b, t, h, d) at
// p[b * sb + t * st + h * sh + d]
struct View {
  const float* p;
  long long sb, st, sh;
};

__device__ __forceinline__ const float* row_base(const View& v, int b,
                                                 int h) {
  return v.p + (long long)b * v.sb + (long long)h * v.sh;
}

// is key column c hidden from query row r?
__device__ __forceinline__ bool masked(int r, int c, int T, int causal,
                                       int window) {
  if (c >= T || r >= T) return true;
  if (!causal) return false;
  return c > r || (window > 0 && c <= r - window);
}

// the heaviest tiles (causal: the last) are scheduled first
__device__ __forceinline__ void tile_of_block(int ntiles, int& bh,
                                              int& tile) {
  bh = blockIdx.x / ntiles;
  tile = ntiles - 1 - (int)(blockIdx.x % ntiles);
}

// -- The design the three kernels share: 3xTF32 on the tensor cores -----------
//
// Each CTA owns 64 rows (K7 and K8: Q rows, K9: keys), four warps of 16
// each, and keeps their operand tiles (K7: Q; K8: Q and dO; K9: K and V)
// in shared memory for its whole life.  The tiles it streams (K7 and K8:
// K and V; K9: Q, dO and the row stats) come through a ring of kStages
// buffers filled by cp.async, so the next tile lands while the current
// one is multiplied (and, kPresplit, split once for all four warps).
// Every tile is row-major [rows][DMAX + 4], as the operands lie in device
// memory (16-byte copies, no transpose); the row length is 4 mod 32
// floats, so each fragment read below hits 32 distinct banks.
//
// Every product runs on mma.sync.m16n8k8 (TF32 in, f32 accumulation):
// each operand splits as x = hi + lo (hi = rna_tf32(x), lo = rna_tf32(x -
// hi)) and each 8-deep step adds a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the
// small products first.  A warp's scores (K7: S = Q.K^T; K8: S and dP =
// dO.V^T; K9: S^T = K.Q^T and dP^T = V.dO^T) stay in the accumulators,
// and p and ds are formed there and fed back as the A operand of the next
// product (K7: O += P.V; K8: dQ += dS.K; K9: dV += P^T.dO, dK += dS^T.Q)
// with no trip through shared memory: an accumulator holds columns 2 tig
// and 2 tig + 1, where an A fragment wants tig and tig + 4, so each k8
// step takes its keys (K7, K8) or queries (K9) in the order 0 2 4 6 1 3 5
// 7 and reads the B operand's rows in the same order.  The tensor cores'
// f32 accumulation drifts over long chains, so each streamed tile's
// contribution to O, dQ, dK and dV is summed from zero in the tensor
// cores and joins the register sum with an IEEE add.

constexpr int kRows = 64;      // rows a CTA owns
constexpr int kThreads = 128;  // four warps of 16 rows

// the tiles of each instantiation, within the 227 KB a CTA may hold and
// the 255 registers a thread may: K8 streams kBK keys a tile; K9 streams
// kBQ queries a tile and writes kDS output columns a CTA (grid.y takes
// the rest); kG output column tiles are summed side by side.  kPresplit:
// each streamed tile, once landed, is split into TF32 hi (in place) and lo
// (a second buffer) once for the CTA, behind one more barrier, where the
// four warps would each split every value, K8's K and K9's Q and dO
// twice (they serve two products): faster on an H100 at DMAX 64 and 128
// (PERF.md).  At 256 the lo buffer leaves no room for 16-row
// tiles, and 8-row ones were slower than splitting on the spot
template <int DMAX>
struct DqPlan;
template <>
struct DqPlan<32> {
  static constexpr int kBK = 64, kStages = 3, kG = 4;
  static constexpr bool kPresplit = true;
};
template <>
struct DqPlan<64> {
  static constexpr int kBK = 32, kStages = 2, kG = 4;
  static constexpr bool kPresplit = true;
};
template <>
struct DqPlan<128> {
  static constexpr int kBK = 32, kStages = 2, kG = 4;
  static constexpr bool kPresplit = true;
};
template <>
struct DqPlan<256> {
  static constexpr int kBK = 16, kStages = 2, kG = 2;
  static constexpr bool kPresplit = false;
};

template <int DMAX>
struct DkvPlan;
template <>
struct DkvPlan<32> {
  static constexpr int kBQ = 64, kStages = 3, kDS = 32, kG = 4;
  static constexpr bool kPresplit = true;
};
template <>
struct DkvPlan<64> {
  static constexpr int kBQ = 32, kStages = 2, kDS = 64, kG = 4;
  static constexpr bool kPresplit = true;
};
template <>
struct DkvPlan<128> {
  static constexpr int kBQ = 32, kStages = 2, kDS = 128, kG = 2;
  static constexpr bool kPresplit = true;
};
template <>
struct DkvPlan<256> {
  static constexpr int kBQ = 16, kStages = 2, kDS = 128, kG = 2;
  static constexpr bool kPresplit = false;
};

// cvt.rna.tf32.f32 on the bit pattern: round the magnitude to 10
// mantissa bits, to nearest with ties away from zero (two integer ops;
// the PTX instruction also tests for NaN and infinity)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo in TF32 (the low 13 bits of each zero)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));  // x - hi is exact
}

// d += a . b on the tensor cores: a 16 x 8 (row), b 8 x 8 (col) TF32
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows r0 .. r0 + R - 1 of one (b, h) slice into the row-major tile
// s[R][DMAX + 4] by cp.async; zeros past T and past D.  Each thread
// copies one fixed 4-column chunk of every kStep-th row (neighbouring
// threads on neighbouring addresses): 16 bytes at a time when vec (the
// operand's base and strides are multiples of 16 bytes), else 4
template <int R, int DMAX>
__device__ __forceinline__ void copy_rows(float* s, const float* base,
                                          long long st, int r0, int T,
                                          int D, bool vec) {
  constexpr int kChunks = DMAX / 4, kStep = kThreads / kChunks;
  static_assert(kThreads % kChunks == 0 && R % kStep == 0,
                "every thread copies whole chunks of every pass");
  const unsigned tid = threadIdx.x;
  const int d = (int)(tid % kChunks) * 4;
  const int n = max(0, min(4, D - d));  // the chunk's columns inside D
  int t = r0 + (int)(tid / kChunks);
  float* dst = s + (tid / kChunks) * (DMAX + 4) + d;
  const float* src = base + (long long)t * st + d;
#pragma unroll
  for (int i = 0; i < R / kStep; ++i) {
    const int m = t < T ? n : 0;
    if (vec) {
      cp_async16(dst, m ? src : base, 4 * m);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cp_async4(dst + e, e < m ? src + e : base, e < m ? 4 : 0);
    }
    t += kStep;
    dst += kStep * (DMAX + 4);
    src += kStep * st;
  }
}

// lse and delta of rows q0 .. q0 + BQ - 1 into s[0 .. BQ) and s[BQ ..
// 2 BQ); zeros past T
template <int BQ>
__device__ __forceinline__ void copy_stats(float* s, const float* lse,
                                           const float* delta, int q0,
                                           int T) {
  static_assert(2 * BQ <= kThreads, "one thread a stat");
  const int i = threadIdx.x;
  if (i < 2 * BQ) {
    const float* src = i < BQ ? lse : delta;
    const int t = q0 + (i < BQ ? i : i - BQ);
    cp_async4(s + i, t < T ? src + t : src, t < T ? 4 : 0);
  }
}

// one m16n8k8 operand fragment, split: A (row) 4 values, B (col) 2
struct SplitA {
  uint32_t hi[4], lo[4];
};
struct SplitB {
  uint32_t hi[2], lo[2];
};

// split the N floats at p into TF32 hi (in place) and lo (to q), 16
// bytes a step
template <int N>
__device__ __forceinline__ void presplit(float* p, float* q) {
  static_assert(N % 4 == 0, "whole float4s");
  for (int i = threadIdx.x * 4; i < N; i += 4 * kThreads) {
    const float4 x = *reinterpret_cast<const float4*>(p + i);
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    *reinterpret_cast<float4*>(p + i) =
        make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                    __uint_as_float(h[2]), __uint_as_float(h[3]));
    *reinterpret_cast<float4*>(q + i) =
        make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                    __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

// s[j] (16 x 8, columns 8 j ..) = a . b^T over DMAX: a the warp's 16
// rows of a row-major tile, b NT * 8 rows of another (bl: its lo tile,
// when PRE).  The A fragment is (row gid / gid + 8, column tig / tig +
// 4), the B one (row gid, column tig / tig + 4): with rows 4 mod 32
// floats apart, 32 distinct banks.  (The PRE choice is written out in
// each helper: behind a shared inline helper ptxas gave K9 at DMAX 64
// 171 registers, not this form's 213, and a slower schedule.)
template <int NT, int DMAX, bool PRE>
__device__ __forceinline__ void tile_qk(float (&s)[NT][4], const float* a,
                                        const float* b, const float* bl,
                                        int gid, int tig) {
  constexpr int LD = DMAX + 4;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  const float* pa = a + gid * LD + tig;
  const float* pb = b + gid * LD + tig;
  const float* pl = bl + gid * LD + tig;
#pragma unroll 8
  for (int kk = 0; kk < DMAX; kk += 8) {
    SplitA fa;
    split_tf32(pa[kk], fa.hi[0], fa.lo[0]);
    split_tf32(pa[kk + 8 * LD], fa.hi[1], fa.lo[1]);
    split_tf32(pa[kk + 4], fa.hi[2], fa.lo[2]);
    split_tf32(pa[kk + 8 * LD + 4], fa.hi[3], fa.lo[3]);
    SplitB fb[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if constexpr (PRE) {
        fb[j].hi[0] = __float_as_uint(pb[j * 8 * LD + kk]);
        fb[j].hi[1] = __float_as_uint(pb[j * 8 * LD + kk + 4]);
        fb[j].lo[0] = __float_as_uint(pl[j * 8 * LD + kk]);
        fb[j].lo[1] = __float_as_uint(pl[j * 8 * LD + kk + 4]);
      } else {
        split_tf32(pb[j * 8 * LD + kk], fb[j].hi[0], fb[j].lo[0]);
        split_tf32(pb[j * 8 * LD + kk + 4], fb[j].hi[1], fb[j].lo[1]);
      }
    }
    // the three products in separate passes, so that no mma waits on
    // the one just before it
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(s[j], fa.lo, fb[j].hi);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(s[j], fa.hi, fb[j].lo);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(s[j], fa.hi, fb[j].hi);
  }
}

// an accumulator tile c (rows gid / gid + 8, columns 2 tig / 2 tig + 1)
// as the A fragment of a k8 step that takes its columns in the order
// 0 2 4 6 1 3 5 7: k = tig is column 2 tig, k = tig + 4 is 2 tig + 1
__device__ __forceinline__ void acc_as_a(const float (&c)[4], SplitA& a) {
  split_tf32(c[0], a.hi[0], a.lo[0]);
  split_tf32(c[2], a.hi[1], a.lo[1]);
  split_tf32(c[1], a.hi[2], a.lo[2]);
  split_tf32(c[3], a.hi[3], a.lo[3]);
}

// acc[jd] (16 x 8, columns 8 jd ..) += a . b over the NT k8 steps of a
// (acc_as_a): b is NT * 8 rows of a row-major tile from its column 0 on
// (bl: its lo tile, when PRE), its rows read in the steps' order (row
// 2 tig for k = tig, 2 tig + 1 for tig + 4).  Each output column tile's
// sum over the NT steps starts at zero in the tensor cores and joins acc
// with an IEEE add; G of them run side by side
template <int NT, int KD, int G, int DMAX, bool PRE>
__device__ __forceinline__ void tile_acc_tc(float (&acc)[KD][4],
                                            const SplitA (&a)[NT],
                                            const float* b, const float* bl,
                                            int gid, int tig) {
  constexpr int LD = DMAX + 4;
  static_assert(KD % G == 0, "whole groups of output column tiles");
  const float* pb = b + 2 * tig * LD + gid;
  const float* pl = bl + 2 * tig * LD + gid;
#pragma unroll
  for (int jd0 = 0; jd0 < KD; jd0 += G) {
    float t[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[g][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      SplitB fb[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int o = j * 8 * LD + (jd0 + g) * 8;
        if constexpr (PRE) {
          fb[g].hi[0] = __float_as_uint(pb[o]);
          fb[g].hi[1] = __float_as_uint(pb[o + LD]);
          fb[g].lo[0] = __float_as_uint(pl[o]);
          fb[g].lo[1] = __float_as_uint(pl[o + LD]);
        } else {
          split_tf32(pb[o], fb[g].hi[0], fb[g].lo[0]);
          split_tf32(pb[o + LD], fb[g].hi[1], fb[g].lo[1]);
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) mma_tf32(t[g], a[j].lo, fb[g].hi);
#pragma unroll
      for (int g = 0; g < G; ++g) mma_tf32(t[g], a[j].hi, fb[g].lo);
#pragma unroll
      for (int g = 0; g < G; ++g) mma_tf32(t[g], a[j].hi, fb[g].hi);
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[jd0 + g][e] = __fadd_rn(acc[jd0 + g][e], t[g][e]);
  }
}

// does the mask cut the tile of rows r_lo..r_hi and keys c_lo..c_hi?
// (a ragged T, or the causal or window edge through it)
__device__ __forceinline__ bool tile_masked(int r_lo, int r_hi, int c_lo,
                                            int c_hi, int T, int causal,
                                            int window) {
  if (r_hi >= T || c_hi >= T) return true;
  if (!causal) return false;
  return c_hi > r_lo || (window > 0 && c_lo <= r_hi - window);
}

template <int DMAX>
constexpr size_t dq_smem() {
  using P = DqPlan<DMAX>;
  return sizeof(float) * (DMAX + 4) *
         (2 * kRows + 2 * (P::kStages + P::kPresplit) * P::kBK);
}

// K8: dq of one Q tile of one (b, h)
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(View q, View k, View v, View dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                int T, int H, int D, float scale, int causal, int window,
                unsigned vec) {
  using P = DqPlan<DMAX>;
  constexpr int LD = DMAX + 4, BK = P::kBK, NS = P::kStages;
  constexpr int NT = BK / 8, KD = DMAX / 8, kStage = 2 * BK * LD;
  constexpr bool PRE = P::kPresplit;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][LD]
  float* dos = qs + kRows * LD;                 // [kRows][LD], dO
  float* klo = dos + kRows * LD;                // PRE: K, V lo [BK][LD]
  float* ring = klo + PRE * kStage;             // NS x K, V [BK][LD]

  const int ntiles = (T + kRows - 1) / kRows;
  int bh, iq;
  tile_of_block(ntiles, bh, iq);
  const int b = bh / H, h = bh % H;
  const int q0 = iq * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3, m0 = warp * 16;

  // the K tiles this Q tile sees: lo .. lo + n - 1
  int lo = 0, hi = (T - 1) / BK;
  if (causal) {
    hi = min(hi, (q0 + kRows - 1) / BK);
    if (window > 0) lo = max(0, q0 - window + 1) / BK;
  }
  const int n = hi - lo + 1;

  const float* kb = row_base(k, b, h);
  const float* vb = row_base(v, b, h);
  copy_rows<kRows, DMAX>(qs, row_base(q, b, h), q.st, q0, T, D, vec & 1);
  copy_rows<kRows, DMAX>(dos, row_base(dout, b, h), dout.st, q0, T, D,
                         vec & 8);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n) {
      float* st = ring + s * kStage;
      copy_rows<BK, DMAX>(st, kb, k.st, (lo + s) * BK, T, D, vec & 2);
      copy_rows<BK, DMAX>(st + BK * LD, vb, v.st, (lo + s) * BK, T, D,
                          vec & 4);
    }
    cp_async_commit();
  }

  // the thread's rows: q0 + m0 + gid and 8 below
  float lse_r[2], delta_r[2], acc[KD][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + m0 + gid + 8 * i;
    lse_r[i] = r < T ? lse[(long long)bh * T + r] : 0.f;
    delta_r[i] = r < T ? delta[(long long)bh * T + r] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < KD; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    {  // refill the buffer every thread finished with last iteration
      const int nx = i + NS - 1;
      if (nx < n) {
        float* st = ring + (nx % NS) * kStage;
        copy_rows<BK, DMAX>(st, kb, k.st, (lo + nx) * BK, T, D, vec & 2);
        copy_rows<BK, DMAX>(st + BK * LD, vb, v.st, (lo + nx) * BK, T, D,
                            vec & 4);
      }
      cp_async_commit();
    }
    float* ks = ring + (i % NS) * kStage;
    if constexpr (PRE) {
      presplit<kStage>(ks, klo);
      __syncthreads();
    }
    const float* vs = ks + BK * LD;
    const int c0 = (lo + i) * BK;
    float s[NT][4], dp[NT][4];
    tile_qk<NT, DMAX, PRE>(s, qs + m0 * LD, ks, klo, gid, tig);  // q k^T
    tile_qk<NT, DMAX, PRE>(dp, dos + m0 * LD, vs, klo + BK * LD, gid,
                           tig);                                 // dO v^T
    const bool edge = tile_masked(q0 + m0, q0 + m0 + 15, c0, c0 + BK - 1, T,
                                  causal, window);
    SplitA a[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q0 + m0 + gid + 8 * (e >> 1);
        const int c = c0 + j * 8 + 2 * tig + (e & 1);
        const float p = edge && masked(r, c, T, causal, window)
                            ? 0.f
                            : expf(s[j][e] * scale - lse_r[e >> 1]);
        s[j][e] = p * (dp[j][e] - delta_r[e >> 1]);  // ds
      }
      acc_as_a(s[j], a[j]);
    }
    tile_acc_tc<NT, KD, P::kG, DMAX, PRE>(acc, a, ks, klo, gid, tig);
  }
  cp_async_wait<0>();

  float* o = dq + ((long long)b * T * H + h) * D;
#pragma unroll
  for (int j = 0; j < KD; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = q0 + m0 + gid + 8 * (e >> 1);
      const int d = j * 8 + 2 * tig + (e & 1);
      if (r < T && d < D) o[(long long)r * H * D + d] = acc[j][e] * scale;
    }
}

template <int DMAX>
constexpr size_t dkv_smem() {
  using P = DkvPlan<DMAX>;
  return sizeof(float) *
         (2 * (kRows + P::kPresplit * P::kBQ) * (DMAX + 4) +
          P::kStages * (2 * P::kBQ * (DMAX + 4) + 2 * P::kBQ));
}

// K9: dk and dv of one K tile of one (b, h), output columns blockIdx.y *
// kDS ..
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(View q, View k, View v, View dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int T, int H, int D, float scale,
                 int causal, int window, unsigned vec) {
  using P = DkvPlan<DMAX>;
  constexpr int LD = DMAX + 4, BQ = P::kBQ, NS = P::kStages;
  constexpr int NT = BQ / 8, KD = P::kDS / 8;
  constexpr int kStage = 2 * BQ * LD + 2 * BQ;
  constexpr bool PRE = P::kPresplit;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kRows][LD]
  float* vs = ks + kRows * LD;                  // [kRows][LD]
  float* qlo = vs + kRows * LD;                 // PRE: Q, dO lo [BQ][LD]
  // NS x Q, dO [BQ][LD], lse, delta [BQ]
  float* ring = qlo + PRE * 2 * BQ * LD;

  const int ntiles = (T + kRows - 1) / kRows;
  // causal: the first K tiles see the most queries, and go first
  const int bh = blockIdx.x / ntiles, jk = blockIdx.x % ntiles;
  const int b = bh / H, h = bh % H;
  const int c0 = jk * kRows, n0 = blockIdx.y * P::kDS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3, m0 = warp * 16;

  // the Q tiles that see this K tile: lo .. lo + n - 1, the band capped
  // at the last Q tile (as _dkv_kernel caps it)
  int lo = 0, hi = (T - 1) / BQ;
  if (causal) {
    lo = c0 / BQ;
    if (window > 0)
      hi = (int)min((long long)hi,
                    ((long long)c0 + kRows - 1 + window - 1) / BQ);
  }
  const int n = hi - lo + 1;

  const float* qb = row_base(q, b, h);
  const float* ob = row_base(dout, b, h);
  const float* lse_b = lse + (long long)bh * T;
  const float* delta_b = delta + (long long)bh * T;
  copy_rows<kRows, DMAX>(ks, row_base(k, b, h), k.st, c0, T, D, vec & 2);
  copy_rows<kRows, DMAX>(vs, row_base(v, b, h), v.st, c0, T, D, vec & 4);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n) {
      float* st = ring + s * kStage;
      const int r0 = (lo + s) * BQ;
      copy_rows<BQ, DMAX>(st, qb, q.st, r0, T, D, vec & 1);
      copy_rows<BQ, DMAX>(st + BQ * LD, ob, dout.st, r0, T, D, vec & 8);
      copy_stats<BQ>(st + 2 * BQ * LD, lse_b, delta_b, r0, T);
    }
    cp_async_commit();
  }

  // the thread's keys: c0 + m0 + gid and 8 below; columns n0 + 8 j ..
  float dk_acc[KD][4], dv_acc[KD][4];
#pragma unroll
  for (int j = 0; j < KD; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    {  // refill the buffer every thread finished with last iteration
      const int nx = i + NS - 1;
      if (nx < n) {
        float* st = ring + (nx % NS) * kStage;
        const int r0 = (lo + nx) * BQ;
        copy_rows<BQ, DMAX>(st, qb, q.st, r0, T, D, vec & 1);
        copy_rows<BQ, DMAX>(st + BQ * LD, ob, dout.st, r0, T, D, vec & 8);
        copy_stats<BQ>(st + 2 * BQ * LD, lse_b, delta_b, r0, T);
      }
      cp_async_commit();
    }
    float* qs = ring + (i % NS) * kStage;
    if constexpr (PRE) {
      presplit<2 * BQ * LD>(qs, qlo);
      __syncthreads();
    }
    const float* dos = qs + BQ * LD;
    const float* dolo = qlo + BQ * LD;
    const float* lse_s = dos + BQ * LD;
    const float* delta_s = lse_s + BQ;
    const int q0 = (lo + i) * BQ;
    float s[NT][4], dp[NT][4];
    tile_qk<NT, DMAX, PRE>(s, ks + m0 * LD, qs, qlo, gid, tig);  // (q k^T)^T
    tile_qk<NT, DMAX, PRE>(dp, vs + m0 * LD, dos, dolo, gid,
                           tig);                            // (dO v^T)^T
    const bool edge = tile_masked(q0, q0 + BQ - 1, c0 + m0, c0 + m0 + 15, T,
                                  causal, window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + m0 + gid + 8 * (e >> 1);
        const int col = j * 8 + 2 * tig + (e & 1);
        const float p = edge && masked(q0 + col, c, T, causal, window)
                            ? 0.f
                            : expf(s[j][e] * scale - lse_s[col]);
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - delta_s[col]);  // ds
      }
    SplitA a[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc_as_a(s[j], a[j]);
    tile_acc_tc<NT, KD, P::kG, DMAX, PRE>(dv_acc, a, dos + n0, dolo + n0,
                                          gid, tig);
#pragma unroll
    for (int j = 0; j < NT; ++j) acc_as_a(dp[j], a[j]);
    tile_acc_tc<NT, KD, P::kG, DMAX, PRE>(dk_acc, a, qs + n0, qlo + n0,
                                          gid, tig);
  }
  cp_async_wait<0>();

  const long long off = ((long long)b * T * H + h) * D;
#pragma unroll
  for (int j = 0; j < KD; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + m0 + gid + 8 * (e >> 1);
      const int d = n0 + j * 8 + 2 * tig + (e & 1);
      if (c < T && d < D) {
        dk[off + (long long)c * H * D + d] = dk_acc[j][e] * scale;
        dv[off + (long long)c * H * D + d] = dv_acc[j][e];
      }
    }
}

// -- K7: the forward ----------------------------------------------------------
//
// A warp's S = (q * scale) . K^T over a streamed tile of kBK keys stays in
// the accumulators, and the online softmax runs there: each row's max and
// sum reduce over its quad (__shfl_xor_sync 1 and 2), with the TPU
// kernel's guards for a row that sees no key yet; p goes back as the A
// operand of O += P.V.  Each tile's P.V sums from zero in the tensor cores
// and joins the register sum as acc * alpha + tile in IEEE f32.  The Q
// tile is scaled once in shared memory, as the TPU kernel scales q before
// its dot.  Only the tiles the mask cuts (tile_masked) test it score by
// score, and a warp skips a tile its rows see no key of.
//
// Every warp splits the values it reads on the spot: K and V each serve
// one product, and four warps re-reading a presplit tile's hi and lo cost
// more shared-memory bandwidth than the splits cost ALU (so does a Q tile
// kept split; on an H100, PERF.md).  The tiles of each instantiation:
// kBK keys a streamed tile (K [kBK][DMAX + 4], V [kBK][kDV + 4]) in a
// two-deep ring; kDV output columns a CTA, grid.y taking the rest (at
// DMAX 256 the output accumulator alone would be 128 registers a thread,
// so each of two CTAs recomputes S for 128 columns, and only the first
// writes lse); kG output column tiles summed side by side.  45, 51, 99
// and 163 KB of shared memory at DMAX 32, 64, 128 and 256: four CTAs an
// SM at 32 and 64, two at 128 (by registers), one at 256
template <int DMAX>
struct FwdPlan {
  static constexpr int kDV = DMAX < 128 ? DMAX : 128;
  static constexpr int kBK = DMAX == 32 ? 64 : 32;
  static constexpr int kG = DMAX == 128 ? 8 : DMAX == 256 ? 2 : 4;
};
constexpr int kFwdStages = 2;

template <int DMAX>
constexpr size_t fwd_smem() {
  using P = FwdPlan<DMAX>;
  return sizeof(float) * (kRows * (DMAX + 4) +
                          kFwdStages * P::kBK * (DMAX + P::kDV + 8));
}

// scale the N floats at p by mul, in place
template <int N>
__device__ __forceinline__ void scale_tile(float* p, float mul) {
  static_assert(N % 4 == 0, "whole float4s");
  for (int i = threadIdx.x * 4; i < N; i += 4 * kThreads) {
    const float4 t = *reinterpret_cast<const float4*>(p + i);
    *reinterpret_cast<float4*>(p + i) =
        make_float4(__fmul_rn(t.x, mul), __fmul_rn(t.y, mul),
                    __fmul_rn(t.z, mul), __fmul_rn(t.w, mul));
  }
}

// K7: out and lse of one Q tile of one (b, h), output columns blockIdx.y *
// kDV ..
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(View q, View k, View v, float* __restrict__ out,
                 float* __restrict__ lse, int T, int H, int D, float scale,
                 int causal, int window, unsigned vec) {
  using P = FwdPlan<DMAX>;
  constexpr int LD = DMAX + 4, DV = P::kDV, BK = P::kBK, NS = kFwdStages;
  constexpr int NT = BK / 8, KD = DV / 8, kStage = BK * (LD + DV + 4);
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][LD], q * scale
  float* ring = qs + kRows * LD;                // NS x K, V

  const int ntiles = (T + kRows - 1) / kRows;
  int bh, iq;
  tile_of_block(ntiles, bh, iq);
  const int b = bh / H, h = bh % H;
  const int q0 = iq * kRows, n0 = blockIdx.y * DV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3, r0 = q0 + warp * 16;

  // the K tiles this Q tile sees: lo .. lo + n - 1
  int lo = 0, hi = (T - 1) / BK;
  if (causal) {
    hi = min(hi, (q0 + kRows - 1) / BK);
    if (window > 0) lo = max(0, q0 - window + 1) / BK;
  }
  const int n = hi - lo + 1;

  const float* kb = row_base(k, b, h);
  const float* vb = row_base(v, b, h) + n0;
  auto load = [&](int i, float* st) {  // K and V tile lo + i into st
    const int c0 = (lo + i) * BK;
    copy_rows<BK, DMAX>(st, kb, k.st, c0, T, D, vec & 2);
    copy_rows<BK, DV>(st + BK * LD, vb, v.st, c0, T, D - n0, vec & 4);
  };
  copy_rows<kRows, DMAX>(qs, row_base(q, b, h), q.st, q0, T, D, vec & 1);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n) load(s, ring + s * kStage);
    cp_async_commit();
  }
  cp_async_wait<NS - 1>();  // the Q tile
  __syncthreads();
  scale_tile<kRows * LD>(qs, scale);  // read after the loop's first barrier

  // the thread's rows: r0 + gid and 8 below
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f}, acc[KD][4];
#pragma unroll
  for (int j = 0; j < KD; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    {  // refill the buffer every thread finished with last iteration
      const int nx = i + NS - 1;
      if (nx < n) load(nx, ring + (nx % NS) * kStage);
      cp_async_commit();
    }
    const float* ks = ring + (i % NS) * kStage;
    const int c0 = (lo + i) * BK;
    if (r0 >= T || (causal && (c0 > r0 + 15 ||
                               (window > 0 && c0 + BK - 1 <= r0 - window))))
      continue;  // the warp's rows see no key of this tile
    float s[NT][4];
    tile_qk<NT, DMAX, false>(s, qs + warp * 16 * LD, ks, ks, gid, tig);
    if (tile_masked(r0, r0 + 15, c0, c0 + BK - 1, T, causal, window)) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (masked(r0 + gid + 8 * (e >> 1), c0 + j * 8 + 2 * tig + (e & 1),
                     T, causal, window))
            s[j][e] = kNegInf;
    }
    float mx[2] = {m_r[0], m_r[1]}, alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with every key so far masked keeps m at -inf: exp(-inf -
      // -inf) must be 0, not nan (flash_attention.py:173-177)
      const float safe_m = mx[r] == kNegInf ? 0.f : mx[r];
      alpha[r] = m_r[r] == kNegInf ? 0.f : expf(m_r[r] - safe_m);
      m_r[r] = mx[r];
      mx[r] = safe_m;
    }
    SplitA a[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            s[j][e] == kNegInf ? 0.f : expf(s[j][e] - mx[e >> 1]);
        s[j][e] = p;
        sum[e >> 1] += p;
      }
      acc_as_a(s[j], a[j]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_r[r] = __fadd_rn(__fmul_rn(l_r[r], alpha[r]), sum[r]);
    }
#pragma unroll
    for (int j = 0; j < KD; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = __fmul_rn(acc[j][e], alpha[e >> 1]);
    const float* vs = ks + BK * LD;
    tile_acc_tc<NT, KD, P::kG, DV, false>(acc, a, vs, vs, gid, tig);
  }
  cp_async_wait<0>();

  float* o = out + ((long long)b * T * H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r0 + gid + 8 * r;
    if (t >= T) continue;
    const float safe_l = l_r[r] == 0.f ? 1.f : l_r[r];
#pragma unroll
    for (int j = 0; j < KD; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n0 + j * 8 + 2 * tig + e;
        if (d < D) o[(long long)t * H * D + d] = acc[j][2 * r + e] / safe_l;
      }
    if (blockIdx.y == 0 && tig == 0)
      lse[(long long)bh * T + t] =
          (m_r[r] == kNegInf ? 0.f : m_r[r]) + logf(safe_l);
  }
}

// -- The wide path: head dims past 256 ----------------------------------------
//
// Past 256 no operand tile stays resident (K8's Q and dO alone would be
// 256 KB at D = 512).  Each CTA still owns 64 rows, and kWideOut of
// their output columns (grid.y takes the rest).  The products that sum
// over D (S = Q.K^T in all three, dP = dO.V^T in K8 and K9) stream both
// operands through shared memory kWideChunk columns at a time: each
// chunk's 3xTF32 sum starts at zero in the tensor cores (tile_qk) and
// joins the score tile in registers with an IEEE add.  The products that
// run over D (K7: O += P.V; K8: dQ += dS.K; K9: dV += P^T.dO, dK +=
// dS^T.Q) then take the CTA's columns of the streamed tile, through the
// same tile_acc_tc as the resident path.  So every column CTA recomputes
// its score tiles (as K7 does at 256), and only column CTA 0 writes lse.
// The steps of a streamed tile (its chunks, then its output columns) go
// through two slots filled by cp.async, the next step's copy in flight
// while the current one is multiplied; two barriers a step.  K7 scales
// S, not the Q tile (Q is not resident); the rounding differs from the
// resident path's by an ulp of a score.  Any D with ceil(D / kWideOut)
// <= 65535 (grid.y) runs; D is zero-padded to whole chunks.
constexpr int kWideChunk = 64;  // columns of a streamed chunk of a product
constexpr int kWideOut = 128;   // output columns a CTA
constexpr int kWideLC = kWideChunk + 4, kWideLO = kWideOut + 4;
// keys (K7, K8) or queries (K9) a streamed tile: each step re-reads the
// CTA's own rows from L2, so the larger the streamed tile the fewer
// reads a product; on an H100 K7 at 64 and K9 at 32 ran 20 % faster
// than at 32 and 16, K8 at 64 10 % slower (PERF.md)
constexpr int kFwdWideBK = 64, kDqWideBK = 32, kDkvWideBQ = 32;
// the floats of one slot: a chunk step's tiles; the output step's fit
constexpr int kFwdWideSlot = (kRows + kFwdWideBK) * kWideLC;
constexpr int kDqWideSlot = 2 * (kRows + kDqWideBK) * kWideLC;
constexpr int kDkvWideSlot = 2 * (kRows + kDkvWideBQ) * kWideLC;
static_assert(kFwdWideBK * kWideLO <= kFwdWideSlot &&
                  kDqWideBK * kWideLO <= kDqWideSlot &&
                  2 * kDkvWideBQ * (kWideLO + 1) <= kDkvWideSlot,
              "an output step fits a slot");

// rows r0 .. r0 + R - 1, columns c * kWideChunk .. of their chunk c
template <int R>
__device__ __forceinline__ void copy_chunk(float* s, const float* base,
                                           long long st, int r0, int T,
                                           int D, int c, bool vec) {
  copy_rows<R, kWideChunk>(s, base + c * kWideChunk, st, r0, T,
                           D - c * kWideChunk, vec);
}

// s (+)= a . b^T over one chunk (tile_qk's operands, rows kWideLC
// floats apart); the chunk's sum joins s with an IEEE add, the first
// chunk's is s
template <int NT>
__device__ __forceinline__ void chunk_qk(float (&s)[NT][4], const float* a,
                                         const float* b, bool first, int gid,
                                         int tig) {
  float t[NT][4];
  tile_qk<NT, kWideChunk, false>(t, a, b, b, gid, tig);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = first ? t[j][e] : __fadd_rn(s[j][e], t[j][e]);
}

// K7, wide: out and lse of one Q tile of one (b, h), output columns
// blockIdx.y * kWideOut ..; the online softmax as flash_fwd_kernel's
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(View q, View k, View v, float* __restrict__ out,
                      float* __restrict__ lse, int T, int H, int D,
                      float scale, int causal, int window, unsigned vec) {
  constexpr int BK = kFwdWideBK, LC = kWideLC, NT = BK / 8;
  constexpr int KD = kWideOut / 8, kSlot = kFwdWideSlot;
  extern __shared__ float4 smem4[];
  float* slots = reinterpret_cast<float*>(smem4);  // 2 x kSlot

  const int ntiles = (T + kRows - 1) / kRows;
  int bh, iq;
  tile_of_block(ntiles, bh, iq);
  const int b = bh / H, h = bh % H;
  const int q0 = iq * kRows, n0 = blockIdx.y * kWideOut;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3, r0 = q0 + warp * 16;

  // the K tiles this Q tile sees: lo .. hi; each takes nc chunk steps
  // (Q and K) and one step of its V columns
  int lo = 0, hi = (T - 1) / BK;
  if (causal) {
    hi = min(hi, (q0 + kRows - 1) / BK);
    if (window > 0) lo = max(0, q0 - window + 1) / BK;
  }
  const int nc = (D + kWideChunk - 1) / kWideChunk, per = nc + 1;
  const int steps = (hi - lo + 1) * per;

  const float* qb = row_base(q, b, h);
  const float* kb = row_base(k, b, h);
  const float* vb = row_base(v, b, h) + n0;
  auto load = [&](int j) {
    float* st = slots + (j & 1) * kSlot;
    const int c = j % per, c0 = (lo + j / per) * BK;
    if (c < nc) {
      copy_chunk<kRows>(st, qb, q.st, q0, T, D, c, vec & 1);
      copy_chunk<BK>(st + kRows * LC, kb, k.st, c0, T, D, c, vec & 2);
    } else {
      copy_rows<BK, kWideOut>(st, vb, v.st, c0, T, D - n0, vec & 4);
    }
  };
  load(0);
  cp_async_commit();

  // the thread's rows: r0 + gid and 8 below
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f}, acc[KD][4];
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < KD; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int j = 0; j < steps; ++j) {
    if (j + 1 < steps) load(j + 1);  // into the slot step j - 1 freed
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* st = slots + (j & 1) * kSlot;
    const int c = j % per, c0 = (lo + j / per) * BK;
    // does the warp's rows see a key of this tile?
    const bool sees =
        r0 < T && !(causal && (c0 > r0 + 15 ||
                               (window > 0 && c0 + BK - 1 <= r0 - window)));
    if (sees && c < nc) {
      chunk_qk<NT>(s, st + warp * 16 * LC, st + kRows * LC, c == 0, gid,
                   tig);
    } else if (sees) {
      const bool edge =
          tile_masked(r0, r0 + 15, c0, c0 + BK - 1, T, causal, window);
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[i][e] = edge && masked(r0 + gid + 8 * (e >> 1),
                                   c0 + i * 8 + 2 * tig + (e & 1), T,
                                   causal, window)
                        ? kNegInf
                        : __fmul_rn(s[i][e], scale);
      float mx[2] = {m_r[0], m_r[1]}, alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[i][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float safe_m = mx[r] == kNegInf ? 0.f : mx[r];
        alpha[r] = m_r[r] == kNegInf ? 0.f : expf(m_r[r] - safe_m);
        m_r[r] = mx[r];
        mx[r] = safe_m;
      }
      SplitA a[NT];
#pragma unroll
      for (int i = 0; i < NT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              s[i][e] == kNegInf ? 0.f : expf(s[i][e] - mx[e >> 1]);
          s[i][e] = p;
          sum[e >> 1] += p;
        }
        acc_as_a(s[i], a[i]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l_r[r] = __fadd_rn(__fmul_rn(l_r[r], alpha[r]), sum[r]);
      }
#pragma unroll
      for (int i = 0; i < KD; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][e] = __fmul_rn(acc[i][e], alpha[e >> 1]);
      tile_acc_tc<NT, KD, 2, kWideOut, false>(acc, a, st, st, gid, tig);
    }
    __syncthreads();  // every warp is done with the slot step j + 2 fills
  }
  cp_async_wait<0>();

  float* o = out + ((long long)b * T * H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r0 + gid + 8 * r;
    if (t >= T) continue;
    const float safe_l = l_r[r] == 0.f ? 1.f : l_r[r];
#pragma unroll
    for (int j = 0; j < KD; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n0 + j * 8 + 2 * tig + e;
        if (d < D) o[(long long)t * H * D + d] = acc[j][2 * r + e] / safe_l;
      }
    if (blockIdx.y == 0 && tig == 0)
      lse[(long long)bh * T + t] =
          (m_r[r] == kNegInf ? 0.f : m_r[r]) + logf(safe_l);
  }
}

// K8, wide: dq of one Q tile of one (b, h), output columns blockIdx.y *
// kWideOut ..
__global__ void __launch_bounds__(kThreads)
flash_dq_wide_kernel(View q, View k, View v, View dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dq, int T, int H, int D,
                     float scale, int causal, int window, unsigned vec) {
  constexpr int BK = kDqWideBK, LC = kWideLC, NT = BK / 8;
  constexpr int KD = kWideOut / 8, kSlot = kDqWideSlot;
  extern __shared__ float4 smem4[];
  // a chunk step: Q, dO [kRows][LC], K, V [BK][LC]; the output step: K's
  // columns [BK][kWideLO]
  float* slots = reinterpret_cast<float*>(smem4);  // 2 x kSlot

  const int ntiles = (T + kRows - 1) / kRows;
  int bh, iq;
  tile_of_block(ntiles, bh, iq);
  const int b = bh / H, h = bh % H;
  const int q0 = iq * kRows, n0 = blockIdx.y * kWideOut;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3, m0 = warp * 16;

  int lo = 0, hi = (T - 1) / BK;
  if (causal) {
    hi = min(hi, (q0 + kRows - 1) / BK);
    if (window > 0) lo = max(0, q0 - window + 1) / BK;
  }
  const int nc = (D + kWideChunk - 1) / kWideChunk, per = nc + 1;
  const int steps = (hi - lo + 1) * per;

  const float* qb = row_base(q, b, h);
  const float* ob = row_base(dout, b, h);
  const float* kb = row_base(k, b, h);
  const float* vb = row_base(v, b, h);
  auto load = [&](int j) {
    float* st = slots + (j & 1) * kSlot;
    const int c = j % per, c0 = (lo + j / per) * BK;
    if (c < nc) {
      copy_chunk<kRows>(st, qb, q.st, q0, T, D, c, vec & 1);
      copy_chunk<kRows>(st + kRows * LC, ob, dout.st, q0, T, D, c, vec & 8);
      copy_chunk<BK>(st + 2 * kRows * LC, kb, k.st, c0, T, D, c, vec & 2);
      copy_chunk<BK>(st + (2 * kRows + BK) * LC, vb, v.st, c0, T, D, c,
                     vec & 4);
    } else {
      copy_rows<BK, kWideOut>(st, kb + n0, k.st, c0, T, D - n0, vec & 2);
    }
  };
  load(0);
  cp_async_commit();

  // the thread's rows: q0 + m0 + gid and 8 below
  float lse_r[2], delta_r[2], acc[KD][4], s[NT][4], dp[NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + m0 + gid + 8 * i;
    lse_r[i] = r < T ? lse[(long long)bh * T + r] : 0.f;
    delta_r[i] = r < T ? delta[(long long)bh * T + r] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < KD; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int j = 0; j < steps; ++j) {
    if (j + 1 < steps) load(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* st = slots + (j & 1) * kSlot;
    const int c = j % per, c0 = (lo + j / per) * BK;
    if (c < nc) {
      chunk_qk<NT>(s, st + m0 * LC, st + 2 * kRows * LC, c == 0, gid,
                   tig);                                         // q k^T
      chunk_qk<NT>(dp, st + (kRows + m0) * LC, st + (2 * kRows + BK) * LC,
                   c == 0, gid, tig);                            // dO v^T
    } else {
      const bool edge = tile_masked(q0 + m0, q0 + m0 + 15, c0, c0 + BK - 1,
                                    T, causal, window);
      SplitA a[NT];
#pragma unroll
      for (int i = 0; i < NT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = q0 + m0 + gid + 8 * (e >> 1);
          const int col = c0 + i * 8 + 2 * tig + (e & 1);
          const float p = edge && masked(r, col, T, causal, window)
                              ? 0.f
                              : expf(s[i][e] * scale - lse_r[e >> 1]);
          s[i][e] = p * (dp[i][e] - delta_r[e >> 1]);  // ds
        }
        acc_as_a(s[i], a[i]);
      }
      tile_acc_tc<NT, KD, 2, kWideOut, false>(acc, a, st, st, gid, tig);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  float* o = dq + ((long long)b * T * H + h) * D;
#pragma unroll
  for (int j = 0; j < KD; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = q0 + m0 + gid + 8 * (e >> 1);
      const int d = n0 + j * 8 + 2 * tig + (e & 1);
      if (r < T && d < D) o[(long long)r * H * D + d] = acc[j][e] * scale;
    }
}

// K9, wide: dk and dv of one K tile of one (b, h), output columns
// blockIdx.y * kWideOut ..
__global__ void __launch_bounds__(kThreads)
flash_dkv_wide_kernel(View q, View k, View v, View dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int T,
                      int H, int D, float scale, int causal, int window,
                      unsigned vec) {
  constexpr int BQ = kDkvWideBQ, LC = kWideLC, LO = kWideLO, NT = BQ / 8;
  constexpr int KD = kWideOut / 8, kSlot = kDkvWideSlot;
  extern __shared__ float4 smem4[];
  // a chunk step: K, V [kRows][LC], Q, dO [BQ][LC]; the output step: Q's
  // and dO's columns [BQ][LO], lse, delta [BQ]
  float* slots = reinterpret_cast<float*>(smem4);  // 2 x kSlot

  const int ntiles = (T + kRows - 1) / kRows;
  const int bh = blockIdx.x / ntiles, jk = blockIdx.x % ntiles;
  const int b = bh / H, h = bh % H;
  const int c0 = jk * kRows, n0 = blockIdx.y * kWideOut;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3, m0 = warp * 16;

  int lo = 0, hi = (T - 1) / BQ;
  if (causal) {
    lo = c0 / BQ;
    if (window > 0)
      hi = (int)min((long long)hi,
                    ((long long)c0 + kRows - 1 + window - 1) / BQ);
  }
  const int nc = (D + kWideChunk - 1) / kWideChunk, per = nc + 1;
  const int steps = (hi - lo + 1) * per;

  const float* qb = row_base(q, b, h);
  const float* ob = row_base(dout, b, h);
  const float* kb = row_base(k, b, h);
  const float* vb = row_base(v, b, h);
  const float* lse_b = lse + (long long)bh * T;
  const float* delta_b = delta + (long long)bh * T;
  auto load = [&](int j) {
    float* st = slots + (j & 1) * kSlot;
    const int c = j % per, r0 = (lo + j / per) * BQ;
    if (c < nc) {
      copy_chunk<kRows>(st, kb, k.st, c0, T, D, c, vec & 2);
      copy_chunk<kRows>(st + kRows * LC, vb, v.st, c0, T, D, c, vec & 4);
      copy_chunk<BQ>(st + 2 * kRows * LC, qb, q.st, r0, T, D, c, vec & 1);
      copy_chunk<BQ>(st + (2 * kRows + BQ) * LC, ob, dout.st, r0, T, D, c,
                     vec & 8);
    } else {
      copy_rows<BQ, kWideOut>(st, qb + n0, q.st, r0, T, D - n0, vec & 1);
      copy_rows<BQ, kWideOut>(st + BQ * LO, ob + n0, dout.st, r0, T, D - n0,
                              vec & 8);
      copy_stats<BQ>(st + 2 * BQ * LO, lse_b, delta_b, r0, T);
    }
  };
  load(0);
  cp_async_commit();

  // the thread's keys: c0 + m0 + gid and 8 below; columns n0 + 8 j ..
  float dk_acc[KD][4], dv_acc[KD][4], s[NT][4], dp[NT][4];
#pragma unroll
  for (int j = 0; j < KD; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int j = 0; j < steps; ++j) {
    if (j + 1 < steps) load(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* st = slots + (j & 1) * kSlot;
    const int c = j % per, q0 = (lo + j / per) * BQ;
    if (c < nc) {
      chunk_qk<NT>(s, st + m0 * LC, st + 2 * kRows * LC, c == 0, gid,
                   tig);                                     // (q k^T)^T
      chunk_qk<NT>(dp, st + (kRows + m0) * LC, st + (2 * kRows + BQ) * LC,
                   c == 0, gid, tig);                        // (dO v^T)^T
    } else {
      const float* lse_s = st + 2 * BQ * LO;
      const float* delta_s = lse_s + BQ;
      const bool edge = tile_masked(q0, q0 + BQ - 1, c0 + m0, c0 + m0 + 15,
                                    T, causal, window);
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = c0 + m0 + gid + 8 * (e >> 1);
          const int col = i * 8 + 2 * tig + (e & 1);
          const float p = edge && masked(q0 + col, key, T, causal, window)
                              ? 0.f
                              : expf(s[i][e] * scale - lse_s[col]);
          s[i][e] = p;
          dp[i][e] = p * (dp[i][e] - delta_s[col]);  // ds
        }
      SplitA a[NT];
#pragma unroll
      for (int i = 0; i < NT; ++i) acc_as_a(s[i], a[i]);
      tile_acc_tc<NT, KD, 2, kWideOut, false>(dv_acc, a, st + BQ * LO,
                                              st + BQ * LO, gid, tig);
#pragma unroll
      for (int i = 0; i < NT; ++i) acc_as_a(dp[i], a[i]);
      tile_acc_tc<NT, KD, 2, kWideOut, false>(dk_acc, a, st, st, gid, tig);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  const long long off = ((long long)b * T * H + h) * D;
#pragma unroll
  for (int j = 0; j < KD; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = c0 + m0 + gid + 8 * (e >> 1);
      const int d = n0 + j * 8 + 2 * tig + (e & 1);
      if (key < T && d < D) {
        dk[off + (long long)key * H * D + d] = dk_acc[j][e] * scale;
        dv[off + (long long)key * H * D + d] = dv_acc[j][e];
      }
    }
}

// opt a kernel into its dynamic shared memory (past the default 48 KB)
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// may v's rows be copied 16 bytes at a time? (its base and strides are
// multiples of 16 bytes; a ragged D zero-fills the last chunk)
bool rows16(const View& v) {
  return reinterpret_cast<uintptr_t>(v.p) % 16 == 0 && v.sb % 4 == 0 &&
         v.st % 4 == 0 && v.sh % 4 == 0;
}

// the kernels' vec bits: q 1, k 2, v 4, dO 8
unsigned vec_bits(const View& q, const View& k, const View& v,
                  const View& dout) {
  return (unsigned)rows16(q) | (unsigned)rows16(k) << 1 |
         (unsigned)rows16(v) << 2 | (unsigned)rows16(dout) << 3;
}

template <int DMAX>
cudaError_t fwd(View q, View k, View v, float* out, float* lse, int B,
                int T, int H, int D, float scale, int causal, int window,
                cudaStream_t s) {
  constexpr size_t smem = fwd_smem<DMAX>();
  constexpr int kDV = FwdPlan<DMAX>::kDV;
  const cudaError_t e = allow_smem(flash_fwd_kernel<DMAX>, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)B * H * ((T + kRows - 1) / kRows);
  const dim3 grid((unsigned)blocks, (unsigned)((D + kDV - 1) / kDV));
  flash_fwd_kernel<DMAX><<<grid, kThreads, smem, s>>>(
      q, k, v, out, lse, T, H, D, scale, causal, window,
      vec_bits(q, k, v, q));
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t bwd_dq(View q, View k, View v, View dout, const float* lse,
                   const float* delta, float* dq, int B, int T, int H,
                   int D, float scale, int causal, int window,
                   cudaStream_t s) {
  constexpr size_t smem = dq_smem<DMAX>();
  const cudaError_t e = allow_smem(flash_dq_kernel<DMAX>, smem);
  if (e != cudaSuccess) return e;
  const long long blocks =
      (long long)B * H * ((T + kRows - 1) / kRows);
  flash_dq_kernel<DMAX><<<(unsigned)blocks, kThreads, smem, s>>>(
      q, k, v, dout, lse, delta, dq, T, H, D, scale, causal, window,
      vec_bits(q, k, v, dout));
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t bwd_dkv(View q, View k, View v, View dout, const float* lse,
                    const float* delta, float* dk, float* dv, int B, int T,
                    int H, int D, float scale, int causal, int window,
                    cudaStream_t s) {
  constexpr size_t smem = dkv_smem<DMAX>();
  constexpr int kDS = DkvPlan<DMAX>::kDS;
  const cudaError_t e = allow_smem(flash_dkv_kernel<DMAX>, smem);
  if (e != cudaSuccess) return e;
  const long long blocks =
      (long long)B * H * ((T + kRows - 1) / kRows);
  const dim3 grid((unsigned)blocks, (unsigned)((D + kDS - 1) / kDS));
  flash_dkv_kernel<DMAX><<<grid, kThreads, smem, s>>>(
      q, k, v, dout, lse, delta, dk, dv, T, H, D, scale, causal, window,
      vec_bits(q, k, v, dout));
  return cudaGetLastError();
}

// the wide path's grid: (B * H * Q or K tiles, output column CTAs)
dim3 wide_grid(int B, int T, int H, int D) {
  const long long blocks = (long long)B * H * ((T + kRows - 1) / kRows);
  return dim3((unsigned)blocks, (unsigned)((D + kWideOut - 1) / kWideOut));
}

cudaError_t fwd_wide(View q, View k, View v, float* out, float* lse, int B,
                     int T, int H, int D, float scale, int causal,
                     int window, cudaStream_t s) {
  constexpr size_t smem = sizeof(float) * 2 * kFwdWideSlot;
  const cudaError_t e = allow_smem(flash_fwd_wide_kernel, smem);
  if (e != cudaSuccess) return e;
  flash_fwd_wide_kernel<<<wide_grid(B, T, H, D), kThreads, smem, s>>>(
      q, k, v, out, lse, T, H, D, scale, causal, window,
      vec_bits(q, k, v, q));
  return cudaGetLastError();
}

cudaError_t dq_wide(View q, View k, View v, View dout, const float* lse,
                    const float* delta, float* dq, int B, int T, int H,
                    int D, float scale, int causal, int window,
                    cudaStream_t s) {
  constexpr size_t smem = sizeof(float) * 2 * kDqWideSlot;
  const cudaError_t e = allow_smem(flash_dq_wide_kernel, smem);
  if (e != cudaSuccess) return e;
  flash_dq_wide_kernel<<<wide_grid(B, T, H, D), kThreads, smem, s>>>(
      q, k, v, dout, lse, delta, dq, T, H, D, scale, causal, window,
      vec_bits(q, k, v, dout));
  return cudaGetLastError();
}

cudaError_t dkv_wide(View q, View k, View v, View dout, const float* lse,
                     const float* delta, float* dk, float* dv, int B, int T,
                     int H, int D, float scale, int causal, int window,
                     cudaStream_t s) {
  constexpr size_t smem = sizeof(float) * 2 * kDkvWideSlot;
  const cudaError_t e = allow_smem(flash_dkv_wide_kernel, smem);
  if (e != cudaSuccess) return e;
  flash_dkv_wide_kernel<<<wide_grid(B, T, H, D), kThreads, smem, s>>>(
      q, k, v, dout, lse, delta, dk, dv, T, H, D, scale, causal, window,
      vec_bits(q, k, v, dout));
  return cudaGetLastError();
}

// the instantiation for a head dim D: the smallest of 32, 64, 128, 256
// >= D (the zero-padded columns cost work, not results); past 256 the
// wide path, up to 65535 column CTAs
template <typename F, typename W>
int dispatch(int B, int T, int D, F&& launch, W&& wide) {
  if (D < 1 || B < 1 || T < 1 || (D + kWideOut - 1) / kWideOut > 65535)
    return (int)cudaErrorInvalidValue;
  if (D <= 32) return (int)launch(std::integral_constant<int, 32>());
  if (D <= 64) return (int)launch(std::integral_constant<int, 64>());
  if (D <= 128) return (int)launch(std::integral_constant<int, 128>());
  if (D <= 256) return (int)launch(std::integral_constant<int, 256>());
  return (int)wide();
}

}  // namespace

extern "C" {

// q, k, v: [B, T, H, D] f32, element (b, t, h, d) at
// x[b * x_sb + t * x_st + h * x_sh + d]; out: contiguous [B, T, H, D];
// lse: [B * H, T].  causal 0/1; window 0 = none (else >= 1, causal).
int vt_flash_fwd(const float* q, long long q_sb, long long q_st,
                 long long q_sh, const float* k, long long k_sb,
                 long long k_st, long long k_sh, const float* v,
                 long long v_sb, long long v_st, long long v_sh, float* out,
                 float* lse, int B, int T, int H, int D, float scale,
                 int causal, int window, void* stream) {
  const View qv{q, q_sb, q_st, q_sh}, kv{k, k_sb, k_st, k_sh},
      vv{v, v_sb, v_st, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(
      B, T, D,
      [&](auto dm) {
        return fwd<decltype(dm)::value>(qv, kv, vv, out, lse, B, T, H, D,
                                        scale, causal, window, s);
      },
      [&] {
        return fwd_wide(qv, kv, vv, out, lse, B, T, H, D, scale, causal,
                        window, s);
      });
}

// dout: [B, T, H, D] by strides as q; lse and delta: [B * H, T];
// dq: contiguous [B, T, H, D]
int vt_flash_dq(const float* q, long long q_sb, long long q_st,
                long long q_sh, const float* k, long long k_sb,
                long long k_st, long long k_sh, const float* v,
                long long v_sb, long long v_st, long long v_sh,
                const float* dout, long long o_sb, long long o_st,
                long long o_sh, const float* lse, const float* delta,
                float* dq, int B, int T, int H, int D, float scale,
                int causal, int window, void* stream) {
  const View qv{q, q_sb, q_st, q_sh}, kv{k, k_sb, k_st, k_sh},
      vv{v, v_sb, v_st, v_sh}, ov{dout, o_sb, o_st, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(
      B, T, D,
      [&](auto dm) {
        return bwd_dq<decltype(dm)::value>(qv, kv, vv, ov, lse, delta, dq, B,
                                           T, H, D, scale, causal, window, s);
      },
      [&] {
        return dq_wide(qv, kv, vv, ov, lse, delta, dq, B, T, H, D, scale,
                       causal, window, s);
      });
}

// as vt_flash_dq; dk, dv: contiguous [B, T, H, D]
int vt_flash_dkv(const float* q, long long q_sb, long long q_st,
                 long long q_sh, const float* k, long long k_sb,
                 long long k_st, long long k_sh, const float* v,
                 long long v_sb, long long v_st, long long v_sh,
                 const float* dout, long long o_sb, long long o_st,
                 long long o_sh, const float* lse, const float* delta,
                 float* dk, float* dv, int B, int T, int H, int D,
                 float scale, int causal, int window, void* stream) {
  const View qv{q, q_sb, q_st, q_sh}, kv{k, k_sb, k_st, k_sh},
      vv{v, v_sb, v_st, v_sh}, ov{dout, o_sb, o_st, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(
      B, T, D,
      [&](auto dm) {
        return bwd_dkv<decltype(dm)::value>(qv, kv, vv, ov, lse, delta, dk,
                                            dv, B, T, H, D, scale, causal,
                                            window, s);
      },
      [&] {
        return dkv_wide(qv, kv, vv, ov, lse, delta, dk, dv, B, T, H, D,
                        scale, causal, window, s);
      });
}

const char* vt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
