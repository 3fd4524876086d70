// Compensated blocked f32 GEMM for Hopper (sm_90a): out = a @ b.
//
// Replaces the kernel of veles_tpu/znicz/gemm.py:_matmul_impl (the body
// behind precise_matmul): the reference's PRECISION_LEVEL 0/1/2.  K is
// cut into tiles of kBK = 256 columns (DEFAULT_BLOCK_K); each tile's
// partial product p is summed plainly, and the running sum of the tiles
// is compensated:
//   level 0: acc += p
//   level 1: Neumaier, (acc, e) = TwoSum(acc, p); c1 += e
//   level 2: Klein, (acc, e) = TwoSum(acc, p); (c1, e2) = TwoSum(c1, e);
//            c2 += e2
// and the carries fold in once, after the last tile: acc + (c1 + c2).
// The TwoSum and the fold use __fadd_rn / __fsub_rn, which nvcc never
// contracts into FMAs or reorders, so the compensation survives -O3.
// The tile partials come from the tensor cores in 3xTF32: each operand
// splits as x = hi + lo, hi = rna_tf32(x), lo = rna_tf32(x - hi)
// (hi + lo keeps 22 of x's 24 bits), and every 8-deep step adds
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (mma.sync m16n8k8, TF32 in, f32
// accumulation), the small products first; a_lo.b_lo (2^-22 of the
// product and below) is left out.  The TPU kernel asked for
// Precision.HIGHEST, which the MXU meets the same way, in bf16 passes.
//
// What bounds it on the card: 6MNK TF32 tensor-core operations at 495
// TFLOP/s for the large shapes (2MNK f32 FMAs on the CUDA cores would be
// 67 TFLOP/s); at MNIST's shapes (M = 60 rows) a grid of one or two CTAs
// on 132 SMs, and the launch itself.  What the design does about it:
// - one CTA per 128 x 64 output tile, 8 warps of 32 x 32 (two m16 by four
//   n8 mma tiles), 32 outputs a thread (level 2 holds p, acc, c1 and c2
//   for each: 128 registers of state);
// - K staged 64 columns at a time through a ring of 3 buffers in shared
//   memory (up to 160 KB) filled by cp.async, so the next stage is in
//   flight while the current one is multiplied; one barrier per stage;
// - each thread reads its fragments from shared memory without bank
//   conflicts in either staging layout and splits them with two integer
//   ops each; the next 8-deep step's fragments are read while the tensor
//   cores work on this one, and the three products go in three passes
//   over the 8 mma tiles, so no mma waits on the one before it;
// - each operand is staged in its own layout (k-contiguous or not, a
//   template parameter), so row-major operands and transposed views (the
//   backward's g @ b^T and a^T @ g) cost no copy; 16-byte copies along
//   the unit-stride axis when the base and the row stride are multiples
//   of 4 floats, 4-byte copies otherwise (N = 10 on the MNIST path);
// - split-K over the compensation tiles when the output grid has fewer
//   CTAs than the card has SMs: each CTA computes one (output tile, K
//   tile) partial into a workspace [tiles_k, M, N], and a second launch
//   folds the partials in ascending K order with the level's recurrence.
//   Every output sees the same partials in the same order as without the
//   split, so the split result is bit-equal to the unsplit one;
// - CTAs walk the output tiles in groups of 8 tile rows, so the tiles in
//   flight share their A and B panels in L2.
// No wgmma and no TMA.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 64, kBKs = 64, kStages = 3;
constexpr int kBK = 256;  // the unit of compensated accumulation
// 8 warps as 4 (m) x 2 (n), each 32 x 32: kMI m16 tiles by kNI n8 tiles
constexpr int kWM = 32, kWN = 32, kMI = kWM / 16, kNI = kWN / 8;
constexpr int kThreads = (kBM / kWM) * (kBN / kWN) * 32;  // 256
constexpr int kGroupM = 8;           // tile rows walked together
// shared-memory leading dimensions: 4 mod 32 floats for k-contiguous
// tiles, 8 mod 32 for the others, so a warp's fragment reads (rows gid,
// columns tig) hit 32 distinct banks; multiples of 4 for 16-byte copies
constexpr int kLdK = kBKs + 4;
constexpr int kLdAM = kBM + 8, kLdBN = kBN + 8;
static_assert(kLdK % 32 == 4 && kLdAM % 32 == 8 && kLdBN % 32 == 8,
              "fragment reads must not conflict");
static_assert(kBK % kBKs == 0, "a stage must not straddle two K tiles");
static_assert(kBM * kBKs % (4 * kThreads) == 0 &&
                  kBN * kBKs % (4 * kThreads) == 0,
              "every thread copies whole 16-byte chunks of each stage");

// A staged [m][k] (AK: a is k-contiguous) or [k][m]; B staged [k][n]
// (BN: b is n-contiguous) or [n][k]
template <bool AK>
__host__ __device__ constexpr int a_floats() {
  return AK ? kBM * kLdK : kBKs * kLdAM;
}
template <bool BN>
__host__ __device__ constexpr int b_floats() {
  return BN ? kBKs * kLdBN : kBN * kLdK;
}
template <bool AK, bool BN>
__host__ __device__ constexpr int stage_floats() {
  return a_floats<AK>() + b_floats<BN>();
}

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  // Knuth's TwoSum: a + b == s + e exactly
  s = __fadd_rn(a, b);
  const float v = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, v)), __fsub_rn(b, v));
}

// fold one tile partial p into the running sum at LEVEL
template <int LEVEL>
__device__ __forceinline__ void compensate(float p, float& acc, float& c1,
                                           float& c2) {
  if (LEVEL == 0) {
    acc = __fadd_rn(acc, p);
  } else {
    float s, e;
    two_sum(acc, p, s, e);
    acc = s;
    if (LEVEL == 1) {
      c1 = __fadd_rn(c1, e);
    } else {
      float s1, e2;
      two_sum(c1, e, s1, e2);
      c1 = s1;
      c2 = __fadd_rn(c2, e2);
    }
  }
}

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

__device__ __forceinline__ int clamp4(int n) { return max(0, min(4, n)); }

// copy one stage of A (rows m0.., columns k0..) into As; bytes past M
// or K are zero-filled.  Each of the four copy loops walks the operand's
// unit-stride axis with consecutive threads
template <bool AK>
__device__ __forceinline__ void load_a(float* As, const float* a, int m0,
                                       int k0, int M, int K, long long sam,
                                       long long sak, bool vec,
                                       unsigned tid) {
  if (AK && vec) {  // kBM rows x kBKs / 4 chunks of 4 k
    constexpr int kRow = kBKs / 4;
#pragma unroll
    for (int i = 0; i < kBM * kRow / kThreads; ++i) {
      const unsigned c = tid + i * kThreads;
      const int r = c / kRow, kq = c % kRow * 4;
      const int gm = m0 + r, gk = k0 + kq;
      const int n = gm < M ? clamp4(K - gk) : 0;
      cp_async16(As + r * kLdK + kq, n ? a + gm * sam + gk : a, 4 * n);
    }
  } else if (AK) {  // kBM rows x kBKs k
#pragma unroll
    for (int i = 0; i < kBM * kBKs / kThreads; ++i) {
      const unsigned e = tid + i * kThreads;
      const int r = e / kBKs, kk = e % kBKs;
      const int gm = m0 + r, gk = k0 + kk;
      const bool ok = gm < M && gk < K;
      cp_async4(As + r * kLdK + kk, ok ? a + gm * sam + gk : a, ok ? 4 : 0);
    }
  } else if (vec) {  // m-contiguous: kBKs k x kBM / 4 chunks of 4 m
    constexpr int kRow = kBM / 4;
#pragma unroll
    for (int i = 0; i < kBKs * kRow / kThreads; ++i) {
      const unsigned c = tid + i * kThreads;
      const int kk = c / kRow, mq = c % kRow * 4;
      const int gm = m0 + mq, gk = k0 + kk;
      const int n = gk < K ? clamp4(M - gm) : 0;
      cp_async16(As + kk * kLdAM + mq, n ? a + gm + gk * sak : a, 4 * n);
    }
  } else {  // any strides: kBKs k x kBM m
#pragma unroll
    for (int i = 0; i < kBKs * kBM / kThreads; ++i) {
      const unsigned e = tid + i * kThreads;
      const int kk = e / kBM, r = e % kBM;
      const int gm = m0 + r, gk = k0 + kk;
      const bool ok = gm < M && gk < K;
      cp_async4(As + kk * kLdAM + r, ok ? a + gm * sam + gk * sak : a,
                ok ? 4 : 0);
    }
  }
}

// copy one stage of B (rows k0.., columns n0..) into Bs
template <bool BN>
__device__ __forceinline__ void load_b(float* Bs, const float* b, int k0,
                                       int n0, int K, int N, long long sbk,
                                       long long sbn, bool vec,
                                       unsigned tid) {
  if (BN && vec) {  // kBKs k x kBN / 4 chunks of 4 n
    constexpr int kRow = kBN / 4;
#pragma unroll
    for (int i = 0; i < kBKs * kRow / kThreads; ++i) {
      const unsigned c = tid + i * kThreads;
      const int kk = c / kRow, nq = c % kRow * 4;
      const int gk = k0 + kk, gn = n0 + nq;
      const int n = gk < K ? clamp4(N - gn) : 0;
      cp_async16(Bs + kk * kLdBN + nq, n ? b + gk * sbk + gn : b, 4 * n);
    }
  } else if (BN) {  // kBKs k x kBN n
#pragma unroll
    for (int i = 0; i < kBKs * kBN / kThreads; ++i) {
      const unsigned e = tid + i * kThreads;
      const int kk = e / kBN, c = e % kBN;
      const int gk = k0 + kk, gn = n0 + c;
      const bool ok = gk < K && gn < N;
      cp_async4(Bs + kk * kLdBN + c, ok ? b + gk * sbk + gn : b, ok ? 4 : 0);
    }
  } else if (vec) {  // k-contiguous: kBN n x kBKs / 4 chunks of 4 k
    constexpr int kRow = kBKs / 4;
#pragma unroll
    for (int i = 0; i < kBN * kRow / kThreads; ++i) {
      const unsigned c = tid + i * kThreads;
      const int r = c / kRow, kq = c % kRow * 4;
      const int gk = k0 + kq, gn = n0 + r;
      const int n = gn < N ? clamp4(K - gk) : 0;
      cp_async16(Bs + r * kLdK + kq, n ? b + gn * sbn + gk : b, 4 * n);
    }
  } else {  // any strides: kBN n x kBKs k
#pragma unroll
    for (int i = 0; i < kBN * kBKs / kThreads; ++i) {
      const unsigned e = tid + i * kThreads;
      const int r = e / kBKs, kk = e % kBKs;
      const int gk = k0 + kk, gn = n0 + r;
      const bool ok = gk < K && gn < N;
      cp_async4(Bs + r * kLdK + kk, ok ? b + gk * sbk + gn * sbn : b,
                ok ? 4 : 0);
    }
  }
}

// one 8-deep step's operand fragments of a warp's 32 x 32 tile, split
struct Frags {
  uint32_t ahi[kMI][4], alo[kMI][4], bhi[kNI][2], blo[kNI][2];
};

// read the step at column kk of the staged A and B and split it
template <bool AK, bool BN>
__device__ __forceinline__ void load_frags(Frags& f, const float* As,
                                           const float* Bs, int kk, int wm,
                                           int wn, int gid, int tig) {
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = wm + i * 16 + gid + (e & 1) * 8;
      const int k = kk + tig + (e >> 1) * 4;
      split_tf32(AK ? As[r * kLdK + k] : As[k * kLdAM + r], f.ahi[i][e],
                 f.alo[i][e]);
    }
#pragma unroll
  for (int j = 0; j < kNI; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = wn + j * 8 + gid, k = kk + tig + e * 4;
      split_tf32(BN ? Bs[k * kLdBN + c] : Bs[c * kLdK + k], f.bhi[j][e],
                 f.blo[j][e]);
    }
}

// out = a @ b (split == 0), or the partial of K tile blockIdx.y into
// ws[blockIdx.y] (split > 0)
template <int LEVEL, bool AK, bool BN>
__global__ void __launch_bounds__(kThreads)
precise_matmul_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, float* __restrict__ out,
                      float* __restrict__ ws, int M, int N, int K,
                      long long sam, long long sak, long long sbk,
                      long long sbn, bool vec_a, bool vec_b, int split) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStage = stage_floats<AK, BN>();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the mma fragments' row (gid) and column (tig) within a warp tile
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp / (kBN / kWN)) * kWM, wn = (warp % (kBN / kWN)) * kWN;
  // grouped walk over the output tiles
  const int tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  const int width = kGroupM * tiles_n, pid = blockIdx.x;
  const int first_m = (pid / width) * kGroupM;
  const int rows = min(tiles_m - first_m, kGroupM);
  const int m0 = (first_m + (pid % width) % rows) * kBM;
  const int n0 = ((pid % width) / rows) * kBN;
  const int kbeg = split ? blockIdx.y * kBK : 0;
  const int kend = split ? min(kbeg + kBK, K) : K;
  const int nst = (kend - kbeg + kBKs - 1) / kBKs;

  // p[mi][ni][e]: the tile partial of fragment element e, e = 0..3 at
  // (row gid + 8 (e / 2), column 2 tig + e % 2) of mma tile (mi, ni)
  float p[kMI][kNI][4], acc[kMI][kNI][4], c1[kMI][kNI][4], c2[kMI][kNI][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[i][j][e] = acc[i][j][e] = c1[i][j][e] = c2[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) {
      float* st = smem + s * kStage;
      load_a<AK>(st, a, m0, kbeg + s * kBKs, M, K, sam, sak, vec_a, tid);
      load_b<BN>(st + a_floats<AK>(), b, kbeg + s * kBKs, n0, K, N, sbk,
                 sbn, vec_b, tid);
    }
    cp_async_commit();
  }

  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {  // refill the buffer every thread finished with last iteration
      const int nx = s + kStages - 1;
      if (nx < nst) {
        float* st = smem + (nx % kStages) * kStage;
        load_a<AK>(st, a, m0, kbeg + nx * kBKs, M, K, sam, sak, vec_a, tid);
        load_b<BN>(st + a_floats<AK>(), b, kbeg + nx * kBKs, n0, K, N, sbk,
                   sbn, vec_b, tid);
      }
      cp_async_commit();
    }
    const float* As = smem + (s % kStages) * kStage;
    const float* Bs = As + a_floats<AK>();
    // the fragments of the next 8-deep step are read and split while the
    // tensor cores work on this one
    Frags f[2];
    load_frags<AK, BN>(f[0], As, Bs, 0, wm, wn, gid, tig);
#pragma unroll
    for (int kk = 0; kk < kBKs; kk += 8) {
      Frags& cur = f[(kk / 8) & 1];
      if (kk + 8 < kBKs)
        load_frags<AK, BN>(f[((kk / 8) + 1) & 1], As, Bs, kk + 8, wm, wn,
                           gid, tig);
      // the three products of a tile in separate passes, so that no mma
      // waits on the one just before it
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNI; ++j) mma_tf32(p[i][j], cur.alo[i], cur.bhi[j]);
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNI; ++j) mma_tf32(p[i][j], cur.ahi[i], cur.blo[j]);
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNI; ++j) mma_tf32(p[i][j], cur.ahi[i], cur.bhi[j]);
    }
    if (!split && (((s + 1) % (kBK / kBKs)) == 0 || s == nst - 1)) {
      // a K tile is done: compensate its partial into the running sum
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            compensate<LEVEL>(p[i][j][e], acc[i][j][e], c1[i][j][e],
                              c2[i][j][e]);
            p[i][j][e] = 0.f;
          }
    }
  }
  cp_async_wait<0>();

  float* dst = split ? ws + (size_t)blockIdx.y * M * N : out;
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gm = m0 + wm + i * 16 + gid + (e >> 1) * 8;
        const int gn = n0 + wn + j * 8 + 2 * tig + (e & 1);
        if (gm < M && gn < N)
          dst[(size_t)gm * N + gn] =
              split ? p[i][j][e]
                    : __fadd_rn(acc[i][j][e],
                                __fadd_rn(c1[i][j][e], c2[i][j][e]));
      }
}

// fold the split partials ws[0..tiles) in ascending K order
template <int LEVEL>
__global__ void __launch_bounds__(256)
precise_fold_kernel(const float* __restrict__ ws, float* __restrict__ out,
                    long long mn, int tiles) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < mn; i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f, c1 = 0.f, c2 = 0.f;
    for (int t = 0; t < tiles; ++t)
      compensate<LEVEL>(ws[t * mn + i], acc, c1, c2);
    out[i] = __fadd_rn(acc, __fadd_rn(c1, c2));
  }
}

template <int LEVEL, bool AK, bool BN>
int launch(const float* a, const float* b, float* out, float* ws, int M,
           int N, int K, long long sam, long long sak, long long sbk,
           long long sbn, bool vec_a, bool vec_b, int split,
           cudaStream_t s) {
  constexpr int kSmem = kStages * stage_floats<AK, BN>() * sizeof(float);
  auto kernel = precise_matmul_kernel<LEVEL, AK, BN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  kernel<<<dim3(tiles, split ? split : 1), kThreads, kSmem, s>>>(
      a, b, out, ws, M, N, K, sam, sak, sbk, sbn, vec_a, vec_b, split);
  if (split) {
    const long long mn = (long long)M * N;
    const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256
                                                       : 4096);
    precise_fold_kernel<LEVEL><<<blocks, 256, 0, s>>>(ws, out, mn, split);
  }
  return (int)cudaGetLastError();
}

template <int LEVEL>
int launch_level(const float* a, const float* b, float* out, float* ws,
                 int M, int N, int K, long long sam, long long sak,
                 long long sbk, long long sbn, int split, cudaStream_t s) {
  const bool ak = sak == 1, bn = sbn == 1;
  const bool a16 = reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool b16 = reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const bool vec_a = a16 && (ak ? sam % 4 == 0 : sam == 1 && sak % 4 == 0);
  const bool vec_b = b16 && (bn ? sbk % 4 == 0 : sbk == 1 && sbn % 4 == 0);
  if (ak && bn)
    return launch<LEVEL, true, true>(a, b, out, ws, M, N, K, sam, sak, sbk,
                                     sbn, vec_a, vec_b, split, s);
  if (ak)
    return launch<LEVEL, true, false>(a, b, out, ws, M, N, K, sam, sak, sbk,
                                      sbn, vec_a, vec_b, split, s);
  if (bn)
    return launch<LEVEL, false, true>(a, b, out, ws, M, N, K, sam, sak, sbk,
                                      sbn, vec_a, vec_b, split, s);
  return launch<LEVEL, false, false>(a, b, out, ws, M, N, K, sam, sak, sbk,
                                     sbn, vec_a, vec_b, split, s);
}

}  // namespace

extern "C" {

// the number of K tiles a call splits over (0: no split): split when
// the output grid has fewer CTAs than the card has SMs, K spans at least
// two tiles, and the workspace stays under 256 MB and the grid's second
// dimension under its limit
int vt_precise_matmul_split(int M, int N, int K, int sm_count) {
  const long long ctas = (long long)((M + kBM - 1) / kBM) *
                         ((N + kBN - 1) / kBN);
  const int tiles_k = (K + kBK - 1) / kBK;
  if (ctas >= sm_count || tiles_k < 2 || tiles_k > 65535 ||
      (long long)tiles_k * M * N > (1LL << 26))
    return 0;
  return tiles_k;
}

// out [M, N] row-major; a[m, k] at a[m * sam + k * sak], b[k, n] at
// b[k * sbk + n * sbn] (element strides); split > 0 needs ws with
// split * M * N floats (vt_precise_matmul_split gives split)
int vt_precise_matmul(const float* a, const float* b, float* out, float* ws,
                      int M, int N, int K, long long sam, long long sak,
                      long long sbk, long long sbn, int level, int split,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split && (ws == nullptr || split != (K + kBK - 1) / kBK))
    return (int)cudaErrorInvalidValue;
  switch (level) {
    case 0:
      return launch_level<0>(a, b, out, ws, M, N, K, sam, sak, sbk, sbn,
                             split, s);
    case 1:
      return launch_level<1>(a, b, out, ws, M, N, K, sam, sak, sbk, sbn,
                             split, s);
    case 2:
      return launch_level<2>(a, b, out, ws, M, N, K, sam, sak, sbk, sbn,
                             split, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* vt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
