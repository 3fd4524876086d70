// Weight-quantized GEMM for Hopper (sm_90a): out = (a @ upcast(w_q)) * scales.
//
// Replaces the kernel of veles_tpu/znicz/gemm.py:quantized_matmul: f32
// activations a [M, K] times int8 or float8-e4m3 weights w_q [K, N] with
// one f32 scale per output channel, scales [N].  The scales are constant
// along K, so they multiply the finished sum once after the K loop.
//
// What bounds it on the card: at decode shapes (M of 1-16 rows, K x N in
// the thousands) the weight bytes, read once at 3.35 TB/s; at larger M
// the products, 4MNK TF32 tensor-core operations at 495 TFLOP/s (2MNK
// f32 FMAs on the CUDA cores would be 67 TFLOP/s).
//
// What the design does about it:
// - the tile follows M: 16 x 128 output tiles (four warps of 16 x 32)
//   for M <= 16, the decode step's rows an expert; 64 x 128 (four warps
//   of 32 x 64) above that;
// - split-K when the output grid has fewer CTAs than the card has SMs:
//   each CTA sums one K range of its tile into a workspace [split, M, N]
//   and a second launch adds the partials in ascending K order, then
//   applies the scales (no atomics: the same call gives the same bits);
//   vt_quantized_matmul_plan picks the tile and the split;
// - K staged 64 deep through a ring of 4 buffers in shared memory filled
//   by cp.async, so three stages are in flight while one is multiplied;
//   the weights cross HBM and sit in shared memory in their quantized
//   width (16-byte copies, 16 weights each, when N and the base allow;
//   4-byte copies, or plain byte loads, otherwise; zero fill past K and
//   N), and are upcast to f32 in registers as each fragment is read;
// - the products run on the tensor cores in 2xTF32 (mma.sync m16n8k8,
//   TF32 in, f32 accumulation): every int8 value (|q| <= 128) and every
//   finite e4m3 value (4 significant bits, subnormals included) is exact
//   in TF32, so 3xTF32's a_hi.w_lo term is zero; a splits as
//   hi = rna_tf32(a), lo = rna_tf32(a - hi) (22 of its 24 bits), and
//   every 8-deep step adds a_lo.w, then a_hi.w, to the stage's partial;
//   the partial of each 64-deep stage (16 mma accumulations) is added to
//   the f32 sum of the K range with an IEEE add.  The tensor cores'
//   accumulation does not round like an IEEE add: summed in their
//   accumulator over 4096 columns (1024 mma) the error grew to 1.7e-5 of
//   the largest output on the card, past the 1e-5 limit.  K3's
//   reference is a plain sum, so there is no compensation.  The TPU
//   kernel asked for Precision.HIGHEST, which the MXU meets in bf16
//   passes;
// - a warp's columns are read as one 32- or 64-bit word of 4 or 8 bytes
//   a thread and K step: byte j feeds n8 tile j, so thread (gid, tig) of
//   the mma fragments holds 8 or 16 adjacent columns of its rows, stored
//   as float4s.  Both fragment reads are free of bank conflicts.
// No wgmma and no TMA.

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBN = 128, kBK = 64, kStages = 4;
// a split takes at least this many K columns
constexpr int kMinSplitK = 256;
// shared-memory leading dimensions: the A tile in floats, the weight
// tile in bytes; multiples of 16 bytes for the 16-byte copies
constexpr int kLdA = kBK + 4, kLdW = kBN + 32;
// fragment reads: A rows 4 words apart, weight rows 8 words apart, so a
// warp's reads of either hit every bank once
static_assert(kLdA % 32 == 4 && kLdW / 4 % 32 == 8 && kLdW % 16 == 0,
              "bank conflicts or misaligned rows");

// how the weights are copied: 16-byte or 4-byte cp.async, or byte loads
enum WMode { kW16 = 0, kW4 = 1, kW1 = 2 };

struct Int8 {};
struct Fp8 {};

// a CTA's output tile: BM x kBN, four warps of kWM x WN, each kMI m16 by
// kNI n8 mma tiles
template <int BM, int WN>
struct Tile {
  static constexpr int kBM = BM, kWN = WN;
  static constexpr int kWM = BM == 16 ? 16 : 32;
  static constexpr int kMI = kWM / 16, kNI = WN / 8;
  static constexpr int kWarpsN = kBN / WN;
  static constexpr int kThreads = (BM / kWM) * kWarpsN * 32;
  static constexpr int kAFloats = BM * kLdA;
  static constexpr int kStage = kAFloats * 4 + kBK * kLdW;  // bytes
  static constexpr int kSmem = kStages * kStage;
  static_assert(kStage % 16 == 0, "stages must stay 16-byte aligned");
  static_assert(WN == 32 || WN == 64, "a thread reads 4 or 8 weight bytes");
};
using SmallM = Tile<16, 32>;
using LargeM = Tile<64, 64>;

// cvt.rna.tf32.f32 on the bit pattern: round the magnitude to 10
// mantissa bits, to nearest with ties away from zero
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

// four int8 weights (one 32-bit word, byte j = column j) as f32: the
// byte plus 128 under the exponent of 2^23, less 2^23 + 128 (exact)
__device__ __forceinline__ void upcast4(uint32_t word, float (&f)[4], Int8) {
  const uint32_t x = word ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __fsub_rn(__uint_as_float(__byte_perm(x, 0x4b000000u,
                                                  0x7540u + j)),
                     8388736.f);
}

// four float8-e4m3 weights as f32, two at a time through the packed
// cvt.rn.f16x2.e4m3x2 (every e4m3 value is exact in f16 and in f32)
__device__ __forceinline__ void upcast4(uint32_t word, float (&f)[4], Fp8) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const __half2_raw raw = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(word >> (16 * h)), __NV_E4M3);
    const float2 v = __half22float2(__half2(raw));
    f[2 * h] = v.x;
    f[2 * h + 1] = v.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
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

// copy the A tile (rows m0.., columns k0..) of one stage; zero past M, K
template <typename T>
__device__ __forceinline__ void load_a(float* As, const float* a, int m0,
                                       int k0, int M, int K, bool vec,
                                       unsigned tid) {
  constexpr int kThreads = T::kThreads, BM = T::kBM;
  static_assert(BM * kBK / 4 % kThreads == 0, "whole chunks a thread");
  if (vec) {  // BM rows x 16 chunks of 4 floats
    constexpr int kRow = kBK / 4;
#pragma unroll
    for (int i = 0; i < BM * kRow / kThreads; ++i) {
      const unsigned c = tid + i * kThreads;
      const int r = c / kRow, kq = c % kRow * 4;
      const int gm = m0 + r, gk = k0 + kq;
      const int n = gm < M ? clamp4(K - gk) : 0;
      cp_async16(As + r * kLdA + kq, n ? a + (size_t)gm * K + gk : a,
                 4 * n);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < BM * kBK / kThreads; ++i) {
      const unsigned e = tid + i * kThreads;
      const int r = e / kBK, kk = e % kBK;
      const int gm = m0 + r, gk = k0 + kk;
      const bool ok = gm < M && gk < K;
      cp_async4(As + r * kLdA + kk, ok ? a + (size_t)gm * K + gk : a,
                ok ? 4 : 0);
    }
  }
}

// copy the weight tile (rows k0.., columns n0..) of one stage, in bytes;
// zero past K and N
template <typename T>
__device__ __forceinline__ void load_w(uint8_t* Ws, const uint8_t* w,
                                       int k0, int n0, int K, int N,
                                       int mode, unsigned tid) {
  constexpr int kThreads = T::kThreads;
  static_assert(kBK * kBN / 16 % kThreads == 0, "whole chunks a thread");
  if (mode == kW16) {  // N % 16 == 0: a chunk is all in or all out
    constexpr int kRow = kBN / 16;
#pragma unroll
    for (int i = 0; i < kBK * kRow / kThreads; ++i) {
      const unsigned c = tid + i * kThreads;
      const int r = c / kRow, nq = c % kRow * 16;
      const int gk = k0 + r, gn = n0 + nq;
      const bool ok = gk < K && gn < N;
      cp_async16(Ws + r * kLdW + nq, ok ? w + (size_t)gk * N + gn : w,
                 ok ? 16 : 0);
    }
  } else if (mode == kW4) {  // N % 4 == 0
    constexpr int kRow = kBN / 4;
#pragma unroll 4
    for (int i = 0; i < kBK * kRow / kThreads; ++i) {
      const unsigned c = tid + i * kThreads;
      const int r = c / kRow, nq = c % kRow * 4;
      const int gk = k0 + r, gn = n0 + nq;
      const bool ok = gk < K && gn < N;
      cp_async4(Ws + r * kLdW + nq, ok ? w + (size_t)gk * N + gn : w,
                ok ? 4 : 0);
    }
  } else {  // rows not 4-byte aligned: byte loads, stored a word at a time
    constexpr int kRow = kBN / 4;
#pragma unroll 4
    for (int i = 0; i < kBK * kRow / kThreads; ++i) {
      const unsigned c = tid + i * kThreads;
      const int r = c / kRow, nq = c % kRow * 4;
      const int gk = k0 + r, gn = n0 + nq;
      uint32_t word = 0;
      if (gk < K) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N)
            word |= static_cast<uint32_t>(w[(size_t)gk * N + gn + j])
                    << (8 * j);
      }
      *reinterpret_cast<uint32_t*>(Ws + r * kLdW + nq) = word;
    }
  }
}

// out = (a @ w) * scales (one K range: gridDim.y == 1), or the partial
// of K range blockIdx.y into ws[blockIdx.y] (split-K)
template <typename Q, typename T>
__global__ void __launch_bounds__(T::kThreads)
quantized_matmul_kernel(const float* __restrict__ a,
                        const uint8_t* __restrict__ w,
                        const float* __restrict__ scales,
                        float* __restrict__ out, float* __restrict__ ws,
                        int M, int N, int K, int k_split, bool vec_a,
                        int w_mode) {
  constexpr int BM = T::kBM, kMI = T::kMI, kNI = T::kNI;
  extern __shared__ __align__(16) unsigned char smem[];

  const unsigned tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // the mma fragments' row (gid) and column (tig) within a warp tile
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp / T::kWarpsN) * T::kWM;
  const int wn = (warp % T::kWarpsN) * T::kWN;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / tiles_n) * BM;
  const int n0 = (blockIdx.x % tiles_n) * kBN;
  const int kbeg = blockIdx.y * k_split;
  const int kend = min(kbeg + k_split, K);
  const int nst = (kend - kbeg + kBK - 1) / kBK;

  // acc[mi][j][e]: fragment element e of mma tile (mi, j), at row
  // gid + 8 (e / 2) and column kNI (2 tig + e % 2) + j of the warp tile;
  // p: the same elements of the current stage's partial
  float acc[kMI][kNI][4], p[kMI][kNI][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) {
      unsigned char* st = smem + s * T::kStage;
      load_a<T>(reinterpret_cast<float*>(st), a, m0, kbeg + s * kBK, M, K,
                vec_a, tid);
      load_w<T>(st + T::kAFloats * 4, w, kbeg + s * kBK, n0, K, N, w_mode,
                tid);
    }
    cp_async_commit();
  }

  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {  // refill the buffer every thread finished with last iteration
      const int nx = s + kStages - 1;
      if (nx < nst) {
        unsigned char* st = smem + (nx % kStages) * T::kStage;
        load_a<T>(reinterpret_cast<float*>(st), a, m0, kbeg + nx * kBK, M,
                  K, vec_a, tid);
        load_w<T>(st + T::kAFloats * 4, w, kbeg + nx * kBK, n0, K, N,
                  w_mode, tid);
      }
      cp_async_commit();
    }
    const unsigned char* st = smem + (s % kStages) * T::kStage;
    const float* As = reinterpret_cast<const float*>(st);
    const uint8_t* Ws = st + T::kAFloats * 4 + wn + kNI * gid;
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int j = 0; j < kNI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ahi[kMI][4], alo[kMI][4], b[kNI][2];
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wm + i * 16 + gid + (e & 1) * 8;
          split_tf32(As[r * kLdA + kk + tig + (e >> 1) * 4], ahi[i][e],
                     alo[i][e]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows kk + tig and kk + tig + 4
        const uint8_t* row = Ws + (kk + tig + 4 * h) * kLdW;
        uint32_t words[kNI / 4];
        if constexpr (kNI == 8) {
          const uint2 v = *reinterpret_cast<const uint2*>(row);
          words[0] = v.x;
          words[1] = v.y;
        } else {
          words[0] = *reinterpret_cast<const uint32_t*>(row);
        }
#pragma unroll
        for (int q = 0; q < kNI / 4; ++q) {
          float f[4];
          upcast4(words[q], f, Q());
#pragma unroll
          for (int j = 0; j < 4; ++j) b[4 * q + j][h] = __float_as_uint(f[j]);
        }
      }
      // the small products first, in a pass of their own, so that no
      // mma waits on the one just before it
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNI; ++j) mma_tf32(p[i][j], alo[i], b[j]);
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNI; ++j) mma_tf32(p[i][j], ahi[i], b[j]);
    }
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int j = 0; j < kNI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = __fadd_rn(acc[i][j][e], p[i][j][e]);
  }
  cp_async_wait<0>();

  const bool split = gridDim.y > 1;
  float* dst = split ? ws + (size_t)blockIdx.y * M * N : out;
  constexpr int kCols = 2 * kNI;  // a thread's adjacent columns
  const int gn = n0 + wn + kCols * tig;
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm + i * 16 + gid + 8 * h;
      if (gm >= M) continue;
      float v[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        v[c] = acc[i][c % kNI][2 * h + c / kNI];
        if (!split && gn + c < N) v[c] = __fmul_rn(v[c], scales[gn + c]);
      }
      float* row = dst + (size_t)gm * N + gn;
      if (N % 4 == 0 && gn + kCols <= N) {
#pragma unroll
        for (int c = 0; c < kCols; c += 4)
          *reinterpret_cast<float4*>(row + c) =
              make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (gn + c < N) row[c] = v[c];
      }
    }
}

// out = (ws[0] + ws[1] + ... + ws[split - 1]) * scales, in that order
__global__ void __launch_bounds__(256)
quantized_fold_kernel(const float* __restrict__ ws,
                      const float* __restrict__ scales,
                      float* __restrict__ out, int N, long long mn,
                      int split) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < mn; i += (long long)gridDim.x * blockDim.x) {
    float acc = ws[i];
#pragma unroll 8
    for (int t = 1; t < split; ++t) acc = __fadd_rn(acc, ws[t * mn + i]);
    out[i] = __fmul_rn(acc, scales[i % N]);
  }
}

template <typename Q, typename T>
int launch(const float* a, const uint8_t* w, const float* scales,
           float* out, float* ws, int M, int N, int K, int split,
           int k_split, cudaStream_t s) {
  constexpr int BM = T::kBM;
  auto kernel = quantized_matmul_kernel<Q, T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return (int)err;
  const bool vec_a = K % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  const int w_mode = N % 16 == 0 && wa % 16 == 0 ? kW16
                     : N % 4 == 0 && wa % 4 == 0 ? kW4
                                                 : kW1;
  const long long tiles =
      (long long)((M + BM - 1) / BM) * ((N + kBN - 1) / kBN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)tiles, split), T::kThreads, T::kSmem, s>>>(
      a, w, scales, out, ws, M, N, K, split > 1 ? k_split : K, vec_a,
      w_mode);
  if (split > 1) {
    const long long mn = (long long)M * N;
    const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256
                                                       : 4096);
    quantized_fold_kernel<<<blocks, 256, 0, s>>>(ws, scales, out, N, mn,
                                                 split);
  }
  return (int)cudaGetLastError();
}

template <typename Q>
int launch_tile(const float* a, const uint8_t* w, const float* scales,
                float* out, float* ws, int M, int N, int K, int tile_m,
                int split, int k_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the plan must be vt_quantized_matmul_plan's kind: k_split whole
  // stages, split ranges covering K exactly, a workspace when split
  if (split < 1 || split > 65535 ||
      (split > 1 && (ws == nullptr || k_split < kBK || k_split % kBK ||
                     (K + k_split - 1) / k_split != split)))
    return (int)cudaErrorInvalidValue;
  if (tile_m == SmallM::kBM)
    return launch<Q, SmallM>(a, w, scales, out, ws, M, N, K, split, k_split,
                             s);
  if (tile_m == LargeM::kBM)
    return launch<Q, LargeM>(a, w, scales, out, ws, M, N, K, split, k_split,
                             s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// the tile and split of an [M, K] @ [K, N] call on a card of sm_count
// SMs: plan[0] the tile's rows (16 for M <= 16, else 64), plan[1] the
// number of K ranges (1: no split), plan[2] the K columns of a range.
// Split when the output grid has fewer CTAs than the card has SMs, into
// as many ranges as bring the grid to two CTAs an SM, each at least
// kMinSplitK deep and whole 64-deep stages, the workspace under 256 MB
int vt_quantized_matmul_plan(int M, int N, int K, int sm_count, int* plan) {
  if (M < 1 || N < 1 || K < 1 || sm_count < 1)
    return (int)cudaErrorInvalidValue;
  const int bm = M <= SmallM::kBM ? SmallM::kBM : LargeM::kBM;
  const long long tiles =
      (long long)((M + bm - 1) / bm) * ((N + kBN - 1) / kBN);
  int split = 1, k_split = K;
  if (tiles < sm_count) {
    const long long want = 2LL * sm_count / tiles;
    const long long ranges = want < K / kMinSplitK ? want : K / kMinSplitK;
    if (ranges >= 2) {
      const int deep = (int)((K + ranges - 1) / ranges);
      const int k = (deep + kBK - 1) / kBK * kBK;
      const int n = (K + k - 1) / k;
      if (n >= 2 && (long long)n * M * N <= (1LL << 26)) {
        split = n;
        k_split = k;
      }
    }
  }
  plan[0] = bm;
  plan[1] = split;
  plan[2] = k_split;
  return 0;
}

// out [M, N] row-major; a [M, K], w [K, N] row-major; ws holds
// split * M * N floats when split > 1 (the plan's tile_m, split, k_split)
int vt_quantized_matmul_int8(const float* a, const int8_t* w,
                             const float* scales, float* out, float* ws,
                             int M, int N, int K, int tile_m, int split,
                             int k_split, void* stream) {
  return launch_tile<Int8>(a, reinterpret_cast<const uint8_t*>(w), scales,
                           out, ws, M, N, K, tile_m, split, k_split, stream);
}

// w holds float8_e4m3fn bytes (torch.float8_e4m3fn storage)
int vt_quantized_matmul_fp8(const float* a, const uint8_t* w,
                            const float* scales, float* out, float* ws,
                            int M, int N, int K, int tile_m, int split,
                            int k_split, void* stream) {
  return launch_tile<Fp8>(a, w, scales, out, ws, M, N, K, tile_m, split,
                          k_split, stream);
}

const char* vt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
