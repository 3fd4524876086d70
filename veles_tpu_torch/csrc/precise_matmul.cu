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
// The products are exact f32 on the CUDA cores (no TF32, no tensor
// cores): the TPU kernel asked for Precision.HIGHEST.
//
// Operands come with their two strides, so the backward's transposed
// operands (g @ b^T, a^T @ g) are views and cost no copy.  Each tile
// load picks the thread mapping that walks the unit-stride axis, so
// loads stay coalesced in either layout.
//
// What bounds it on the card: 2MNK f32 multiply-adds at 67 TFLOP/s for
// the large shapes; at MNIST's shapes (M = 60 rows) it is a handful of
// CTAs and the launch itself.  What the design does about it: one CTA
// per 64 x 64 output tile, K staged through shared memory 32 columns at
// a time, 4 x 4 outputs a thread with the tile partial and the three
// accumulators in registers, ragged M, N and K masked in the kernel.
// No tensor cores, no TMA, no split-K yet.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64, kStage = 32, kTM = 4, kTN = 4;
constexpr int kBK = 256;  // the unit of compensated accumulation
constexpr int kTX = kBN / kTN, kTY = kBM / kTM;
constexpr int kThreads = kTX * kTY;  // 256
static_assert(kBK % kStage == 0, "a stage must not straddle two K tiles");

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  // Knuth's TwoSum: a + b == s + e exactly
  s = __fadd_rn(a, b);
  const float v = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, v)), __fsub_rn(b, v));
}

template <int LEVEL>
__global__ void __launch_bounds__(kThreads)
precise_matmul_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, float* __restrict__ out,
                      int M, int N, int K, long long sam, long long sak,
                      long long sbk, long long sbn) {
  // both tiles k-major: the inner loop reads one k row of each
  __shared__ float a_s[kStage][kBM + 4];
  __shared__ float b_s[kStage][kBN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[kTM][kTN], c1[kTM][kTN], c2[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = c1[i][j] = c2[i][j] = 0.f;

  for (int kt = 0; kt < K; kt += kBK) {
    float p[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) p[i][j] = 0.f;
    const int kend = min(kt + kBK, K);
    for (int k0 = kt; k0 < kend; k0 += kStage) {
      for (int i = tid; i < kBM * kStage; i += kThreads) {
        int r, c;  // r: row of the tile (m), c: column (k)
        if (sak == 1) { r = i / kStage; c = i - r * kStage; }
        else { c = i / kBM; r = i - c * kBM; }
        const int gm = m0 + r, gk = k0 + c;
        a_s[c][r] = (gm < M && gk < K) ? a[gm * sam + gk * sak] : 0.f;
      }
      for (int i = tid; i < kStage * kBN; i += kThreads) {
        int r, c;  // r: row of the tile (k), c: column (n)
        if (sbn == 1) { r = i / kBN; c = i - r * kBN; }
        else { c = i / kStage; r = i - c * kStage; }
        const int gk = k0 + r, gn = n0 + c;
        b_s[r][c] = (gk < K && gn < N) ? b[gk * sbk + gn * sbn] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kStage; ++kk) {
        float ar[kTM], br[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) ar[i] = a_s[kk][ty + i * kTY];
#pragma unroll
        for (int j = 0; j < kTN; ++j) br[j] = b_s[kk][tx + j * kTX];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) p[i][j] = fmaf(ar[i], br[j], p[i][j]);
      }
      __syncthreads();
    }
    // the K tile is done: compensate its partial into the running sum
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        if (LEVEL == 0) {
          acc[i][j] = __fadd_rn(acc[i][j], p[i][j]);
        } else {
          float s, e;
          two_sum(acc[i][j], p[i][j], s, e);
          acc[i][j] = s;
          if (LEVEL == 1) {
            c1[i][j] = __fadd_rn(c1[i][j], e);
          } else {
            float s1, e2;
            two_sum(c1[i][j], e, s1, e2);
            c1[i][j] = s1;
            c2[i][j] = __fadd_rn(c2[i][j], e2);
          }
        }
      }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + i * kTY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx + j * kTX;
      if (gn < N)
        out[(size_t)gm * N + gn] =
            __fadd_rn(acc[i][j], __fadd_rn(c1[i][j], c2[i][j]));
    }
  }
}

}  // namespace

extern "C" {

// out [M, N] row-major; a[m, k] at a[m * sam + k * sak], b[k, n] at
// b[k * sbk + n * sbn] (element strides)
int vt_precise_matmul(const float* a, const float* b, float* out, int M,
                      int N, int K, long long sam, long long sak,
                      long long sbk, long long sbn, int level,
                      void* stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (level) {
    case 0:
      precise_matmul_kernel<0><<<grid, kThreads, 0, s>>>(
          a, b, out, M, N, K, sam, sak, sbk, sbn);
      break;
    case 1:
      precise_matmul_kernel<1><<<grid, kThreads, 0, s>>>(
          a, b, out, M, N, K, sam, sak, sbk, sbn);
      break;
    case 2:
      precise_matmul_kernel<2><<<grid, kThreads, 0, s>>>(
          a, b, out, M, N, K, sam, sak, sbk, sbn);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* vt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
