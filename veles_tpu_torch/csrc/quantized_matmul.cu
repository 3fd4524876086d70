// Weight-quantized GEMM for Hopper (sm_90a): out = (a @ upcast(w_q)) * scales.
//
// Replaces the kernel of veles_tpu/znicz/gemm.py:quantized_matmul: f32
// activations a [M, K] times int8 or float8-e4m3 weights w_q [K, N] with
// one f32 scale per output channel, scales [N].  The scales are constant
// along K, so they multiply the finished output once after the K loop.
//
// What bounds it on the card: at decode shapes (M of 16 rows, K x N in
// the thousands) the weight bytes, read once at 3.35 TB/s; at larger M
// the f32 multiply-adds on the CUDA cores (67 TFLOP/s) — the products
// are exact f32 (no TF32, no tensor cores), matching the
// Precision.HIGHEST the TPU kernel asked for.
//
// What the design does about it: the weights cross HBM in their
// quantized width (1 byte an element) and are upcast to f32 in shared
// memory, tile by tile; the accumulator stays in registers for the whole
// K loop.  Ragged M, N and K are masked in the kernel, not padded in
// Python.  This first version is a plain shared-memory tiled SGEMM
// (64 x 64 output tile, 16-deep K step, 4 x 4 outputs a thread); no
// tensor cores, no TMA, no split-K for the small-M decode shapes yet.

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kTM = 4, kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

__device__ __forceinline__ float upcast(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float upcast(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
quantized_matmul_kernel(const float* __restrict__ a,
                        const W* __restrict__ w,
                        const float* __restrict__ scales,
                        float* __restrict__ out, int M, int N, int K) {
  // A tile stored k-major so the inner loop reads a column of it
  __shared__ float a_s[kBK][kBM + 4];
  __shared__ float w_s[kBK][kBN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i - r * kBK;
      const int gm = m0 + r, gk = k0 + c;
      a_s[c][r] = (gm < M && gk < K) ? a[(size_t)gm * K + gk] : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i - r * kBN;
      const int gk = k0 + r, gn = n0 + c;
      w_s[r][c] = (gk < K && gn < N) ? upcast(w[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float ar[kTM], wr[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) ar[i] = a_s[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) wr[j] = w_s[kk][tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(ar[i], wr[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: the per-output-channel scales, once, after the K loop
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty * kTM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx * kTN + j;
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j] * scales[gn];
    }
  }
}

template <typename W>
int launch(const float* a, const W* w, const float* scales, float* out,
           int M, int N, int K, void* stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  quantized_matmul_kernel<W>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          a, w, scales, out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int vt_quantized_matmul_int8(const float* a, const int8_t* w,
                             const float* scales, float* out, int M, int N,
                             int K, void* stream) {
  return launch<int8_t>(a, w, scales, out, M, N, K, stream);
}

// w holds float8_e4m3fn bytes (torch.float8_e4m3fn storage)
int vt_quantized_matmul_fp8(const float* a, const uint8_t* w,
                            const float* scales, float* out, int M, int N,
                            int K, void* stream) {
  return launch<__nv_fp8_e4m3>(
      a, reinterpret_cast<const __nv_fp8_e4m3*>(w), scales, out, M, N, K,
      stream);
}

const char* vt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
