// Cross-channel local response normalization (AlexNet LRN) for Hopper
// (sm_90a): the forward K5 and the analytic backward K6.
//
// Replaces the Pallas pair of veles_tpu/znicz/lrn.py: pallas_lrn (forward
// kernel :143, pallas_call :149) and _pallas_lrn_bwd (kernel :164,
// pallas_call :176).  Over rows of C channels (N = B * H * W rows of an
// NHWC activation), with c = alpha / n and the window W of offsets
// lo = -(n / 2) .. hi = n - 1 - n / 2 (asymmetric for even n):
//   K5: den = k + c * sum_W x^2,   y = x / den^beta
//   K6: inner = g * x * den^-(beta + 1)
//       dx = g * den^-beta - 2 beta c * x * sum_W' inner
// where W' is the transposed window (offsets -hi .. -lo), the VJP of an
// asymmetric window sum.  Sums run in the Pallas body's offset order,
// channels outside [0, C) count as zeros, every power is a full-precision
// powf, and products and sums use __fmul_rn / __fadd_rn, which nvcc never
// contracts into FMAs, so the kernels round where the plain versions do.
//
// What bounds it on the card: bytes.  K5 reads x and writes y (8 bytes an
// element), K6 reads x and g and writes dx (12 bytes); AlexNet's LRN
// layers are 37.2 M and 23.9 M elements a step at minibatch 128.  What the
// design does about it: the window runs along C only and the rows are
// dense, so a tile of R whole rows is one contiguous run of R * C floats.
// A CTA loads its tile into shared memory once (float4 loads where C % 4
// == 0 and x is 16-byte aligned, scalar ones elsewhere), then each thread
// computes its elements, reading the neighbouring channels of its window
// from shared memory, and writes coalesced.  K6 stages, besides x, the
// inner term and its own first term in shared memory (48 KB a CTA at the
// default tile), then sums inner over the transposed window.  Any C up to
// the shared memory a block can hold and any n work; each element reads
// its x (and g) from device memory once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// floats of one shared array of a tile (16 KB); a tile is the most whole
// rows that fit, and at least one row
constexpr int kTileElems = 4096;
constexpr int kMaxShared = 232448;  // bytes a block may opt in to
constexpr int kDefaultShared = 49152;

template <bool VEC>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int count) {
  if (VEC) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < count / 4; i += blockDim.x) d4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
  }
}

// k + c * sum of row[c0 + o]^2 over o = lo .. hi, ascending
__device__ __forceinline__ float lrn_den(const float* row, int c0, int C,
                                         int lo, int hi, float coef,
                                         float k) {
  float acc = 0.f;
  for (int o = lo; o <= hi; ++o) {
    const int j = c0 + o;
    if (j >= 0 && j < C) {
      const float v = row[j];
      acc = __fadd_rn(acc, __fmul_rn(v, v));
    }
  }
  return __fadd_rn(k, __fmul_rn(coef, acc));
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
               long long N, int C, int tile_rows, int lo, int hi,
               float coef, float k, float beta) {
  extern __shared__ __align__(16) float xs[];
  const long long row0 = (long long)blockIdx.x * tile_rows;
  const int rows = (int)min((long long)tile_rows, N - row0);
  const int count = rows * C;
  load_tile<VEC>(xs, x + row0 * C, count);
  __syncthreads();
  float* yt = y + row0 * C;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int c0 = i % C;
    const float den = lrn_den(xs + (i - c0), c0, C, lo, hi, coef, k);
    yt[i] = xs[i] / powf(den, beta);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
lrn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
               float* __restrict__ dx, long long N, int C, int tile_rows,
               int lo, int hi, float coef, float k, float e1, float e2,
               float coef2) {
  extern __shared__ __align__(16) float smem[];
  const int cap = tile_rows * C;
  float* xs = smem;                // x
  float* is = smem + cap;          // inner = g x den^e2
  float* ts = smem + 2 * cap;      // g den^e1, the first term
  const long long row0 = (long long)blockIdx.x * tile_rows;
  const int rows = (int)min((long long)tile_rows, N - row0);
  const int count = rows * C;
  load_tile<VEC>(xs, x + row0 * C, count);
  __syncthreads();
  const float* gt = g + row0 * C;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int c0 = i % C;
    const float den = lrn_den(xs + (i - c0), c0, C, lo, hi, coef, k);
    const float gv = gt[i];
    is[i] = __fmul_rn(__fmul_rn(gv, xs[i]), powf(den, e2));
    ts[i] = __fmul_rn(gv, powf(den, e1));
  }
  __syncthreads();
  float* dt = dx + row0 * C;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int c0 = i % C;
    const float* row = is + (i - c0);
    float acc = 0.f;
    for (int o = -lo; o >= -hi; --o) {   // the transposed window
      const int j = c0 + o;
      if (j >= 0 && j < C) acc = __fadd_rn(acc, row[j]);
    }
    dt[i] = __fsub_rn(ts[i], __fmul_rn(__fmul_rn(coef2, xs[i]), acc));
  }
}

// tile rows, shared bytes; -1 rows when a row does not fit
void plan(int C, int arrays, int* tile_rows, int* shared) {
  *tile_rows = kTileElems / C > 0 ? kTileElems / C : 1;
  const long long bytes = 4LL * arrays * *tile_rows * C;
  if (bytes > kMaxShared) *tile_rows = -1;
  *shared = (int)bytes;
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int shared) {
  if (shared <= kDefaultShared) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              shared);
}

bool aligned(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

extern "C" {

// y = LRN(x) over dense [N, C] rows; coef = alpha / n
int vt_lrn_fwd(const float* x, float* y, long long N, int C, int n,
               float coef, float k, float beta, void* stream) {
  int tile_rows, shared;
  plan(C, 1, &tile_rows, &shared);
  if (N <= 0 || C <= 0 || n <= 0 || tile_rows < 0)
    return (int)cudaErrorInvalidValue;
  const int lo = -(n / 2), hi = n - 1 - n / 2;
  const unsigned blocks = (unsigned)((N + tile_rows - 1) / tile_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (C % 4 == 0 && aligned(x)) {
    err = opt_in(lrn_fwd_kernel<true>, shared);
    if (err != cudaSuccess) return (int)err;
    lrn_fwd_kernel<true><<<blocks, kThreads, shared, s>>>(
        x, y, N, C, tile_rows, lo, hi, coef, k, beta);
  } else {
    err = opt_in(lrn_fwd_kernel<false>, shared);
    if (err != cudaSuccess) return (int)err;
    lrn_fwd_kernel<false><<<blocks, kThreads, shared, s>>>(
        x, y, N, C, tile_rows, lo, hi, coef, k, beta);
  }
  return (int)cudaGetLastError();
}

// dx of LRN at x for the output gradient g, dense [N, C] rows; coef =
// alpha / n, e1 = -beta, e2 = -beta - 1, coef2 = 2 beta alpha / n
int vt_lrn_bwd(const float* x, const float* g, float* dx, long long N,
               int C, int n, float coef, float k, float e1, float e2,
               float coef2, void* stream) {
  int tile_rows, shared;
  plan(C, 3, &tile_rows, &shared);
  if (N <= 0 || C <= 0 || n <= 0 || tile_rows < 0)
    return (int)cudaErrorInvalidValue;
  const int lo = -(n / 2), hi = n - 1 - n / 2;
  const unsigned blocks = (unsigned)((N + tile_rows - 1) / tile_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (C % 4 == 0 && aligned(x)) {
    err = opt_in(lrn_bwd_kernel<true>, shared);
    if (err != cudaSuccess) return (int)err;
    lrn_bwd_kernel<true><<<blocks, kThreads, shared, s>>>(
        x, g, dx, N, C, tile_rows, lo, hi, coef, k, e1, e2, coef2);
  } else {
    err = opt_in(lrn_bwd_kernel<false>, shared);
    if (err != cudaSuccess) return (int)err;
    lrn_bwd_kernel<false><<<blocks, kThreads, shared, s>>>(
        x, g, dx, N, C, tile_rows, lo, hi, coef, k, e1, e2, coef2);
  }
  return (int)cudaGetLastError();
}

const char* vt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
