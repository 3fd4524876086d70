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
// where W' is the transposed window (offsets -lo down to -hi), the VJP of
// an asymmetric window sum.  The kernels round where the plain versions
// (lrn_reference, lrn_backward_reference) do, so they give the same bits
// wherever torch.pow takes its general path: every window sum starts from
// its first offset's term and adds the rest in the plain version's order,
// channels outside [0, C) count as zeros (the plain version adds zero
// tensors there), every power is a full-precision powf, the quotient an
// IEEE divide, and products and sums use __fmul_rn / __fadd_rn, which
// nvcc never contracts into FMAs.
//
// What bounds it on the card: the powf that the bits require, then bytes.
// K5 moves 8 bytes an element (x in, y out) and K6 12 (x, g in, dx out),
// 0.089 / 0.133 ms at AlexNet's first LRN on an H100; powf costs tens of
// instructions, one an element in K5 (beside the divide) and two in K6,
// and on the card it is most of the time over the byte bound (a copy
// with powf knocked out ran within 13 % of the bound).  So the design
// spends nothing around it:
// - a thread owns four consecutive channels of one row (a float4; scalar
//   copies where C % 4 != 0 or a base is not 16-byte aligned) and finds
//   its row and channel once, from its thread index: a CTA's tile is
//   `rows` rows (blockIdx.x) by one chunk of `quads` quads (blockIdx.y),
//   so no element pays an integer % C;
// - each square is formed once, by its owner, into a shared row padded
//   with zero quads on both sides, so the window reads its neighbours'
//   squares as two float4s with no range test, and n (1-5 as template
//   parameters; any other n at run time) unrolls the window to n - 1
//   adds an element;
// - K6 runs two phases over one tile: phase 1 writes inner into a second
//   padded shared row and keeps its own first term g * den^-beta and x in
//   registers; after one barrier phase 2 sums inner over the transposed
//   window and writes dx as a float4;
// - loads go straight to registers, 16 bytes a thread, and a CTA's shared
//   rows are small (3.3 KB for K5, 6.7 KB for K6 at C = 96), so up to ten
//   CTAs an SM hide each other's loads behind their powf (a persistent
//   grid with a two-stage cp.async ring measured 13-34 % slower, one that
//   prefetched the next tile into registers at most 3 % faster in K5 at
//   AlexNet's shapes and no faster in K6: both hold more registers, so
//   fewer CTAs stay resident);
// - a tile need not hold whole rows: C > 1024 is cut into chunks of at
//   most 256 quads, and a chunk's pad quads then hold its neighbours'
//   squares (and, in K6, their inner terms, computed again by the CTA),
//   so any C works; with whole rows (C <= 1024) the pads stay zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // the most threads of a CTA
constexpr int kMaxShared = 232448;  // bytes a block may opt in to
constexpr int kDefaultShared = 49152;

// A tile is `rows` rows by `quads` quads of one chunk of each row; thread t
// owns quad t % quads of the tile's row t / quads.  A shared row holds the
// chunk's quads between `halo` pad quads on either side.
struct Plan {
  long long N;     // rows of the array
  int C;           // channels a row
  int rows;        // rows a tile
  int quads;       // quads of a chunk, one a thread
  int chunks;      // chunks of a row (gridDim.y)
  int halo;        // pad quads each side of a shared row
  int stride;      // floats of a shared row: 4 * (quads + 2 * halo)
  int lo, hi;      // the window's offsets
};

// The quad a thread owns in its CTA's tile.
struct Slot {
  long long off;   // element offset of its first channel
  int pos;         // shared index of its first channel
  int live;        // its channels inside the array, 0-4
};

__device__ __forceinline__ Slot slot(const Plan& p, int r, int qi) {
  const long long row = (long long)blockIdx.x * p.rows + r;
  const int c = (blockIdx.y * p.quads + qi) * 4;
  Slot s;
  s.off = row * p.C + c;
  s.pos = r * p.stride + 4 * (p.halo + qi);
  s.live = (r < p.rows && row < p.N && c < p.C) ? min(4, p.C - c) : 0;
  return s;
}

template <bool VEC>
__device__ __forceinline__ void load4(const float* __restrict__ a,
                                      const Slot& s, float v[4]) {
  if (VEC) {
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s.live) t = *reinterpret_cast<const float4*>(a + s.off);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = j < s.live ? a[s.off + j] : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ a, const Slot& s,
                                       const float v[4]) {
  if (VEC) {
    *reinterpret_cast<float4*>(a + s.off) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < s.live) a[s.off + j] = v[j];
  }
}

__device__ __forceinline__ void put4(float* s, int pos, const float v[4]) {
  *reinterpret_cast<float4*>(s + pos) = make_float4(v[0], v[1], v[2], v[3]);
}

// acc[j] = the window sum of channel j of the quad at s[pos .. pos + 3]:
// the terms at offsets first, first + step, ..., last, first term first
// (the window: lo up to hi; transposed: -lo down to -hi).  `mid` holds
// s[pos .. pos + 3] already; with n a template parameter the neighbours
// come as two float4s and the sum unrolls.
template <int NW, bool TRANSPOSED>
__device__ __forceinline__ void window4(const float* s, int pos,
                                        const float mid[4], int lo, int hi,
                                        float acc[4]) {
  if constexpr (NW > 0) {
    static_assert(NW <= 9, "the window reaches one quad each side");
    constexpr int LO = -(NW / 2), HI = NW - 1 - NW / 2;
    constexpr int FIRST = TRANSPOSED ? -LO : LO;
    constexpr int LAST = TRANSPOSED ? -HI : HI;
    constexpr int STEP = TRANSPOSED ? -1 : 1;
    float w[12];
    if constexpr (LO < 0 || HI > 0) {
      // the transposed window spans -HI .. -LO: one side each way too
      const float4 a = *reinterpret_cast<const float4*>(s + pos - 4);
      const float4 b = *reinterpret_cast<const float4*>(s + pos + 4);
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
      w[8] = b.x; w[9] = b.y; w[10] = b.z; w[11] = b.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) w[4 + j] = mid[j];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float a = w[4 + j + FIRST];
#pragma unroll
      for (int o = FIRST + STEP; o != LAST + STEP; o += STEP)
        a = __fadd_rn(a, w[4 + j + o]);
      acc[j] = a;
    }
  } else {
    const int first = TRANSPOSED ? -lo : lo, last = TRANSPOSED ? -hi : hi;
    const int step = TRANSPOSED ? -1 : 1;
    for (int j = 0; j < 4; ++j) {
      float a = s[pos + j + first];
      for (int o = first + step; o != last + step; o += step)
        a = __fadd_rn(a, s[pos + j + o]);
      acc[j] = a;
    }
  }
}

__device__ __forceinline__ float lrn_den(float acc, float coef, float k) {
  return __fadd_rn(k, __fmul_rn(coef, acc));
}

// Whole rows: zero the pad quads of `count` shared buffers of p.rows rows
// each.  No thread writes a pad otherwise, and the first barrier orders
// these stores before any read.
__device__ __forceinline__ void zero_pads(float* s, int count,
                                          const Plan& p) {
  const int pad = 8 * p.halo;
  for (int i = threadIdx.x; i < count * p.rows * pad; i += blockDim.x) {
    const int row = i / pad, f = i - row * pad;
    s[row * p.stride + (f < 4 * p.halo ? f : 4 * p.quads + f)] = 0.f;
  }
}

// Pad quad h (0 .. 2 halo - 1: the left ones, then the right) of a chunk's
// shared row: its quad index relative to the chunk's first quad.
__device__ __forceinline__ int pad_quad(const Plan& p, int halo, int h) {
  return h < halo ? h - halo : p.quads + h - halo;
}

// Split rows (C > 1024): the squares of the chunk's neighbouring channels
// in its pad quads, zeros outside the row.
__device__ void fill_square_pads(float* sq, const float* __restrict__ x,
                                 const Plan& p) {
  const int per_row = 2 * p.halo;
  for (int i = threadIdx.x; i < p.rows * per_row; i += blockDim.x) {
    const int hr = i / per_row;
    const int q = pad_quad(p, p.halo, i - hr * per_row);
    const int c = (blockIdx.y * p.quads + q) * 4;
    const long long row = (long long)blockIdx.x * p.rows + hr;
    float* d = sq + hr * p.stride + 4 * (p.halo + q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cj = c + j;
      const float v = (row < p.N && cj >= 0 && cj < p.C) ? x[row * p.C + cj]
                                                         : 0.f;
      d[j] = __fmul_rn(v, v);
    }
  }
}

// Split rows in K6: the inner terms of the chunk's e pad quads each side,
// from the squares (whose pads reach 2 e quads), zeros outside the row.
template <int NW>
__device__ void fill_inner_pads(float* in, const float* sq,
                                const float* __restrict__ x,
                                const float* __restrict__ g, const Plan& p,
                                float coef, float k, float e2) {
  const int e = p.halo / 2, per_row = 2 * e;
  for (int i = threadIdx.x; i < p.rows * per_row; i += blockDim.x) {
    const int hr = i / per_row;
    const int q = pad_quad(p, e, i - hr * per_row);
    const int c = (blockIdx.y * p.quads + q) * 4;
    const long long row = (long long)blockIdx.x * p.rows + hr;
    const int pos = hr * p.stride + 4 * (p.halo + q);
    float mid[4], acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) mid[j] = sq[pos + j];
    window4<NW, false>(sq, pos, mid, p.lo, p.hi, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cj = c + j;
      float v = 0.f;
      if (row < p.N && cj >= 0 && cj < p.C) {
        const long long o = row * p.C + cj;
        v = __fmul_rn(__fmul_rn(g[o], x[o]),
                      powf(lrn_den(acc[j], coef, k), e2));
      }
      in[pos + j] = v;
    }
  }
}

template <int NW, bool VEC>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
               const Plan p, float coef, float k, float beta) {
  extern __shared__ float4 smem4[];
  float* const sq = reinterpret_cast<float*>(smem4);   // x^2
  const int r = threadIdx.x / p.quads, qi = threadIdx.x - r * p.quads;
  const Slot s = slot(p, r, qi);
  float v[4], s4[4];
  load4<VEC>(x, s, v);
#pragma unroll
  for (int j = 0; j < 4; ++j) s4[j] = __fmul_rn(v[j], v[j]);
  if (r < p.rows) put4(sq, s.pos, s4);
  if (p.chunks > 1)
    fill_square_pads(sq, x, p);
  else
    zero_pads(sq, 1, p);
  __syncthreads();
  if (!s.live) return;
  float acc[4], out[4];
  window4<NW, false>(sq, s.pos, s4, p.lo, p.hi, acc);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[j] = __fdiv_rn(v[j], powf(lrn_den(acc[j], coef, k), beta));
  store4<VEC>(y, s, out);
}

template <int NW, bool VEC>
__global__ void __launch_bounds__(kThreads)
lrn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
               float* __restrict__ dx, const Plan p, float coef, float k,
               float e1, float e2, float coef2) {
  extern __shared__ float4 smem4[];
  float* const sq = reinterpret_cast<float*>(smem4);   // x^2
  float* const in = sq + p.rows * p.stride;            // g x den^e2
  const int r = threadIdx.x / p.quads, qi = threadIdx.x - r * p.quads;
  const Slot s = slot(p, r, qi);
  // the pads before the loads: 2-6 % less time than after them at
  // AlexNet's shapes (ptxas's schedule)
  if (p.chunks > 1)
    fill_square_pads(sq, x, p);
  else
    zero_pads(sq, 2, p);
  float v[4], gv[4], s4[4];
  load4<VEC>(x, s, v);
  load4<VEC>(g, s, gv);
#pragma unroll
  for (int j = 0; j < 4; ++j) s4[j] = __fmul_rn(v[j], v[j]);
  if (r < p.rows) put4(sq, s.pos, s4);
  __syncthreads();
  // phase 1: the first term stays in registers, inner goes to shared
  float t[4], i4[4] = {0.f, 0.f, 0.f, 0.f};
  if (s.live) {
    float acc[4];
    window4<NW, false>(sq, s.pos, s4, p.lo, p.hi, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float den = lrn_den(acc[j], coef, k);
      t[j] = __fmul_rn(gv[j], powf(den, e1));
      if (j < s.live)
        i4[j] = __fmul_rn(__fmul_rn(gv[j], v[j]), powf(den, e2));
    }
  }
  if (r < p.rows) put4(in, s.pos, i4);
  if (p.chunks > 1) fill_inner_pads<NW>(in, sq, x, g, p, coef, k, e2);
  __syncthreads();
  // phase 2: the transposed window of inner
  if (!s.live) return;
  float acc[4], out[4];
  window4<NW, true>(in, s.pos, i4, p.lo, p.hi, acc);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[j] = __fsub_rn(t[j], __fmul_rn(__fmul_rn(coef2, v[j]), acc[j]));
  store4<VEC>(dx, s, out);
}

int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

// The plan of an [N, C] array for window n (K6: `bwd`), its grid, block
// threads and shared bytes; cudaErrorInvalidValue for what no plan takes.
cudaError_t plan(long long N, int C, int n, bool bwd, Plan* p, dim3* grid,
                 int* threads, int* shared) {
  if (N <= 0 || C <= 0 || n <= 0) return cudaErrorInvalidValue;
  const int Q = (C + 3) / 4;
  p->N = N;
  p->C = C;
  p->chunks = (Q + kThreads - 1) / kThreads;
  p->quads = (Q + p->chunks - 1) / p->chunks;
  // as many rows as fill kThreads threads, cut to whole warps where a
  // row count does that
  int rows = kThreads / p->quads;
  const int unit = 32 / gcd(p->quads, 32);
  if (rows >= unit) rows -= rows % unit;
  if (rows > N) rows = (int)N;
  p->rows = rows;
  p->lo = -(n / 2);
  p->hi = n - 1 - n / 2;
  const int e = ((p->hi > -p->lo ? p->hi : -p->lo) + 3) / 4;
  p->halo = bwd && p->chunks > 1 ? 2 * e : e;
  p->stride = 4 * (p->quads + 2 * p->halo);
  *threads = (rows * p->quads + 31) / 32 * 32;
  const long long bytes = 4LL * (bwd ? 2 : 1) * rows * p->stride;
  const long long tiles = (N + rows - 1) / rows;
  if (bytes > kMaxShared || p->chunks > 65535 || tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  *shared = (int)bytes;
  *grid = dim3((unsigned)tiles, (unsigned)p->chunks);
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int shared) {
  if (shared <= kDefaultShared) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              shared);
}

bool aligned(const void* p) { return (uintptr_t)p % 16 == 0; }

template <int NW, bool VEC>
cudaError_t launch_fwd(const float* x, float* y, const Plan& p, dim3 grid,
                       int threads, int shared, float coef, float k,
                       float beta, cudaStream_t s) {
  const cudaError_t err = opt_in(lrn_fwd_kernel<NW, VEC>, shared);
  if (err != cudaSuccess) return err;
  lrn_fwd_kernel<NW, VEC><<<grid, threads, shared, s>>>(x, y, p, coef, k,
                                                        beta);
  return cudaGetLastError();
}

template <int NW, bool VEC>
cudaError_t launch_bwd(const float* x, const float* g, float* dx,
                       const Plan& p, dim3 grid, int threads, int shared,
                       float coef, float k, float e1, float e2, float coef2,
                       cudaStream_t s) {
  const cudaError_t err = opt_in(lrn_bwd_kernel<NW, VEC>, shared);
  if (err != cudaSuccess) return err;
  lrn_bwd_kernel<NW, VEC><<<grid, threads, shared, s>>>(
      x, g, dx, p, coef, k, e1, e2, coef2);
  return cudaGetLastError();
}

// fn<NW, VEC>(args...) for window n: 1-5 unrolled, any other at run time
#define VT_LRN_DISPATCH(fn, n, vec, ...)                                   \
  switch ((n) * 2 + ((vec) ? 1 : 0)) {                                     \
    case 2: return fn<1, false>(__VA_ARGS__);                              \
    case 3: return fn<1, true>(__VA_ARGS__);                               \
    case 4: return fn<2, false>(__VA_ARGS__);                              \
    case 5: return fn<2, true>(__VA_ARGS__);                               \
    case 6: return fn<3, false>(__VA_ARGS__);                              \
    case 7: return fn<3, true>(__VA_ARGS__);                               \
    case 8: return fn<4, false>(__VA_ARGS__);                              \
    case 9: return fn<4, true>(__VA_ARGS__);                               \
    case 10: return fn<5, false>(__VA_ARGS__);                             \
    case 11: return fn<5, true>(__VA_ARGS__);                              \
    default:                                                               \
      return (vec) ? fn<0, true>(__VA_ARGS__) : fn<0, false>(__VA_ARGS__); \
  }

cudaError_t fwd(const float* x, float* y, long long N, int C, int n,
                float coef, float k, float beta, cudaStream_t s) {
  Plan p;
  dim3 grid;
  int threads, shared;
  const cudaError_t err = plan(N, C, n, false, &p, &grid, &threads, &shared);
  if (err != cudaSuccess) return err;
  const bool vec = C % 4 == 0 && aligned(x) && aligned(y);
  VT_LRN_DISPATCH(launch_fwd, n, vec, x, y, p, grid, threads, shared, coef,
                  k, beta, s)
}

cudaError_t bwd(const float* x, const float* g, float* dx, long long N,
                int C, int n, float coef, float k, float e1, float e2,
                float coef2, cudaStream_t s) {
  Plan p;
  dim3 grid;
  int threads, shared;
  const cudaError_t err = plan(N, C, n, true, &p, &grid, &threads, &shared);
  if (err != cudaSuccess) return err;
  const bool vec = C % 4 == 0 && aligned(x) && aligned(g) && aligned(dx);
  VT_LRN_DISPATCH(launch_bwd, n, vec, x, g, dx, p, grid, threads, shared,
                  coef, k, e1, e2, coef2, s)
}

}  // namespace

extern "C" {

// y = LRN(x) over dense [N, C] rows; coef = alpha / n
int vt_lrn_fwd(const float* x, float* y, long long N, int C, int n,
               float coef, float k, float beta, void* stream) {
  return (int)fwd(x, y, N, C, n, coef, k, beta,
                  static_cast<cudaStream_t>(stream));
}

// dx of LRN at x for the output gradient g, dense [N, C] rows; coef =
// alpha / n, e1 = -beta, e2 = -beta - 1, coef2 = 2 beta alpha / n
int vt_lrn_bwd(const float* x, const float* g, float* dx, long long N,
               int C, int n, float coef, float k, float e1, float e2,
               float coef2, void* stream) {
  return (int)bwd(x, g, dx, N, C, n, coef, k, e1, e2, coef2,
                  static_cast<cudaStream_t>(stream));
}

const char* vt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
