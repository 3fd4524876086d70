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
// What bounds them on the card: the f32 multiply-adds (4 T^2 D a head
// forward, 6 T^2 D for dq, 8 T^2 D for dk/dv, halved by a causal mask) at
// 67 TFLOP/s on the CUDA cores; the bytes are O(T D).  What the design
// does about it: one CTA of 256 threads per (batch * head, tile of 64
// rows); each thread owns a 4 x 4 block of the 64 x 64 score tile and a
// 4 x (DMAX / 16) block of the output tile, both in registers.  The
// operand tiles of the score products are staged d-major in shared memory
// so each step of the contraction is two float4 loads for 16 FMAs; the
// probability tile goes back through shared memory for the second
// product.  The online-softmax state (m, l) of a row lives in registers,
// replicated over the 16 threads that share the row (a half warp, reduced
// with shuffles).  No tensor cores (TF32 stays off), no TMA, no wgmma.
//
// The backward owns its outputs per CTA (dq by Q tiles, dk/dv by K
// tiles), walks its tiles in a fixed order and uses no atomics: two runs
// give the same bits.  expf / logf are the full-precision ones.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kB = 64;          // rows of a Q tile, and of a K tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kLd = kB + 4;     // row length of a d-major tile (float4 aligned)
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

// N consecutive floats from shared memory (16- or 8-byte aligned)
template <int N>
__device__ __forceinline__ void ld(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// Rows t0 .. t0 + 63 of one (b, h) slice into shared memory, times mul;
// zeros past T and past D.  dt (d-major, [DMAX][kLd]) and/or dr
// (row-major, [kB][DMAX]) may be null.  Consecutive threads read
// consecutive d: the global loads coalesce.
template <int DMAX>
__device__ __forceinline__ void load_tile(float* dt, float* dr,
                                          const float* base, long long st,
                                          int t0, int T, int D, float mul) {
  for (int i = threadIdx.x; i < kB * DMAX; i += kThreads) {
    const int r = i / DMAX, d = i % DMAX;
    const int t = t0 + r;
    const float x =
        (t < T && d < D) ? base[(long long)t * st + d] * mul : 0.f;
    if (dt) dt[d * kLd + r] = x;
    if (dr) dr[r * DMAX + d] = x;
  }
}

// s[i][j] = sum_d a[d][ty * 4 + i] * b[d][tx * 4 + j] over d-major tiles
template <int DMAX>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ty, int tx, float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int kk = 0; kk < DMAX; ++kk) {
    float av[4], bv[4];
    ld<4>(a + kk * kLd + ty * 4, av);
    ld<4>(b + kk * kLd + tx * 4, bv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][j] += sum_c w[c][ty * 4 + i] * x[c][tx * NDT + j]: w is a
// [kB][kLd] tile indexed (c, row), x a row-major [kB][DMAX] tile
template <int DMAX>
__device__ __forceinline__ void tile_acc(const float* w, const float* x,
                                         int ty, int tx,
                                         float (&acc)[4][DMAX / 16]) {
  constexpr int NDT = DMAX / 16;
#pragma unroll 4
  for (int c = 0; c < kB; ++c) {
    float wv[4], xv[NDT];
    ld<4>(w + c * kLd + ty * 4, wv);
    ld<NDT>(x + c * DMAX + tx * NDT, xv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NDT; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
  }
}

// write v[i][j] (row ty * 4 + i, column tx * 4 + j of a 64 x 64 tile) to
// w[column][row], four rows a float4
__device__ __forceinline__ void store_t(float* w, const float (&v)[4][4],
                                        int ty, int tx) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(w + (tx * 4 + j) * kLd + ty * 4) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
}

// is key column c hidden from query row r?
__device__ __forceinline__ bool masked(int r, int c, int T, int causal,
                                       int window) {
  if (c >= T || r >= T) return true;
  if (!causal) return false;
  return c > r || (window > 0 && c <= r - window);
}

// reductions over the 16 threads that share a row (a half warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the K tiles Q tile iq sees: [lo, hi]
__device__ __forceinline__ void k_range(int iq, int nk, int causal,
                                        int window, int& lo, int& hi) {
  lo = 0;
  hi = nk - 1;
  if (!causal) return;
  hi = min(hi, iq);  // the last key a Q tile sees is its last row
  if (window > 0) {
    const int first = iq * kB - window + 1;
    lo = first > 0 ? first / kB : 0;
  }
}

// the Q tiles that see K tile jk: [lo, hi], the band capped at the last
// Q tile (as _dkv_kernel caps it)
__device__ __forceinline__ void q_range(int jk, int nq, int causal,
                                        int window, int& lo, int& hi) {
  lo = 0;
  hi = nq - 1;
  if (!causal) return;
  lo = jk;  // queries at or after the tile's first key
  if (window > 0) {
    const long long last = (long long)jk * kB + kB - 1 + window - 1;
    hi = (int)min((long long)hi, last / kB);
  }
}

// the heaviest tiles (causal: the last) are scheduled first
__device__ __forceinline__ void tile_of_block(int ntiles, int& bh,
                                              int& tile) {
  bh = blockIdx.x / ntiles;
  tile = ntiles - 1 - (int)(blockIdx.x % ntiles);
}

template <int DMAX>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * DMAX * kLd + kB * DMAX + kB * kLd);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(View q, View k, View v, float* __restrict__ out,
                 float* __restrict__ lse, int T, int H, int D, float scale,
                 int causal, int window) {
  constexpr int NDT = DMAX / 16;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [DMAX][kLd], q * scale
  float* kt = qt + DMAX * kLd;                  // [DMAX][kLd]
  float* vs = kt + DMAX * kLd;                  // [kB][DMAX]
  float* pt = vs + kB * DMAX;                   // [kB][kLd]: p, (key, row)

  const int ntiles = (T + kB - 1) / kB;
  int bh, iq;
  tile_of_block(ntiles, bh, iq);
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = iq * kB;

  load_tile<DMAX>(qt, nullptr, row_base(q, b, h), q.st, q0, T, D, scale);
  float m[4], l[4], acc[4][NDT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NDT; ++j) acc[i][j] = 0.f;
  }
  int lo, hi;
  k_range(iq, ntiles, causal, window, lo, hi);
  for (int jk = lo; jk <= hi; ++jk) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<DMAX>(kt, nullptr, row_base(k, b, h), k.st, jk * kB, T, D,
                    1.f);
    load_tile<DMAX>(nullptr, vs, row_base(v, b, h), v.st, jk * kB, T, D,
                    1.f);
    __syncthreads();
    float s[4][4];
    tile_dot<DMAX>(qt, kt, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (masked(r, jk * kB + tx * 4 + j, T, causal, window))
          s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float new_m = fmaxf(m[i], row_max(mx));
      // a row with every key so far masked keeps m at -inf:
      // exp(-inf - -inf) must be 0, not nan (flash_attention.py:173-177)
      const float safe_m = new_m == kNegInf ? 0.f : new_m;
      const float alpha = m[i] == kNegInf ? 0.f : expf(m[i] - safe_m);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] == kNegInf ? 0.f : expf(s[i][j] - safe_m);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = new_m;
#pragma unroll
      for (int j = 0; j < NDT; ++j) acc[i][j] *= alpha;
    }
    store_t(pt, s, ty, tx);
    __syncthreads();
    tile_acc<DMAX>(pt, vs, ty, tx, acc);
  }
  float* o = out + ((long long)b * T * H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= T) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      const int d = tx * NDT + j;
      if (d < D) o[(long long)r * H * D + d] = acc[i][j] / safe_l;
    }
    if (tx == 0)
      lse[(long long)bh * T + r] =
          (m[i] == kNegInf ? 0.f : m[i]) + logf(safe_l);
  }
}

template <int DMAX>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * DMAX * kLd + kB * DMAX + kB * kLd);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(View q, View k, View v, View dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                int T, int H, int D, float scale, int causal, int window) {
  constexpr int NDT = DMAX / 16;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [DMAX][kLd]
  float* dot = qt + DMAX * kLd;                 // [DMAX][kLd], dO
  float* kt = dot + DMAX * kLd;                 // [DMAX][kLd]
  float* vt = kt + DMAX * kLd;                  // [DMAX][kLd]
  float* ks = vt + DMAX * kLd;                  // [kB][DMAX]
  float* dst = ks + kB * DMAX;                  // [kB][kLd]: ds, (key, row)

  const int ntiles = (T + kB - 1) / kB;
  int bh, iq;
  tile_of_block(ntiles, bh, iq);
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = iq * kB;

  load_tile<DMAX>(qt, nullptr, row_base(q, b, h), q.st, q0, T, D, 1.f);
  load_tile<DMAX>(dot, nullptr, row_base(dout, b, h), dout.st, q0, T, D,
                  1.f);
  float lse_r[4], delta_r[4], acc[4][NDT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    lse_r[i] = r < T ? lse[(long long)bh * T + r] : 0.f;
    delta_r[i] = r < T ? delta[(long long)bh * T + r] : 0.f;
#pragma unroll
    for (int j = 0; j < NDT; ++j) acc[i][j] = 0.f;
  }
  int lo, hi;
  k_range(iq, ntiles, causal, window, lo, hi);
  for (int jk = lo; jk <= hi; ++jk) {
    __syncthreads();
    load_tile<DMAX>(kt, ks, row_base(k, b, h), k.st, jk * kB, T, D, 1.f);
    load_tile<DMAX>(vt, nullptr, row_base(v, b, h), v.st, jk * kB, T, D,
                    1.f);
    __syncthreads();
    float s[4][4], dov[4][4];
    tile_dot<DMAX>(qt, kt, ty, tx, s);
    tile_dot<DMAX>(dot, vt, ty, tx, dov);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = masked(r, jk * kB + tx * 4 + j, T, causal, window)
                            ? 0.f
                            : expf(s[i][j] * scale - lse_r[i]);
        s[i][j] = p * (dov[i][j] - delta_r[i]);  // ds
      }
    }
    store_t(dst, s, ty, tx);
    __syncthreads();
    tile_acc<DMAX>(dst, ks, ty, tx, acc);
  }
  float* o = dq + ((long long)b * T * H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= T) continue;
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      const int d = tx * NDT + j;
      if (d < D) o[(long long)r * H * D + d] = acc[i][j] * scale;
    }
  }
}

template <int DMAX>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         (4 * DMAX * kLd + 2 * kB * DMAX + kB * kLd + 2 * kB);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(View q, View k, View v, View dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int T, int H, int D, float scale,
                 int causal, int window) {
  constexpr int NDT = DMAX / 16;
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);  // [DMAX][kLd]
  float* vt = kt + DMAX * kLd;                  // [DMAX][kLd]
  float* qt = vt + DMAX * kLd;                  // [DMAX][kLd]
  float* dot = qt + DMAX * kLd;                 // [DMAX][kLd], dO
  float* qs = dot + DMAX * kLd;                 // [kB][DMAX]
  float* dos = qs + kB * DMAX;                  // [kB][DMAX], dO
  float* wt = dos + kB * DMAX;   // [kB][kLd]: p, then ds, (row, key)
  float* lse_s = wt + kB * kLd;  // [kB]
  float* delta_s = lse_s + kB;   // [kB]

  const int ntiles = (T + kB - 1) / kB;
  int bh, jk;
  tile_of_block(ntiles, bh, jk);
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int c0 = jk * kB;

  // this thread: keys c0 + ty * 4 + i, and (in the score tile) query rows
  // tx * 4 + j of the current Q tile
  load_tile<DMAX>(kt, nullptr, row_base(k, b, h), k.st, c0, T, D, 1.f);
  load_tile<DMAX>(vt, nullptr, row_base(v, b, h), v.st, c0, T, D, 1.f);
  float dk_acc[4][NDT], dv_acc[4][NDT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NDT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  int lo, hi;
  q_range(jk, ntiles, causal, window, lo, hi);
  for (int iq = lo; iq <= hi; ++iq) {
    const int q0 = iq * kB;
    __syncthreads();
    load_tile<DMAX>(qt, qs, row_base(q, b, h), q.st, q0, T, D, 1.f);
    load_tile<DMAX>(dot, dos, row_base(dout, b, h), dout.st, q0, T, D,
                    1.f);
    if (tid < kB) {
      const int r = q0 + tid;
      lse_s[tid] = r < T ? lse[(long long)bh * T + r] : 0.f;
      delta_s[tid] = r < T ? delta[(long long)bh * T + r] : 0.f;
    }
    __syncthreads();
    float p[4][4], ds[4][4];
    tile_dot<DMAX>(kt, qt, ty, tx, p);    // (q k^T)^T
    tile_dot<DMAX>(vt, dot, ty, tx, ds);  // (dO v^T)^T
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rl = tx * 4 + j;
      const float lse_j = lse_s[rl], delta_j = delta_s[rl];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i][j] = masked(q0 + rl, c0 + ty * 4 + i, T, causal, window)
                      ? 0.f
                      : expf(p[i][j] * scale - lse_j);
        ds[i][j] = p[i][j] * (ds[i][j] - delta_j);
      }
    }
    store_t(wt, p, ty, tx);
    __syncthreads();
    tile_acc<DMAX>(wt, dos, ty, tx, dv_acc);  // dv += p^T dO
    __syncthreads();
    store_t(wt, ds, ty, tx);
    __syncthreads();
    tile_acc<DMAX>(wt, qs, ty, tx, dk_acc);   // dk += ds^T q
  }
  const long long off = ((long long)b * T * H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= T) continue;
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      const int d = tx * NDT + j;
      if (d < D) {
        dk[off + (long long)c * H * D + d] = dk_acc[i][j] * scale;
        dv[off + (long long)c * H * D + d] = dv_acc[i][j];
      }
    }
  }
}

// opt a kernel into its dynamic shared memory (past the default 48 KB)
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DMAX>
cudaError_t fwd(View q, View k, View v, float* out, float* lse, int B,
                int T, int H, int D, float scale, int causal, int window,
                cudaStream_t s) {
  constexpr size_t smem = fwd_smem<DMAX>();
  const cudaError_t e = allow_smem(flash_fwd_kernel<DMAX>, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)B * H * ((T + kB - 1) / kB);
  flash_fwd_kernel<DMAX><<<(unsigned)blocks, kThreads, smem, s>>>(
      q, k, v, out, lse, T, H, D, scale, causal, window);
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
  const long long blocks = (long long)B * H * ((T + kB - 1) / kB);
  flash_dq_kernel<DMAX><<<(unsigned)blocks, kThreads, smem, s>>>(
      q, k, v, dout, lse, delta, dq, T, H, D, scale, causal, window);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t bwd_dkv(View q, View k, View v, View dout, const float* lse,
                    const float* delta, float* dk, float* dv, int B, int T,
                    int H, int D, float scale, int causal, int window,
                    cudaStream_t s) {
  constexpr size_t smem = dkv_smem<DMAX>();
  const cudaError_t e = allow_smem(flash_dkv_kernel<DMAX>, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)B * H * ((T + kB - 1) / kB);
  flash_dkv_kernel<DMAX><<<(unsigned)blocks, kThreads, smem, s>>>(
      q, k, v, dout, lse, delta, dk, dv, T, H, D, scale, causal, window);
  return cudaGetLastError();
}

// the instantiation for a head dim D: the smallest of 32, 64, 128 >= D
template <typename F>
int dispatch(int B, int T, int D, F&& launch) {
  if (D < 1 || D > 128 || B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  if (D <= 32) return (int)launch(std::integral_constant<int, 32>());
  if (D <= 64) return (int)launch(std::integral_constant<int, 64>());
  return (int)launch(std::integral_constant<int, 128>());
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
  return dispatch(B, T, D, [&](auto dm) {
    return fwd<decltype(dm)::value>(qv, kv, vv, out, lse, B, T, H, D, scale,
                                    causal, window, s);
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
  return dispatch(B, T, D, [&](auto dm) {
    return bwd_dq<decltype(dm)::value>(qv, kv, vv, ov, lse, delta, dq, B, T,
                                       H, D, scale, causal, window, s);
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
  return dispatch(B, T, D, [&](auto dm) {
    return bwd_dkv<decltype(dm)::value>(qv, kv, vv, ov, lse, delta, dk, dv, B,
                                        T, H, D, scale, causal, window, s);
  });
}

const char* vt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
