// The int8 KV-pool append for Hopper (sm_90a): one launch writes every
// position of a prefill, a prefill chunk, a decode step or a speculative
// verify span into one layer's int8 pool.
//
// Not a TPU kernel.  It computes what veles_tpu/znicz/samples/flagship.py
// :_append_kv runs as a jax.lax.fori_loop over the positions (:330-361),
// and what kv_append_int8_reference in znicz/paged_attention.py computes
// as vectorized passes, bit for bit.  The pool is int8 [num_blocks,
// block_size, H, D] with f32 scales [num_blocks, H]; write t puts
// vals[t] ([H, D], f32) at row off[t] of block blk[t].  For each head,
// the writes to one block, in order:
//   s_old  = off == 0 ? 0 : s[b]        (offset 0 reopens the block)
//   s_new  = max(s_old, amax|v| / 127)
//   s_safe = s_new > 0 ? s_new : 1
//   ratio  = s_old > 0 ? s_old / s_safe : 0
//   every row of the block: q = clamp(rint(q * ratio), -127, 127)
//   row off:                q = clamp(rint(v / s_safe), -127, 127)
// with IEEE divides and round-half-even (rintf), as torch.round and the
// IEEE "/" of the plain version; the build has no --use_fast_math.
//
// What bounds it on the card: bytes (each touched block read and written
// once, each value read once), a few operations a byte.  The design is
// the simplest that keeps one launch a call and no host sync:
// - a block's writes are one contiguous run of positions: each row of
//   the call is one sequence that owns its blocks, and its valid
//   positions are a prefix of its span, so apart from the trash block 0
//   no block is written from two runs;
// - grid (positions, heads): the CTA of position t and head h works only
//   if t starts a run (t == 0 or blk[t-1] != blk[t]) and blk[t] != 0; it
//   walks its run in order, on the device, with the head's block slice
//   (block_size x D int8) in shared memory, and writes the slice and the
//   scale back once at the end.  CTAs of positions inside a run exit at
//   once.  What lands in the trash block is unspecified (the plain
//   version's docstring says so), so its writes are skipped;
// - per write, amax|v| is a CTA max-reduction (warp shuffles, then one
//   value a warp in shared memory), and the slice is rescaled in shared
//   memory, as the plain version rescales the whole block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int8_t quantize(float x) {
  // clamp(rint(x), -127, 127); rintf rounds half to even
  return static_cast<int8_t>(fminf(fmaxf(rintf(x), -127.0f), 127.0f));
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
kv_append_int8_kernel(int8_t* __restrict__ q, float* __restrict__ s,
                      const Idx* __restrict__ blk, const Idx* __restrict__ off,
                      const float* __restrict__ vals, int n, int block_size,
                      int heads, int head_dim) {
  extern __shared__ int8_t rows[];          // [block_size][head_dim]
  __shared__ float warp_max[kWarps];
  const int t0 = blockIdx.x;
  const int h = blockIdx.y;
  const long long b = static_cast<long long>(blk[t0]);
  if (b == 0 || (t0 > 0 && static_cast<long long>(blk[t0 - 1]) == b)) {
    return;                                 // trash, or not a run start
  }
  int t_end = t0 + 1;
  while (t_end < n && static_cast<long long>(blk[t_end]) == b) ++t_end;
  const int tid = threadIdx.x;
  const int slice = block_size * head_dim;
  const long long row_stride = static_cast<long long>(heads) * head_dim;
  int8_t* base = q + (b * block_size * heads + h) * head_dim;
  for (int e = tid; e < slice; e += kThreads) {
    const int o = e / head_dim;
    rows[e] = base[o * row_stride + (e - o * head_dim)];
  }
  float scale = s[b * heads + h];
  __syncthreads();
  for (int t = t0; t < t_end; ++t) {
    const int o = static_cast<int>(off[t]);
    const float* v = vals + (static_cast<long long>(t) * heads + h) *
                                head_dim;
    float m = 0.0f;
    for (int i = tid; i < head_dim; i += kThreads) m = fmaxf(m, fabsf(v[i]));
    for (int k = 16; k > 0; k >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, k));
    }
    if ((tid & 31) == 0) warp_max[tid >> 5] = m;
    __syncthreads();
    m = warp_max[0];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_max[w]);
    const float s_old = o == 0 ? 0.0f : scale;
    const float s_new = fmaxf(s_old, m / 127.0f);
    const float s_safe = s_new > 0.0f ? s_new : 1.0f;
    const float ratio = s_old > 0.0f ? s_old / s_safe : 0.0f;
    // row o is rewritten below; every other row is rescaled (with an
    // unchanged scale, ratio 1 keeps each byte)
    for (int e = tid; e < slice; e += kThreads) {
      if (e / head_dim != o) {
        rows[e] = quantize(static_cast<float>(rows[e]) * ratio);
      }
    }
    for (int i = tid; i < head_dim; i += kThreads) {
      rows[o * head_dim + i] = quantize(v[i] / s_safe);
    }
    scale = s_new;
    __syncthreads();
  }
  for (int e = tid; e < slice; e += kThreads) {
    const int o = e / head_dim;
    base[o * row_stride + (e - o * head_dim)] = rows[e];
  }
  if (tid == 0) s[b * heads + h] = scale;
}

template <typename Idx>
int launch(int8_t* q, float* s, const Idx* blk, const Idx* off,
           const float* vals, int n, int block_size, int heads, int head_dim,
           void* stream) {
  const size_t smem = static_cast<size_t>(block_size) * head_dim;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kv_append_int8_kernel<Idx>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kv_append_int8_kernel<Idx>
      <<<dim3(n, heads), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(q, s, blk, off, vals, n,
                                              block_size, heads, head_dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One append of `n` positions (blk/off int32) into the int8 pool `q`
// [num_blocks, block_size, heads, head_dim] and its scales `s`
// [num_blocks, heads], in place; `vals` is f32 [n, heads, head_dim].
int vt_kv_append_int8_i32(int8_t* q, float* s, const int32_t* blk,
                          const int32_t* off, const float* vals, int n,
                          int block_size, int heads, int head_dim,
                          void* stream) {
  return launch(q, s, blk, off, vals, n, block_size, heads, head_dim,
                stream);
}

// The same with int64 blk/off.
int vt_kv_append_int8_i64(int8_t* q, float* s, const int64_t* blk,
                          const int64_t* off, const float* vals, int n,
                          int block_size, int heads, int head_dim,
                          void* stream) {
  return launch(q, s, blk, off, vals, n, block_size, heads, head_dim,
                stream);
}

const char* vt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
