// Ragged paged decode attention for Hopper (sm_90a).
//
// Replaces veles_tpu/znicz/paged_attention.py:_decode_kernel (f32 pools)
// and :_decode_kernel_quant (int8 pools with per-(block, head) f32
// scales), both launched through paged_attention().  One query token per
// (row, head) attends over that row's K/V history, which lives in
// fixed-size blocks of a shared pool [num_blocks, block_size, H, D] and
// is found through page_table[row] and masked to lengths[row].
//
// What bounds it on the card: the bytes of K and V that the valid tokens
// occupy (4 bytes an element for f32 pools, 1 for int8), read once from
// HBM at 3.35 TB/s.  The arithmetic (4 flops an element) is far below
// the f32 rate.
//
// What the design does about it:
// - blocks past a row's length are never read, so a ragged batch costs
//   its true token count, not batch x max_context;
// - int8 pools cross HBM as int8 and are dequantized in registers right
//   after the load (int8 -> f32 * scale[physical block, head]);
// - the softmax stays the TPU kernel's DENSE one (one max, one exp, one
//   sum over a score row in shared memory, no online rescale), which
//   keeps the kernel close to the dense reference;
// - no scalar prefetch: each CTA loads its own page-table row and
//   length into shared memory.
// This first version is simple on purpose: one CTA of 256 threads per
// (row, head), a warp per token in the scoring sweep, threads over D
// (and token groups when D is small) in the value sweep.  No TMA, no
// cp.async pipelining yet.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions through `red` (kWarps floats).  Both start and
// end with a barrier, so they also publish earlier shared-memory writes.
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kWarps ? red[lane] : -INFINITY;
  v = warp_max(v);
  __syncthreads();
  return v;
}

__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kWarps ? red[lane] : 0.f;
  v = warp_sum(v);
  __syncthreads();
  return v;
}

// Shared memory, in floats: q*scale [D] | reduction [32] | value-sweep
// partials [kThreads] | K scales [nb] | V scales [nb] | page-table row
// [nb] (ints) | score row [nb * bs].
__host__ __device__ inline size_t smem_floats(int head_dim, int max_blocks,
                                              int block_size) {
  return (size_t)head_dim + 32 + kThreads + 3 * (size_t)max_blocks +
         (size_t)max_blocks * block_size;
}

template <typename T, bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q,
                    const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    float* __restrict__ out, int heads, int head_dim,
                    int block_size, int max_blocks, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* red = q_s + head_dim;
  float* part = red + 32;
  float* ks_s = part + kThreads;
  float* vs_s = ks_s + max_blocks;
  int* table_s = reinterpret_cast<int*>(vs_s + max_blocks);
  float* s = reinterpret_cast<float*>(table_s + max_blocks);

  const int h = blockIdx.x, row = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* out_row = out + ((size_t)row * heads + h) * head_dim;

  int length = lengths[row];
  length = min(max(length, 0), max_blocks * block_size);
  if (length == 0) {  // padding row: zeros, and no pool read at all
    for (int d = tid; d < head_dim; d += kThreads) out_row[d] = 0.f;
    return;
  }
  const int n_blocks = (length + block_size - 1) / block_size;
  const float* q_row = q + ((size_t)row * heads + h) * head_dim;
  for (int d = tid; d < head_dim; d += kThreads) q_s[d] = q_row[d] * scale;
  for (int j = tid; j < n_blocks; j += kThreads) {
    const int pid = page_table[(size_t)row * max_blocks + j];
    table_s[j] = pid;
    if (kQuant) {
      ks_s[j] = k_scales[(size_t)pid * heads + h];
      vs_s[j] = v_scales[(size_t)pid * heads + h];
    }
  }
  __syncthreads();

  const size_t tok_stride = (size_t)heads * head_dim;
  const size_t blk_stride = (size_t)block_size * tok_stride;
  const size_t head_off = (size_t)h * head_dim;

  // sweep 1: a warp per token scores it into the dense score row
  float local_max = -INFINITY;
  for (int t = warp; t < length; t += kWarps) {
    const int j = t / block_size, off = t - j * block_size;
    const T* k_row = k_pool + (size_t)table_s[j] * blk_stride +
                     (size_t)off * tok_stride + head_off;
    const float k_sc = kQuant ? ks_s[j] : 1.f;
    float acc = 0.f;
    for (int d = lane; d < head_dim; d += 32) {
      const float kv = kQuant ? to_float(k_row[d]) * k_sc : to_float(k_row[d]);
      acc += q_s[d] * kv;
    }
    acc = warp_sum(acc);
    if (lane == 0) s[t] = acc;
    local_max = fmaxf(local_max, acc);
  }
  const float m = block_max(local_max, red);

  // dense softmax numerators and their sum
  float local_sum = 0.f;
  for (int t = tid; t < length; t += kThreads) {
    const float p = expf(s[t] - m);
    s[t] = p;
    local_sum += p;
  }
  float l = block_sum(local_sum, red);
  l = l == 0.f ? 1.f : l;

  // sweep 2: probability-weighted V; small D splits the tokens into
  // `groups` interleaved runs whose partial sums meet in shared memory
  const int groups = head_dim >= kThreads ? 1 : kThreads / head_dim;
  if (groups == 1) {
    for (int d = tid; d < head_dim; d += kThreads) {
      float acc = 0.f;
      for (int t = 0; t < length; ++t) {
        const int j = t / block_size, off = t - j * block_size;
        const T* v_row = v_pool + (size_t)table_s[j] * blk_stride +
                         (size_t)off * tok_stride + head_off;
        const float vv =
            kQuant ? to_float(v_row[d]) * vs_s[j] : to_float(v_row[d]);
        acc += s[t] * vv;
      }
      out_row[d] = acc / l;
    }
    return;
  }
  const int g = tid / head_dim, d = tid - g * head_dim;
  float acc = 0.f;
  if (g < groups) {
    for (int t = g; t < length; t += groups) {
      const int j = t / block_size, off = t - j * block_size;
      const T* v_row = v_pool + (size_t)table_s[j] * blk_stride +
                       (size_t)off * tok_stride + head_off;
      const float vv =
          kQuant ? to_float(v_row[d]) * vs_s[j] : to_float(v_row[d]);
      acc += s[t] * vv;
    }
  }
  part[tid] = acc;
  __syncthreads();
  if (tid < head_dim) {
    float sum = 0.f;
    for (int gg = 0; gg < groups; ++gg) sum += part[gg * head_dim + tid];
    out_row[tid] = sum / l;
  }
}

template <typename T, bool kQuant>
int launch(const float* q, const T* k_pool, const T* v_pool,
           const int* page_table, const int* lengths, const float* k_scales,
           const float* v_scales, float* out, int batch, int heads,
           int head_dim, int block_size, int max_blocks, float scale,
           void* stream) {
  const size_t smem =
      smem_floats(head_dim, max_blocks, block_size) * sizeof(float);
  auto kernel = paged_decode_kernel<T, kQuant>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(heads, batch);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k_pool, v_pool, page_table, lengths, k_scales, v_scales, out, heads,
      head_dim, block_size, max_blocks, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs; the wrapper refuses a geometry
// past the card's 227 KB per block.
size_t vt_paged_attention_smem_bytes(int head_dim, int max_blocks,
                                     int block_size) {
  return smem_floats(head_dim, max_blocks, block_size) * sizeof(float);
}

int vt_paged_attention_f32(const float* q, const float* k_pool,
                           const float* v_pool, const int* page_table,
                           const int* lengths, float* out, int batch,
                           int heads, int head_dim, int block_size,
                           int max_blocks, float scale, void* stream) {
  return launch<float, false>(q, k_pool, v_pool, page_table, lengths,
                              nullptr, nullptr, out, batch, heads, head_dim,
                              block_size, max_blocks, scale, stream);
}

int vt_paged_attention_int8(const float* q, const int8_t* k_pool,
                            const int8_t* v_pool, const int* page_table,
                            const int* lengths, const float* k_scales,
                            const float* v_scales, float* out, int batch,
                            int heads, int head_dim, int block_size,
                            int max_blocks, float scale, void* stream) {
  return launch<int8_t, true>(q, k_pool, v_pool, page_table, lengths,
                              k_scales, v_scales, out, batch, heads,
                              head_dim, block_size, max_blocks, scale,
                              stream);
}

const char* vt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
