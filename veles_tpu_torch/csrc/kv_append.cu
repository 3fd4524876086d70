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
// once, each value read once), a few operations a byte.  A block's writes
// are one contiguous run of positions: each row of the call is one
// sequence that owns its blocks, and its valid positions are a prefix of
// its span, so apart from the trash block 0 no block is written from two
// runs.  What lands in the trash block is unspecified (the plain
// version's docstring says so), so its writes are skipped.  The design:
// - one warp a (run, head).  The grid is (position chunks, heads): the
//   warps of a CTA find the run starts of its chunk of kChunkUnit *
//   ceil(block_size / kChunkUnit) positions with a ballot (t == 0 or
//   blk[t-1] != blk[t], blk[t] != 0) and take them in turn, following a
//   run past the chunk's end; a chunk holds one run start or more unless
//   it is all padding, so no CTA launches only to exit for a run inside.
//   A CTA has 16 warps, one for each run of a decode step's chunk; a call
//   of kManyChunks chunks or more (a long prefill: a run or two a chunk)
//   takes CTAs of 4, so that they all fit the card at once;
// - the scale chain depends only on the writes' amax values.  The lanes
//   split the rows of a segment of up to 32 writes (32 / writes lanes a
//   row, 16-byte loads, all of a lane's loads in flight together); then
//   lane j holds write j, and s_new, the running max since the last
//   reopen (or of the old scale and the writes when none), is a
//   segmented max-scan over the lanes.  max is exact, so the scan gives
//   the serial chain's bits, and s_old, s_safe and ratio follow with the
//   same IEEE operations;
// - each byte then replays its own chain, with no barrier a write: a row
//   last written at write j takes rint(v_j / s_safe_j) and then every
//   later ratio; a row the run does not write starts from its old byte
//   and takes every ratio.  A ratio of exactly 1 is skipped (rint(q *
//   1.0f) == q for every |q| <= 127); an offset-0 reopen is a ratio of 0.
//   A bit mask of the segment's writes to each row (shared memory,
//   block_size words a warp) gives a row's last write, and a mask of the
//   writes whose ratio is not 1 the ratios it takes after that.  Each
//   lane owns 16 (else 4, else 1) bytes of a row of the block's slice,
//   read and written once a segment.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunkUnit = 32;  // positions one ballot tests
constexpr int kManyChunks = 32;  // from here on, CTAs of 4 warps, not 16

__device__ __forceinline__ float quantize(float x) {
  // clamp(rint(x), -127, 127); rintf rounds half to even
  return fminf(fmaxf(rintf(x), -127.0f), 127.0f);
}

// V bytes of the pool (16: a uint4, 4: a uint32, 1: a byte) as floats
template <int V>
__device__ __forceinline__ void load_bytes(const int8_t* p, float (&x)[V]) {
  if constexpr (V == 1) {
    x[0] = static_cast<float>(*p);
  } else {
    uint32_t w[V / 4];
    if constexpr (V == 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < V; ++i)
      x[i] = static_cast<float>(
          static_cast<int8_t>(w[i >> 2] >> (8 * (i & 3)) & 0xffu));
  }
}

template <int V>
__device__ __forceinline__ void store_bytes(int8_t* p, const float (&x)[V]) {
  if constexpr (V == 1) {
    *p = static_cast<int8_t>(x[0]);
  } else {
    uint32_t w[V / 4] = {};
#pragma unroll
    for (int i = 0; i < V; ++i)
      w[i >> 2] |= (static_cast<uint32_t>(static_cast<int>(x[i])) & 0xffu)
                   << (8 * (i & 3));
    if constexpr (V == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    }
  }
}

// V values of a row (16-byte loads when V >= 4)
template <int V>
__device__ __forceinline__ void load_vals(const float* v, float (&x)[V]) {
  if constexpr (V == 1) {
    x[0] = *v;
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(v + i);
      x[i] = f.x, x[i + 1] = f.y, x[i + 2] = f.z, x[i + 3] = f.w;
    }
  }
}

// amax|v| over row t + lane of D values on lanes 0 .. cnt - 1: the
// lanes split the cnt rows, L lanes a row (L * cnt <= 32), 16-byte loads
// (V >= 4) a lane in turn along the row; max is exact, so any order
// gives the same bits
template <int V>
__device__ __forceinline__ float rows_amax(const float* __restrict__ vals,
                                           long long t, int cnt, int heads,
                                           int h, int D) {
  const int lane = threadIdx.x & 31;
  const int L = cnt > 16 ? 1 : cnt > 8 ? 2 : cnt > 4 ? 4 : cnt > 2 ? 8
              : cnt > 1 ? 16 : 32;
  const int k = lane / L, part = lane - k * L;
  float m = 0.0f;
  if (k < cnt) {
    const float* v = vals + ((t + k) * heads + h) * D;
    if constexpr (V == 1) {
      for (int i = part; i < D; i += L) m = fmaxf(m, fabsf(v[i]));
    } else {
#pragma unroll 8
      for (int i = 4 * part; i < D; i += 4 * L) {
        const float4 f = *reinterpret_cast<const float4*>(v + i);
        m = fmaxf(fmaxf(m, fabsf(f.x)),
                  fmaxf(fabsf(f.y), fmaxf(fabsf(f.z), fabsf(f.w))));
      }
    }
  }
  for (int w = 1; w < L; w <<= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, w));
  return __shfl_sync(0xffffffffu, m, (lane * L) & 31);
}

// what one warp's lanes share of a segment: each write's offset, ratio
// and safe scale
struct Segment {
  int off[32];
  float ratio[32], safe[32];
};

// one warp: the run of writes to block blk[t0] that starts at t0, head h
template <int V, typename Idx>
__device__ void append_run(int8_t* __restrict__ q, float* __restrict__ s,
                           const Idx* __restrict__ blk,
                           const Idx* __restrict__ off,
                           const float* __restrict__ vals, int n,
                           int block_size, int heads, int head_dim,
                           long long t0, int h, Segment& seg,
                           unsigned* rows) {
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blk[t0]);
  const long long row_stride = static_cast<long long>(heads) * head_dim;
  int8_t* base = q + (b * block_size * heads + h) * head_dim;
  const int per_row = head_dim / V, nvec = block_size * per_row;
  float carry = s[b * heads + h];  // the scale before the segment
  for (long long t = t0;; t += 32) {
    // this segment's writes: t .. t + cnt - 1, write t + lane on lane
    const long long tj = t + lane;
    const bool in = tj < n && static_cast<long long>(blk[tj]) == b;
    const unsigned valid = __ballot_sync(0xffffffffu, in);
    const int cnt = valid == 0xffffffffu ? 32 : __ffs(~valid) - 1;
    if (cnt == 0) break;
    const int o = lane < cnt ? static_cast<int>(off[tj]) : 0;
    float a = rows_amax<V>(vals, t, cnt, heads, h, head_dim);
    if (lane < cnt) a = __fdiv_rn(a, 127.0f);
    // s_new: max of a since the last reopen (inclusive), a segmented scan
    float x = a;
    bool reopened = lane < cnt && o == 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float xo = __shfl_up_sync(0xffffffffu, x, d);
      const int ro = __shfl_up_sync(0xffffffffu, static_cast<int>(reopened),
                                    d);
      if (lane >= d && !reopened) {
        x = fmaxf(xo, x);
        reopened = ro != 0;
      }
    }
    const float s_new = reopened ? x : fmaxf(carry, x);
    float prev = __shfl_up_sync(0xffffffffu, s_new, 1);
    if (lane == 0) prev = carry;
    const float s_old = o == 0 ? 0.0f : prev;
    const float s_safe = s_new > 0.0f ? s_new : 1.0f;
    const float ratio = s_old > 0.0f ? __fdiv_rn(s_old, s_safe) : 0.0f;
    // the writes whose ratio is not 1
    const unsigned moved = __ballot_sync(0xffffffffu, lane < cnt &&
                                                          ratio != 1.0f);
    // every lane is done with the arrays the last segment or run left
    __syncwarp();
    for (int r = lane; r < block_size; r += 32) rows[r] = 0u;
    __syncwarp();
    if (lane < cnt) {
      seg.off[lane] = o;
      seg.ratio[lane] = ratio;
      seg.safe[lane] = s_safe;
      if (o >= 0 && o < block_size) atomicOr(&rows[o], 1u << lane);
    }
    carry = __shfl_sync(0xffffffffu, s_new, cnt - 1);
    __syncwarp();
    for (int e = lane; e < nvec; e += 32) {
      const int r = e / per_row, d = (e - r * per_row) * V;
      int8_t* p = base + r * row_stride + d;
      const unsigned w = rows[r];
      const int k = 31 - __clz(w);  // the last write to row r; -1: none
      float x[V];
      if (w) {
        load_vals<V>(vals + ((t + k) * heads + h) * head_dim + d, x);
        const float safe = seg.safe[k];
#pragma unroll
        for (int i = 0; i < V; ++i) x[i] = quantize(__fdiv_rn(x[i], safe));
      } else {
        load_bytes<V>(p, x);
      }
      // the ratios after write k that are not 1, in order
      for (unsigned m = w ? moved & ~(0xffffffffu >> (31 - k)) : moved; m;
           m &= m - 1) {
        const float rk = seg.ratio[__ffs(m) - 1];
#pragma unroll
        for (int i = 0; i < V; ++i) x[i] = quantize(x[i] * rk);
      }
      store_bytes<V>(p, x);
    }
    if (cnt < 32) break;
  }
  if (lane == 0) s[b * heads + h] = carry;
}

// W warps a CTA; dynamic shared memory: W x block_size row masks
template <int W, int V, typename Idx>
__global__ void __launch_bounds__(32 * W)
kv_append_int8_kernel(int8_t* __restrict__ q, float* __restrict__ s,
                      const Idx* __restrict__ blk, const Idx* __restrict__ off,
                      const float* __restrict__ vals, int n, int block_size,
                      int heads, int head_dim, int chunk) {
  __shared__ Segment segs[W];
  extern __shared__ unsigned row_masks[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.y;
  const long long c0 = static_cast<long long>(blockIdx.x) * chunk;
  int rank = 0;  // the chunk's run starts before this ballot's
  for (int p = 0; p < chunk; p += kChunkUnit) {
    const long long t = c0 + p + lane;
    bool start = false;
    if (t < n) {
      const long long b = static_cast<long long>(blk[t]);
      start = b != 0 && (t == 0 || static_cast<long long>(blk[t - 1]) != b);
    }
    for (unsigned m = __ballot_sync(0xffffffffu, start); m; m &= m - 1) {
      if (rank++ % W == warp)
        append_run<V>(q, s, blk, off, vals, n, block_size, heads, head_dim,
                      c0 + p + __ffs(m) - 1, h, segs[warp],
                      row_masks + warp * block_size);
    }
  }
}

template <int W, typename Idx>
int launch_w(int8_t* q, float* s, const Idx* blk, const Idx* off,
             const float* vals, int n, int block_size, int heads,
             int head_dim, int chunk, int V, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((n + chunk - 1) / chunk),
                  static_cast<unsigned>(heads));
  const size_t smem = sizeof(unsigned) * W * block_size;
  auto kernel = V == 16 ? kv_append_int8_kernel<W, 16, Idx>
                : V == 4 ? kv_append_int8_kernel<W, 4, Idx>
                         : kv_append_int8_kernel<W, 1, Idx>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, 32 * W, smem, st>>>(q, s, blk, off, vals, n, block_size,
                                     heads, head_dim, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename Idx>
int launch(int8_t* q, float* s, const Idx* blk, const Idx* off,
           const float* vals, int n, int block_size, int heads, int head_dim,
           void* stream) {
  if (n < 1 || block_size < 1 || heads < 1 || heads > 65535 ||
      head_dim < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // a chunk of at least block_size positions holds a run start unless it
  // is all padding (a run is at most block_size writes)
  const int chunk =
      kChunkUnit * ((block_size + kChunkUnit - 1) / kChunkUnit);
  const uintptr_t qa = reinterpret_cast<uintptr_t>(q);
  const uintptr_t va = reinterpret_cast<uintptr_t>(vals);
  // 16 bytes a lane where every row and the pool allow, else 4, else 1
  const int V = head_dim % 16 == 0 && qa % 16 == 0 && va % 16 == 0  ? 16
                : head_dim % 4 == 0 && qa % 4 == 0 && va % 16 == 0 ? 4
                                                                   : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((n + chunk - 1) / chunk >= kManyChunks)
    return launch_w<4>(q, s, blk, off, vals, n, block_size, heads, head_dim,
                       chunk, V, st);
  return launch_w<16>(q, s, blk, off, vals, n, block_size, heads, head_dim,
                      chunk, V, st);
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
