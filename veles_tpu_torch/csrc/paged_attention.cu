// Ragged paged decode attention for Hopper (sm_90a).
//
// Replaces veles_tpu/znicz/paged_attention.py:_decode_kernel (f32 pools)
// and :_decode_kernel_quant (int8 pools with per-(block, head) f32
// scales), both launched through paged_attention().  One query token per
// (row, head) attends over that row's K/V history, which lives in
// fixed-size blocks of a shared pool [num_blocks, block_size, H, D] and
// is found through page_table[row] and masked to lengths[row]:
// softmax(q . K^T * scale) . V over the row's valid tokens.
//
// What bounds it on the card: the bytes of K and V that the valid tokens
// occupy (4 bytes an element for f32 pools, 1 for int8), read once from
// HBM at 3.35 TB/s; 4 flops an element are far below the f32 rate.  One
// query a (row, head) makes each product a GEMV: an mma tile would be
// 1/16 used, so the products run on the CUDA cores and the design is
// about keeping enough bytes in flight:
// - the context is split over CTAs (flash-decoding): grid (H, B, split),
//   each CTA takes one head of a row over a contiguous range of
//   `blocks_per_split` blocks.  The plan (paged_attention_plan in
//   znicz/paged_attention.py) comes from static shapes and the SM count
//   only, never from `lengths`, so a call needs no host sync.  A CTA
//   whose range starts past its row's length exits before it reads the
//   pool; length-0 rows read nothing.  A CTA over several heads of a row,
//   whose token rows load as one, measured slower at every shape (fewer
//   CTAs, more work a tile);
// - an online softmax over tiles of `tile` tokens: each CTA keeps a
//   running max m, sum l and the accumulator acc (in registers; in
//   shared memory past kThreads column chunks), rescaled tile by tile;
//   each K/V byte is read once and no score row is kept, so shared
//   memory does not grow with the context and any table runs (a head
//   dim, up to where one token row of the ring fills shared memory);
// - a three-stage cp.async ring of K/V tiles (16-byte copies where the
//   head's bytes and the pool bases allow, else 8 or 4, else plain byte
//   loads), so two tiles are in flight while one is consumed; the CTA's
//   page-table entries (and K2's scales) are loaded once up front, and
//   each tile's row offsets are placed a tile ahead, so a copy pays no
//   integer division (with them, the copies' index math was most of a
//   tile's instructions);
// - the products read 16 bytes of a tile a lane (a float4, or 16 int8
//   dequantized in registers as float(int8) * scale[physical block,
//   head], the product the plain version forms; the int8 -> float
//   conversion by a byte permute, not the quarter-rate I2F), with scalar
//   reads where D is not a multiple of the vector;
// - split > 1: each CTA writes its partial (acc, m, l) to a workspace and
//   a second small kernel merges the partials of each (row, head) in
//   split order 0..S-1, so a call gives the same bits every time;
//   split == 1 normalizes in place and is one launch.
// What a grid of such CTAs costs is residency: about 50 KB of shared
// memory and at most 128 registers a thread let 4 CTAs stay on an SM,
// and the plan aims at that many, so the CTAs that find work take one
// wave (a 4-stage ring, 3 an SM, ran the long context in twice the time).
// The sums run in another order than the dense plain version's (an
// online rescale, tiles, splits); both are held to 1e-5 on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 3;
constexpr int kRowSlots = kStages + 1;  // tiles whose rows are placed
constexpr int kMaxCards = 64;

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of a CTA's shared memory.  ring: kStages x (K tile, V
// tile), each `tile` token rows of `pitch` bytes (D elements padded to
// 16); roff: for kRowSlots tiles, each token row's byte offset in the
// pools (its head's bytes of K or V); ktok, vtok: its K and V scales
// (int8); acc: `groups` token groups x D floats, kept here only where a
// thread holds more than one column chunk (else in registers, and the
// final fold uses the ring); q: D floats of q * scale; s: the tile's
// scores; lpart: each token group's softmax sum; table: the range's
// physical block ids; ksc, vsc: their scales (int8).
struct Layout {
  size_t ring, roff, ktok, vtok, acc, q, s, lpart, table, ksc, vsc, bytes;
  int pitch, groups;
  bool reg_acc;
};

__host__ __device__ inline Layout make_layout(int head_dim, int tile,
                                              int bps, int elem, int vec,
                                              bool quant) {
  Layout L;
  L.pitch = static_cast<int>(align16(static_cast<size_t>(head_dim) * elem));
  const int chunks = head_dim / vec;
  const int per_thread = kThreads / chunks;  // token groups that fit
  L.groups = per_thread < 1 ? 1 : per_thread > tile ? tile : per_thread;
  L.reg_acc = chunks <= kThreads;
  const size_t q = quant ? 1 : 0;
  size_t o = 0;
  L.ring = o;
  o += align16(static_cast<size_t>(kStages) * 2 * tile * L.pitch);
  L.roff = o;
  o += align16(static_cast<size_t>(kRowSlots) * tile * 8);
  L.ktok = o;
  o += q * align16(static_cast<size_t>(kRowSlots) * tile * 4);
  L.vtok = o;
  o += q * align16(static_cast<size_t>(kRowSlots) * tile * 4);
  L.acc = L.reg_acc ? L.ring : o;
  o += L.reg_acc ? 0 : align16(static_cast<size_t>(L.groups) * head_dim * 4);
  L.q = o;
  o += align16(static_cast<size_t>(head_dim) * 4);
  L.s = o;
  o += align16(static_cast<size_t>(tile) * 4);
  L.lpart = o;
  o += align16(static_cast<size_t>(L.groups) * 4);
  L.table = o;
  o += align16(static_cast<size_t>(bps) * 4);
  L.ksc = o;
  o += q * align16(static_cast<size_t>(bps) * 4);
  L.vsc = o;
  o += q * align16(static_cast<size_t>(bps) * 4);
  L.bytes = o;
  return L;
}

struct Args {
  const float* q;
  const unsigned char* k_pool;
  const unsigned char* v_pool;
  const int* table;
  const int* lengths;
  const float* k_scales;
  const float* v_scales;
  float* out;
  float* ws;  // split > 1: acc [B, H, S, D], then m [B, H, S], l [B, H, S]
  int batch, heads, head_dim, block_size, max_blocks;
  int split, blocks_per_split, tile, copy_bytes;
  float scale;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  else if (bytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  else
    *static_cast<unsigned char*>(dst) =
        *static_cast<const unsigned char*>(src);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// int8 bytes as floats without I2F (a quarter-rate conversion): each
// byte, sign bit flipped, becomes the low mantissa byte of 2^23, and
// 2^23 + 128 is subtracted; exact for every int8.
__device__ __forceinline__ void bytes_to_float(unsigned w, float* x) {
  w ^= 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650u | i)) -
           8388736.f;
}

// VE consecutive elements of a shared tile as floats, in one load of
// VE * sizeof(T) bytes (16, 4 or 1).
template <typename T, int VE>
__device__ __forceinline__ void load_vec(const T* p, float* x) {
  constexpr int kBytes = static_cast<int>(sizeof(T)) * VE;
  if constexpr (sizeof(T) == 1 && kBytes == 16) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    bytes_to_float(w.x, x);
    bytes_to_float(w.y, x + 4);
    bytes_to_float(w.z, x + 8);
    bytes_to_float(w.w, x + 12);
  } else if constexpr (sizeof(T) == 1 && kBytes == 4) {
    bytes_to_float(*reinterpret_cast<const unsigned*>(p), x);
  } else if constexpr (kBytes == 16) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
  } else {
#pragma unroll
    for (int e = 0; e < VE; ++e) x[e] = static_cast<float>(p[e]);
  }
}

// VE floats of shared memory (float4s where VE is a multiple of 4).
template <int VE>
__device__ __forceinline__ void load_f(const float* p, float* x) {
  if constexpr (VE % 4 == 0) {
#pragma unroll
    for (int e = 0; e < VE; e += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + e);
      x[e] = f.x, x[e + 1] = f.y, x[e + 2] = f.z, x[e + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VE; ++e) x[e] = p[e];
  }
}

template <int VE>
__device__ __forceinline__ void store_f(float* p, const float* x) {
  if constexpr (VE % 4 == 0) {
#pragma unroll
    for (int e = 0; e < VE; e += 4)
      *reinterpret_cast<float4*>(p + e) =
          make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < VE; ++e) p[e] = x[e];
  }
}

// Where tile `it`'s token rows lie: each row's byte offset in the pools
// (and, int8, its block's K and V scales), into row slot it % kRowSlots;
// one division a token, here, and none a copy.
template <bool kQuant>
__device__ __forceinline__ void place_rows(const Args& a, const Layout& L,
                                           unsigned char* smem, int it,
                                           int r0, int r1, int j0,
                                           long long row_bytes,
                                           long long head_off) {
  const int* table_s = reinterpret_cast<const int*>(smem + L.table);
  const int slot = (it % kRowSlots) * a.tile;
  long long* roff = reinterpret_cast<long long*>(smem + L.roff) + slot;
  const int t0 = r0 + it * a.tile, nv = min(a.tile, r1 - t0);
  for (int t = threadIdx.x; t < nv; t += kThreads) {
    const int pos = t0 + t, j = pos / a.block_size;
    roff[t] = (static_cast<long long>(table_s[j - j0]) * a.block_size +
               (pos - j * a.block_size)) * row_bytes + head_off;
    if (kQuant) {
      reinterpret_cast<float*>(smem + L.ktok)[slot + t] =
          reinterpret_cast<const float*>(smem + L.ksc)[j - j0];
      reinterpret_cast<float*>(smem + L.vtok)[slot + t] =
          reinterpret_cast<const float*>(smem + L.vsc)[j - j0];
    }
  }
}

// A thread's copies walk the tile's 2 * nv rows (K rows, then V rows)
// in strides of kThreads chunks of `copy_bytes`, found without divisions.
struct CopyWalk {
  int cpr, first_row, first_part, step_rows, step_part;
};

// Tile `it` (rows placed) into ring stage it % kStages.
__device__ __forceinline__ void issue_tile(const Args& a, const Layout& L,
                                           unsigned char* smem,
                                           const CopyWalk& w, int it,
                                           int r0, int r1) {
  const long long* roff =
      reinterpret_cast<const long long*>(smem + L.roff) +
      (it % kRowSlots) * a.tile;
  const int cb = a.copy_bytes;
  const int nv = min(a.tile, r1 - r0 - it * a.tile);
  unsigned char* dst0 =
      smem + L.ring + static_cast<size_t>(it % kStages) * 2 * a.tile * L.pitch;
  int row = w.first_row, part = w.first_part;
  while (row < 2 * nv) {
    const int v = row >= nv, t = row - v * nv;
    cp_async(dst0 + (row + v * (a.tile - nv)) * L.pitch + part * cb,
             (v ? a.v_pool : a.k_pool) + roff[t] + part * cb, cb);
    row += w.step_rows;
    part += w.step_part;
    if (part >= w.cpr) {
      part -= w.cpr;
      ++row;
    }
  }
}

// One (row, head, split): the online softmax over the split's tiles.
// Scores: `lanes` lanes a token, VE elements a lane a step.  Values: a
// thread owns a VE-wide column chunk of one token group (tokens grp, grp
// + groups, ...), keeps the running max m (the same in every thread) and
// its group's sum l in registers and forms its tokens' probabilities
// itself, so a tile takes two barriers.
template <typename T, int VE, bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.head_dim, TT = a.tile, bs = a.block_size, S = a.split;
  const Layout L = make_layout(D, TT, a.blocks_per_split, sizeof(T), VE,
                               kQuant);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* lpart_s = reinterpret_cast<float*>(smem + L.lpart);
  int* table_s = reinterpret_cast<int*>(smem + L.table);

  const int h = blockIdx.x, row = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t bh = static_cast<size_t>(row) * a.heads + h;
  const size_t n_part = static_cast<size_t>(a.batch) * a.heads * S;

  const int length = min(max(a.lengths[row], 0), a.max_blocks * bs);
  const int j0 = sp * a.blocks_per_split;
  const int r0 = j0 * bs;
  const int r1 = min(length, min(j0 + a.blocks_per_split, a.max_blocks) * bs);
  if (r0 >= r1) {  // nothing of this row in the range: no pool read
    if (S == 1) {
      for (int i = tid; i < D; i += kThreads) a.out[bh * D + i] = 0.f;
    } else if (tid == 0) {
      a.ws[n_part * D + bh * S + sp] = -INFINITY;
      a.ws[n_part * (D + 1) + bh * S + sp] = 0.f;
    }
    return;
  }

  const float* q_row = a.q + bh * D;
  for (int i = tid; i < D; i += kThreads) q_s[i] = q_row[i] * a.scale;
  const int n_blk = (r1 - r0 + bs - 1) / bs;
  for (int jj = tid; jj < n_blk; jj += kThreads) {
    const int pid =
        a.table[static_cast<size_t>(row) * a.max_blocks + j0 + jj];
    table_s[jj] = pid;
    if (kQuant) {
      reinterpret_cast<float*>(smem + L.ksc)[jj] =
          a.k_scales[static_cast<size_t>(pid) * a.heads + h];
      reinterpret_cast<float*>(smem + L.vsc)[jj] =
          a.v_scales[static_cast<size_t>(pid) * a.heads + h];
    }
  }
  const int TG = L.groups, NC = D / VE;
  if (!L.reg_acc)
    for (int i = tid; i < TG * D; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  const int n_tiles = (r1 - r0 + TT - 1) / TT;
  // a pool row (one token's H heads) and this head's offset in it
  const long long row_bytes = static_cast<long long>(a.heads) * D * sizeof(T);
  const long long head_off = static_cast<long long>(h) * D * sizeof(T);
  for (int it = 0; it < kStages && it < n_tiles; ++it)
    place_rows<kQuant>(a, L, smem, it, r0, r1, j0, row_bytes, head_off);
  CopyWalk w;
  w.cpr = D * static_cast<int>(sizeof(T)) / a.copy_bytes;
  w.first_row = tid / w.cpr;
  w.first_part = tid - w.first_row * w.cpr;
  w.step_rows = kThreads / w.cpr;
  w.step_part = kThreads - w.step_rows * w.cpr;
  __syncthreads();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) issue_tile(a, L, smem, w, st, r0, r1);
    cp_async_commit();
  }

  const int pitch_e = L.pitch / static_cast<int>(sizeof(T));
  const int vph = D / VE;  // vectors a head
  int lanes = 1;           // lanes a score: a power of two, at most 32
  while (lanes < 32 && lanes < vph) lanes <<= 1;
  const int per_pass = kThreads / lanes, sub = tid & (lanes - 1);
  // a lane with one vector of the head keeps its q in registers
  const bool q_in_regs = vph <= lanes;
  float qr[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) qr[e] = 0.f;
  if (q_in_regs && sub < vph) load_f<VE>(q_s + sub * VE, qr);
  float m_run = -INFINITY, l_run = 0.f, o_reg[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) o_reg[e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // the tile kStages - 1 ahead goes in flight, and the one after it is
    // placed (its row slot last served tile it - 1, issued long before)
    if (it + kStages - 1 < n_tiles)
      issue_tile(a, L, smem, w, it + kStages - 1, r0, r1);
    cp_async_commit();
    if (it + kStages < n_tiles)
      place_rows<kQuant>(a, L, smem, it + kStages, r0, r1, j0, row_bytes,
                         head_off);
    const int nv = min(TT, r1 - r0 - it * TT);
    const int slot = (it % kRowSlots) * TT;
    const float* ktok = reinterpret_cast<const float*>(smem + L.ktok) + slot;
    const float* vtok = reinterpret_cast<const float*>(smem + L.vtok) + slot;
    const T* kt = reinterpret_cast<const T*>(
        smem + L.ring + static_cast<size_t>(it % kStages) * 2 * TT * L.pitch);
    const T* vt = kt + static_cast<size_t>(TT) * pitch_e;

    for (int base = 0; base < nv; base += per_pass) {
      const int t = base + tid / lanes;
      // kPart interleaved partial sums, added in order: shorter chains
      constexpr int kPart = VE < 4 ? VE : 4;
      float part[kPart];
#pragma unroll
      for (int i = 0; i < kPart; ++i) part[i] = 0.f;
      if (t < nv) {
        const T* krow = kt + static_cast<size_t>(t) * pitch_e;
        const float ksc = kQuant ? ktok[t] : 1.f;
        if (q_in_regs) {
          if (sub < vph) {
            float x[VE];
            load_vec<T, VE>(krow + sub * VE, x);
#pragma unroll
            for (int e = 0; e < VE; ++e)
              part[e % kPart] += qr[e] * (kQuant ? x[e] * ksc : x[e]);
          }
        } else {
          for (int v = sub; v < vph; v += lanes) {
            float x[VE], y[VE];
            load_vec<T, VE>(krow + v * VE, x);
            load_f<VE>(q_s + v * VE, y);
#pragma unroll
            for (int e = 0; e < VE; ++e)
              part[e % kPart] += y[e] * (kQuant ? x[e] * ksc : x[e]);
          }
        }
      }
      float dot = part[0];
#pragma unroll
      for (int i = 1; i < kPart; ++i) dot += part[i];
      for (int o = lanes >> 1; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (t < nv && sub == 0) s_s[t] = dot;
    }
    __syncthreads();

    // the tile's max, the same in every warp; then the online rescale
    float mx = -INFINITY;
    for (int t = lane; t < nv; t += 32) mx = fmaxf(mx, s_s[t]);
    mx = warp_max(mx);
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);  // 0 on the first tile
    m_run = m_new;

    // acc = acc * alpha + P . V over the thread's tokens
    for (int c = tid; c < TG * NC; c += kThreads) {
      const int grp = c / NC, col = (c - grp * NC) * VE;
      float* ac = acc + grp * D + col;
      float o[VE];
      if (L.reg_acc) {
#pragma unroll
        for (int e = 0; e < VE; ++e) o[e] = o_reg[e] * alpha;
      } else {
        load_f<VE>(ac, o);
#pragma unroll
        for (int e = 0; e < VE; ++e) o[e] *= alpha;
      }
      float lsum = 0.f;
      for (int t = grp; t < nv; t += TG) {
        float x[VE];
        load_vec<T, VE>(vt + static_cast<size_t>(t) * pitch_e + col, x);
        const float p = expf(s_s[t] - m_new);
        const float vsc = kQuant ? vtok[t] : 1.f;
        lsum += p;
#pragma unroll
        for (int e = 0; e < VE; ++e) o[e] += p * (kQuant ? x[e] * vsc : x[e]);
      }
      if (L.reg_acc) {
#pragma unroll
        for (int e = 0; e < VE; ++e) o_reg[e] = o[e];
      } else {
        store_f<VE>(ac, o);
      }
      if (c == tid) l_run = l_run * alpha + lsum;
    }
  }
  cp_async_wait<0>();
  if (L.reg_acc) {
    __syncthreads();  // the ring, now the fold's acc, is read no more
    if (tid < TG * NC)
      store_f<VE>(acc + (tid / NC) * D + (tid % NC) * VE, o_reg);
  }
  if (tid < TG * NC && tid % NC == 0) lpart_s[tid / NC] = l_run;
  __syncthreads();

  // the token groups' sums in group order; split 1 normalizes here
  float l = 0.f;
  for (int grp = 0; grp < TG; ++grp) l += lpart_s[grp];
  for (int c = tid; c < NC; c += kThreads) {
    const int col = c * VE;
    float o[VE], x[VE];
    load_f<VE>(acc + col, o);
    for (int grp = 1; grp < TG; ++grp) {
      load_f<VE>(acc + grp * D + col, x);
#pragma unroll
      for (int e = 0; e < VE; ++e) o[e] += x[e];
    }
    if (S == 1) {
      const float den = l == 0.f ? 1.f : l;
#pragma unroll
      for (int e = 0; e < VE; ++e) a.out[bh * D + col + e] = o[e] / den;
    } else {
      float* dst = a.ws + (bh * S + sp) * D + col;
#pragma unroll
      for (int e = 0; e < VE; ++e) dst[e] = o[e];
    }
  }
  if (S > 1 && tid == 0) {
    a.ws[n_part * D + bh * S + sp] = m_run;
    a.ws[n_part * (D + 1) + bh * S + sp] = l;
  }
}

// split > 1: out[row, h] = sum_s acc_s * exp(m_s - M) / sum_s l_s *
// exp(m_s - M), M = max_s m_s, each sum in split order 0..S-1; a split
// that held none of the row (m = -inf) adds nothing, a row with none at
// all gives zeros.  One CTA a (row, head), a thread a column.
__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(const float* __restrict__ ws, float* __restrict__ out,
                   int batch, int heads, int head_dim, int split) {
  const size_t bh = blockIdx.x;
  const size_t n = static_cast<size_t>(batch) * heads * split;
  const float* acc = ws + bh * split * head_dim;
  const float* m = ws + n * head_dim + bh * split;
  const float* l = m + n;
  float mx = -INFINITY;
  for (int s = 0; s < split; ++s) mx = fmaxf(mx, m[s]);
  float sum = 0.f;
  for (int s = 0; s < split; ++s)
    if (m[s] != -INFINITY) sum += l[s] * expf(m[s] - mx);
  const float den = sum == 0.f ? 1.f : sum;
  for (int d = threadIdx.x; d < head_dim; d += kThreads) {
    float o = 0.f;
    for (int s = 0; s < split; ++s)
      if (m[s] != -INFINITY) o += acc[s * head_dim + d] * expf(m[s] - mx);
    out[bh * head_dim + d] = o / den;
  }
}

// Bytes of each cp.async copy: the widest of 16, 8, 4 that divides a
// head's bytes and both pool bases, else 1 (plain byte loads).
int copy_bytes(const void* k_pool, const void* v_pool, int head_bytes) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(k_pool) |
                          reinterpret_cast<uintptr_t>(v_pool);
  for (int cb = 16; cb >= 4; cb >>= 1)
    if (head_bytes % cb == 0 && bases % cb == 0) return cb;
  return 1;
}

template <typename T, int VE, bool kQuant>
cudaError_t launch_kernel(const Args& a, cudaStream_t stream) {
  const Layout L = make_layout(a.head_dim, a.tile, a.blocks_per_split,
                               sizeof(T), VE, kQuant);
  auto kernel = paged_decode_kernel<T, VE, kQuant>;
  // the opt-in past 48 KB, set once a card and size (a host call)
  static size_t opted[kMaxCards];
  int card = 0;
  cudaError_t e = cudaGetDevice(&card);
  if (e != cudaSuccess) return e;
  if (L.bytes > 48 * 1024 &&
      (card >= kMaxCards || L.bytes > opted[card])) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L.bytes));
    if (e != cudaSuccess) return e;
    if (card < kMaxCards) opted[card] = L.bytes;
  }
  const dim3 grid(a.heads, a.batch, a.split);
  kernel<<<grid, kThreads, L.bytes, stream>>>(a);
  return cudaGetLastError();
}

int launch(Args a, bool quant, void* stream_ptr) {
  if (a.batch <= 0 || a.heads <= 0 || a.head_dim <= 0 ||
      a.block_size <= 0 || a.max_blocks <= 0 || a.tile <= 0 ||
      a.split <= 0 || a.blocks_per_split <= 0 ||
      static_cast<long long>(a.split) * a.blocks_per_split < a.max_blocks ||
      a.batch > 65535 || a.split > 65535 ||
      (a.split > 1 && a.ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int d = a.head_dim;
  a.copy_bytes = copy_bytes(a.k_pool, a.v_pool, d * (quant ? 1 : 4));
  cudaError_t e;
  if (!quant)
    e = d % 4 == 0 ? launch_kernel<float, 4, false>(a, stream)
                   : launch_kernel<float, 1, false>(a, stream);
  else
    e = d % 16 == 0  ? launch_kernel<int8_t, 16, true>(a, stream)
        : d % 4 == 0 ? launch_kernel<int8_t, 4, true>(a, stream)
                     : launch_kernel<int8_t, 1, true>(a, stream);
  if (e != cudaSuccess || a.split == 1) return static_cast<int>(e);
  paged_merge_kernel<<<a.batch * a.heads, kThreads, 0, stream>>>(
      a.ws, a.out, a.batch, a.heads, a.head_dim, a.split);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const float* q, const void* k_pool, const void* v_pool,
               const int* page_table, const int* lengths,
               const float* k_scales, const float* v_scales, float* out,
               float* ws, int batch, int heads, int head_dim,
               int block_size, int max_blocks, int split,
               int blocks_per_split, int tile, float scale) {
  Args a;
  a.q = q;
  a.k_pool = static_cast<const unsigned char*>(k_pool);
  a.v_pool = static_cast<const unsigned char*>(v_pool);
  a.table = page_table;
  a.lengths = lengths;
  a.k_scales = k_scales;
  a.v_scales = v_scales;
  a.out = out;
  a.ws = ws;
  a.batch = batch;
  a.heads = heads;
  a.head_dim = head_dim;
  a.block_size = block_size;
  a.max_blocks = max_blocks;
  a.split = split;
  a.blocks_per_split = blocks_per_split;
  a.tile = tile;
  a.copy_bytes = 4;
  a.scale = scale;
  return a;
}

}  // namespace

extern "C" {

// One K1 call with the plan (split, blocks_per_split, tile) of
// paged_attention_plan; `ws` holds split x (D + 2) floats a (row, head)
// when split > 1 (then the merge kernel launches too), else may be null.
int vt_paged_attention_f32(const float* q, const float* k_pool,
                           const float* v_pool, const int* page_table,
                           const int* lengths, float* out, float* ws,
                           int batch, int heads, int head_dim,
                           int block_size, int max_blocks, int split,
                           int blocks_per_split, int tile, float scale,
                           void* stream) {
  return launch(make_args(q, k_pool, v_pool, page_table, lengths, nullptr,
                          nullptr, out, ws, batch, heads, head_dim,
                          block_size, max_blocks, split, blocks_per_split,
                          tile, scale),
                false, stream);
}

// The same over int8 pools with per-(block, head) f32 scales (K2).
int vt_paged_attention_int8(const float* q, const int8_t* k_pool,
                            const int8_t* v_pool, const int* page_table,
                            const int* lengths, const float* k_scales,
                            const float* v_scales, float* out, float* ws,
                            int batch, int heads, int head_dim,
                            int block_size, int max_blocks, int split,
                            int blocks_per_split, int tile, float scale,
                            void* stream) {
  return launch(make_args(q, k_pool, v_pool, page_table, lengths, k_scales,
                          v_scales, out, ws, batch, heads, head_dim,
                          block_size, max_blocks, split, blocks_per_split,
                          tile, scale),
                true, stream);
}

const char* vt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
