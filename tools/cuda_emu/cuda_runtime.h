// A CPU stand-in for the CUDA runtime, to run a kernel's index math and
// arithmetic without a card (tools/cuda_emu/check.py builds the port's
// csrc/*.cu against it with g++): one std::thread a CUDA thread, the
// blocks of a grid one after another, __syncthreads and __syncwarp as
// std::barriers, shuffles and ballots through a per-warp exchange,
// mma.sync.m16n8k8 (TF32) as a warp rendezvous summing in double, and
// cp.async as a synchronous copy with its zero fill.  Shared memory
// starts as 0xff bytes (NaN floats), so a read of an unwritten word
// shows.  It says nothing of speed, and IEEE f32 on the host is the
// card's (rintf, "/", fmaxf), so bitwise results carry over; the tensor
// cores' own summation order does not.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
#include <type_traits>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int bytes) {
  return bytes > 232448 ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t& emu_last_error() { static cudaError_t e = cudaSuccess; return e; }
inline cudaError_t cudaGetLastError() { auto e = emu_last_error(); emu_last_error() = cudaSuccess; return e; }
inline const char* cudaGetErrorString(cudaError_t e) { return e ? "emulated error" : "no error"; }

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

namespace emu {
struct Block {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<uint64_t> xch;
  std::vector<float> ma, mb, mc;
  std::vector<char> smem;
};
inline Block* cur = nullptr;
inline char* dyn_smem() { return cur->smem.data(); }
inline unsigned tid() { return threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z); }
inline std::barrier<>& warp_bar() { return *cur->warps[tid() / 32]; }

template <typename F, typename G, typename B>
void launch(F f, G grid_, B block_, size_t smem = 0, cudaStream_t = nullptr) {
  dim3 grid(grid_), block(block_);
  const unsigned nt = block.x * block.y * block.z;
  if (nt > 1024 || nt % 32 || smem > 232448 || grid.y > 65535 || grid.z > 65535) {
    emu_last_error() = cudaErrorInvalidValue;
    return;
  }
  gridDim = grid;
  blockDim = block;
  Block b;
  b.bar = std::make_unique<std::barrier<>>(nt);
  for (unsigned w = 0; w < nt / 32; ++w) b.warps.push_back(std::make_unique<std::barrier<>>(32));
  b.xch.resize(nt);
  b.ma.resize(nt * 4); b.mb.resize(nt * 2); b.mc.resize(nt * 4);
  b.smem.assign(smem + 16, (char)0xff);  // NaN floats: reads of unwritten data show
  cur = &b;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::fill(b.smem.begin(), b.smem.end(), (char)0xff);
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < nt; ++t)
          ts.emplace_back([&, t] {
            threadIdx = dim3(t % block.x, (t / block.x) % block.y, t / (block.x * block.y));
            blockIdx = dim3(bx, by, bz);
            f();
          });
        for (auto& t : ts) t.join();
      }
  cur = nullptr;
}
}  // namespace emu

inline void __syncthreads() { emu::cur->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu::warp_bar().arrive_and_wait(); }

template <typename T>
inline T emu_exchange(T v, int src_lane) {
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  const unsigned t = emu::tid(), base = t & ~31u;
  emu::cur->xch[t] = bits;
  emu::warp_bar().arrive_and_wait();
  const uint64_t got = emu::cur->xch[base + (unsigned)src_lane];
  emu::warp_bar().arrive_and_wait();
  T out;
  std::memcpy(&out, &got, sizeof(T));
  return out;
}
template <typename T>
inline T __shfl_sync(unsigned, T v, int src, int = 32) { return emu_exchange(v, src & 31); }
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int m, int = 32) { return emu_exchange(v, (int)(emu::tid() & 31) ^ m); }
template <typename T>
inline T __shfl_up_sync(unsigned, T v, unsigned d, int = 32) {
  const int lane = emu::tid() & 31;
  return emu_exchange(v, lane >= (int)d ? lane - (int)d : lane);
}
template <typename T>
inline T __shfl_down_sync(unsigned, T v, unsigned d, int = 32) {
  const int lane = emu::tid() & 31;
  return emu_exchange(v, lane + (int)d < 32 ? lane + (int)d : lane);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  const unsigned t = emu::tid(), base = t & ~31u;
  emu::cur->xch[t] = pred ? 1 : 0;
  emu::warp_bar().arrive_and_wait();
  unsigned m = 0;
  for (unsigned i = 0; i < 32; ++i) m |= (emu::cur->xch[base + i] ? 1u : 0u) << i;
  emu::warp_bar().arrive_and_wait();
  return m;
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
template <typename T> inline T __ldg(const T* p) { return *p; }
using std::min;
using std::max;

// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, warp-wide
inline void emu_mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  const unsigned t = emu::tid(), base = t & ~31u;
  for (int i = 0; i < 4; ++i) { emu::cur->ma[t * 4 + i] = __uint_as_float(a[i]); emu::cur->mc[t * 4 + i] = d[i]; }
  for (int i = 0; i < 2; ++i) emu::cur->mb[t * 2 + i] = __uint_as_float(b[i]);
  emu::warp_bar().arrive_and_wait();
  auto A = [&](int r, int k) {  // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
    const unsigned l = base + (r % 8) * 4 + (k % 4);
    return emu::cur->ma[l * 4 + (r >= 8 ? 1 : 0) + (k >= 4 ? 2 : 0)];
  };
  auto Bm = [&](int k, int n) {  // b0 (k = t, n = g), b1 (k = t + 4, n = g)
    const unsigned l = base + n * 4 + (k % 4);
    return emu::cur->mb[l * 2 + (k >= 4 ? 1 : 0)];
  };
  const int lane = t & 31, g = lane >> 2, tg = lane & 3;
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i >> 1), n = 2 * tg + (i & 1);
    double acc = 0;
    for (int k = 0; k < 8; ++k) acc += (double)A(r, k) * (double)Bm(k, n);
    out[i] = (float)((double)emu::cur->mc[t * 4 + i] + acc);
  }
  emu::warp_bar().arrive_and_wait();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}
inline void emu_cp(float* dst, const float* src, int bytes, int size) {
  std::memcpy(dst, src, bytes);
  std::memset(reinterpret_cast<char*>(dst) + bytes, 0, size - bytes);
}
inline unsigned atomicOr(unsigned* p, unsigned v) { return std::atomic_ref<unsigned>(*p).fetch_or(v); }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
