// Chained take-along-axis over the tiles of a resident operand, for Hopper
// (sm_90a): the gather cost probe.
//
// Replaces two Pallas TPU probes of tools/probe_pallas.py, which compute
// one function: gather_tiles (call :86, kernel :73-84) over T static
// [th, tw] tiles, and gather_big (call :116, kernel :106-114), which is
// gather_tiles with one tile (tile_rows = p.shape[0]). With
// mod = (axis == 1 ? tw : th), acc = 0 and, for rep i = 0 .. reps-1,
// element (r, c) of tile t:
//   ix  = (idx[t][r][c] + i) mod mod
//   (s) = (r, ix) on axis 1, (ix, c) on axis 0
//   acc[t][r][c] += p[t][s] + acc[0][s] * 1e-30
// where acc[0] is the FIRST tile's accumulator of rep i-1 (the probe adds
// acc[:th] to every tile). The f32 expression order is the probe's, and
// -fmad=false keeps the product and the add apart, so the result is the
// plain version's bit for bit.
//
// The loop-carried dependency crosses elements: every tile reads tile 0's
// accumulator at gathered positions, so rep i of any tile needs all of
// tile 0's rep i-1. It is what the probe measures, so it is kept, not
// hoisted. Design: one block per tile, and every block recomputes tile
// 0's chain itself, which depends on nothing else. Tile 0's accumulator
// lives in shared memory, double-buffered (read rep i-1, write rep i), so
// one __syncthreads per rep orders the chain; the block's own tile's
// accumulator stays in registers (only its own thread reads it). This
// needs no grid-wide barrier (a cooperative launch with one grid sync per
// rep), at the price of twice the arithmetic in blocks t > 0. The 64-tile
// probe runs 64 blocks; a one-tile operand (gather_big, at most 32 KB)
// runs one block.
//
// What bounds it on the card: neither bytes nor operations, but the
// latency of one rep (shared-memory gathers, then a block barrier) times
// the number of reps; the work per rep is a few thousand elements. The
// bound the repo reports is 3 f32 operations per element per rep over the
// f32 peak, and the operand, indices and output moved once.
//
// Shared memory: tile 0 of p, this block's tile of p, and the two
// accumulator buffers: 16 bytes per tile element, 128 KB at the largest
// tile (8192 elements), above the 48 KB default, hence the attribute.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxPerThread = 8;   // tile elements per thread
constexpr int kMaxTile = kMaxThreads * kMaxPerThread;
constexpr float kTiny = 1e-30f;

__device__ __forceinline__ int floor_mod(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

__global__ void __launch_bounds__(kMaxThreads)
take_along_kernel(const float* __restrict__ p, const int* __restrict__ idx,
                  float* __restrict__ out, int th, int tw, int reps,
                  int axis) {
  extern __shared__ float smem[];
  const int n = th * tw;
  const int t = blockIdx.x;
  const bool own = t != 0;   // block 0's own tile is tile 0
  float* p0 = smem;
  float* pt = smem + n;
  float* acc0 = smem + 2 * n;   // two buffers of n
  const float* p_t = p + static_cast<long long>(t) * n;
  const int* idx_t = idx + static_cast<long long>(t) * n;
  const int mod = axis == 1 ? tw : th;
  const int stride = axis == 1 ? 1 : tw;

  int base[kMaxPerThread], ix0[kMaxPerThread], ixt[kMaxPerThread];
  float acct[kMaxPerThread];
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    base[k] = 0;
    ix0[k] = 0;
    ixt[k] = 0;
    acct[k] = 0.f;
    if (e < n) {
      const int r = e / tw, c = e - r * tw;
      base[k] = axis == 1 ? r * tw : c;
      ix0[k] = floor_mod(idx[e], mod);
      ixt[k] = floor_mod(idx_t[e], mod);
      p0[e] = p[e];
      pt[e] = p_t[e];
      acc0[e] = 0.f;
    }
  }
  __syncthreads();

  for (int i = 0; i < reps; ++i) {
    const float* cur = acc0 + (i & 1) * n;
    float* nxt = acc0 + ((i + 1) & 1) * n;
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int e = threadIdx.x + k * blockDim.x;
      if (e < n) {
        const int s0 = base[k] + ix0[k] * stride;
        nxt[e] = cur[e] + (p0[s0] + cur[s0] * kTiny);
        if (own) {
          const int st = base[k] + ixt[k] * stride;
          acct[k] = acct[k] + (pt[st] + cur[st] * kTiny);
        }
        // (idx + i + 1) mod mod, stepped from rep i's value
        ix0[k] = ix0[k] + 1 == mod ? 0 : ix0[k] + 1;
        ixt[k] = ixt[k] + 1 == mod ? 0 : ixt[k] + 1;
      }
    }
    __syncthreads();
  }

  const float* fin = acc0 + (reps & 1) * n;
  float* out_t = out + static_cast<long long>(t) * n;
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    if (e < n) out_t[e] = own ? acct[k] : fin[e];
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). p, idx, out: [tiles * th, tw]
// row-major; th * tw <= 8192. Launches on `stream` and does not
// synchronise; returns the CUDA error of the set-up or the launch.
extern "C" int hs_take_along(const void* p, const void* idx, void* out,
                             int tiles, int th, int tw, int reps, int axis,
                             void* stream) {
  const int n = th * tw;
  if (tiles <= 0 || n <= 0) return 0;
  if (n > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 4 * n * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      take_along_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = n < kMaxThreads ? n : kMaxThreads;
  threads = (threads + 31) / 32 * 32;
  take_along_kernel<<<tiles, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const int*>(idx),
      static_cast<float*>(out), th, tw, reps, axis);
  return static_cast<int>(cudaGetLastError());
}
