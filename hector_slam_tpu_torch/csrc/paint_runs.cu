// Run painting into a zeroed f32 grid, for Hopper (sm_90a): the
// run-store cost probe.
//
// Replaces the Pallas TPU probe tools/probe_mosaic_store.py:
// probe_run_store (call :112, kernel make_run_kernel :78-96), design B of
// that probe: per run, a masked read-modify-write of the aligned [1, 128]
// row segment at (row, c0) that sets lanes lo..hi to 1.0. Here:
//   grid[row][c0 + lo .. c0 + hi] = 1.0f
// for every run, one thread per run (grid-stride loop), into a grid the
// wrapper zeroes. Every store writes the same value, so overlapping runs
// need no atomics and the result does not depend on the order of the
// stores: it is exact and repeated launches are bit-identical. The wrapper
// checks the TPU kernel's precondition on the host (c0 a multiple of 128,
// 0 <= lo <= hi < 128, the segment inside the grid), so the kernel never
// stores outside it.
//
// What bounds it on the card: bytes. 16 bytes of run per thread, read
// coalesced, and 4 bytes per painted cell, stored to neighbouring
// addresses of one row (one or two 32-byte sectors per run); the grid's
// zero fill, 4 MB at the probe's 1024^2, dwarfs the 16,384 runs' stores.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 blocks per SM

__global__ void __launch_bounds__(kThreads)
paint_runs_kernel(const int* __restrict__ rows, const int* __restrict__ c0,
                  const int* __restrict__ lo, const int* __restrict__ hi,
                  int n, float* __restrict__ grid, int width) {
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    float* seg = grid + static_cast<long long>(__ldg(rows + i)) * width +
                 __ldg(c0 + i);
    const int end = __ldg(hi + i);
    for (int l = __ldg(lo + i); l <= end; ++l) seg[l] = 1.0f;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). rows, c0, lo, hi: i32[n];
// grid: f32[height, width] row-major, zeroed by the caller. Launches on
// `stream` and does not synchronise; returns cudaGetLastError() of the
// launch.
extern "C" int hs_paint_runs(const void* rows, const void* c0, const void* lo,
                             const void* hi, int n, void* grid, int width,
                             void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  paint_runs_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), static_cast<const int*>(c0),
      static_cast<const int*>(lo), static_cast<const int*>(hi), n,
      static_cast<float*>(grid), width);
  return static_cast<int>(cudaGetLastError());
}
