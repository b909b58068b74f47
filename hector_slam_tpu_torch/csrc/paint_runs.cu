// Run painting into an f32 grid it zeroes itself, for Hopper (sm_90a): the
// run-store cost probe.
//
// Replaces the Pallas TPU probe tools/probe_mosaic_store.py:
// probe_run_store (call :112, kernel make_run_kernel :78-96), design B of
// that probe: per run, a masked read-modify-write of the aligned [1, 128]
// row segment at (row, c0) that sets lanes lo..hi to 1.0, into a zeroed
// grid. Here, in one launch:
//   grid[:, :] = 0.0f;  then  grid[row][c0 + lo .. c0 + hi] = 1.0f
// for every run. Every paint store writes the same value, so overlapping
// runs need no atomics and the result does not depend on the order of the
// stores: it is exact and repeated launches are bit-identical. The wrapper
// checks the TPU kernel's precondition on the host (c0 a multiple of 128,
// 0 <= lo <= hi < 128, the segment inside the grid), so the kernel never
// stores outside it.
//
// What bounds it on the card: bytes. The grid written once (4 MB at the
// probe's 1024^2) and 16 bytes of run read per run: 1.33 us at 3.35 TB/s.
// Time beyond that is fixed cost: the parent design, a torch.zeros fill
// and a one-thread-per-run paint kernel, read 3.04 us for the fill alone,
// 3.60-3.85 us for the paint alone and 6.45-6.49 us for the pair (NVIDIA
// H100 80GB HBM3, 700 W; probes.store_split): two launches' ramp and
// drain, not bytes.
//
// Design: one cooperative launch (every block resident, one 1024-thread
// block an SM), two phases and one grid-wide barrier. Phase 1: the blocks
// zero the grid in a grid-stride loop of 16-byte stores. Barrier
// (cooperative_groups' grid sync: no run may be painted before its cells
// are zeroed). Phase 2: each block paints a contiguous share of the runs,
// one thread a run; the stores land in lines phase 1 just wrote, in L2.
// Each run is read and painted once, so the cost grows with the runs, not
// with runs x blocks. probes.store_split times the launch with its
// barrier alone (a 1 x 4 grid, no runs), with the fill (no runs) and
// whole.
//
// The other designs:
//  * Row bands, one plain launch with no grid barrier: block b zeroes a
//    band of whole rows and paints only the runs in its band. Every block
//    then scans the rows of all n runs, trading the barrier for
//    n x blocks reads, and grows dearer as runs grow. Timed while
//    choosing, it read no faster; not kept.
//  * Not built: run masks OR-ed into a 128 KB table with atomics, then
//    expanded so that every cell is written once. The table has to be
//    zeroed before the atomics, so one stateless launch needs two grid
//    barriers, more than the partial writes it would save (a run's up to
//    8 cells, ~73 K of the 1 M cells at the probe, into lines already in
//    L2).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;

// grid[lo .. hi) = 0 by threads t, t + stride, ...: single cells up to a
// 4-cell boundary (the grid is 16-byte aligned), 16-byte stores, a tail
__device__ __forceinline__ void zero_cells(float* grid, long long lo,
                                           long long hi, long long t,
                                           long long stride) {
  const long long b = min(hi, (lo + 3) & ~3LL);
  const long long e = max(b, hi & ~3LL);
  for (long long i = lo + t; i < b; i += stride) grid[i] = 0.f;
  float4* g4 = reinterpret_cast<float4*>(grid);
  for (long long i = b / 4 + t; i < e / 4; i += stride) {
    g4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (long long i = e + t; i < hi; i += stride) grid[i] = 0.f;
}

__device__ __forceinline__ void paint_run(const int* __restrict__ c0,
                                          const int* __restrict__ lo,
                                          const int* __restrict__ hi, int i,
                                          int row, float* grid, int width) {
  float* seg = grid + static_cast<long long>(row) * width + __ldg(c0 + i);
  const int end = __ldg(hi + i);
  for (int l = __ldg(lo + i); l <= end; ++l) seg[l] = 1.0f;
}

__global__ void __launch_bounds__(kThreads)
paint_runs_kernel(const int* __restrict__ rows, const int* __restrict__ c0,
                  const int* __restrict__ lo, const int* __restrict__ hi,
                  int n, float* __restrict__ grid, int height, int width) {
  zero_cells(grid, 0, static_cast<long long>(height) * width,
             static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x,
             static_cast<long long>(gridDim.x) * kThreads);
  cg::this_grid().sync();
  const int share = (n + gridDim.x - 1) / gridDim.x;
  const int last = min(n, (blockIdx.x + 1) * share);
  for (int i = blockIdx.x * share + threadIdx.x; i < last; i += kThreads) {
    paint_run(c0, lo, hi, i, __ldg(rows + i), grid, width);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). rows, c0, lo, hi: i32[n];
// grid: f32[height, width] row-major, 16-byte aligned, written in full
// (its contents on entry do not matter). Launches on `stream` and does not
// synchronise; returns the CUDA error of the set-up or the launch.
extern "C" int hs_paint_runs(const void* rows, const void* c0, const void* lo,
                             const void* hi, int n, void* grid, int height,
                             int width, void* stream) {
  if (height <= 0 || width <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* rows_p = static_cast<const int*>(rows);
  auto* c0_p = static_cast<const int*>(c0);
  auto* lo_p = static_cast<const int*>(lo);
  auto* hi_p = static_cast<const int*>(hi);
  auto* grid_p = static_cast<float*>(grid);
  // one block an SM: the runtime refuses the cooperative launch unless
  // every block is resident at once
  void* args[] = {&rows_p, &c0_p, &lo_p, &hi_p, &n, &grid_p, &height,
                  &width};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(paint_runs_kernel),
      dim3(static_cast<unsigned>(sms)), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
