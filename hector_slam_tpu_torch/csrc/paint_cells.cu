// Scatter-store of 1 into a zeroed byte grid at a list of flat cell
// indices, for Hopper (sm_90a): the map update's scatter-OR.
//
// Replaces the Pallas TPU probe tools/probe_mosaic_store.py:
// probe_scalar_store (kernel make_store_kernel, :28-41), which zeroes a
// grid and stores 1 at every listed (y, x). That store is the map update's
// _scatter_true (hector_slam_tpu/core/mapping.py:155-160), which the JAX
// package left to XLA's scatter because Mosaic could not lower per-cell
// stores. On the card a per-cell byte store is the natural primitive.
//
// Per index i (one thread each, grid-stride loop):
//   c = (unsigned) idx[i];  if (c < num_cells) grid[c] = 1;
// The unsigned compare drops every index outside [0, num_cells): the map
// update's sentinel (== num_cells) and, unlike PyTorch's index_put_, any
// negative index. The wrapper zeroes the grid (torch.zeros) before the
// launch. Duplicate indices store the same byte, so the result does not
// depend on the order of the stores: no atomics, and repeated launches are
// bit-identical.
//
// What bounds it on the card: bytes. It reads 4 bytes per index and
// writes at most one byte per painted cell, with no arithmetic to speak
// of. The index reads are coalesced (neighbouring threads read
// neighbouring indices); the stores scatter, but neighbouring indices of a
// Bresenham ray are neighbouring or one row apart, so they land in few
// 32-byte sectors, mostly in L2 (a 1024^2 grid is 1 MB). A fused kernel
// that generates the closed-form Bresenham cells itself, with no index
// tensor in device memory, is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;   // 16 blocks per SM

__global__ void __launch_bounds__(kThreads)
paint_cells_kernel(const int* __restrict__ idx, long long n,
                   unsigned char* __restrict__ grid, unsigned int num_cells) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const unsigned int c = static_cast<unsigned int>(__ldg(idx + i));
    if (c < num_cells) grid[c] = 1;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream` and does
// not synchronise; returns cudaGetLastError() of the launch.
extern "C" int hs_paint_cells(const void* idx, long long n, void* grid,
                              unsigned int num_cells, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  paint_cells_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), n, static_cast<unsigned char*>(grid),
      num_cells);
  return static_cast<int>(cudaGetLastError());
}
