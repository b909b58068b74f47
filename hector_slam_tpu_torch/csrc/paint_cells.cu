// Scatter-store of 1 into zeroed byte grids at lists of flat cell indices,
// for Hopper (sm_90a): the map update's scatter-OR, every cell set of one
// update in one launch.
//
// Replaces the Pallas TPU probe tools/probe_mosaic_store.py:
// probe_scalar_store (kernel make_store_kernel, :28-41), which zeroes a
// grid and stores 1 at every listed (y, x). That store is the map update's
// _scatter_true (hector_slam_tpu/core/mapping.py:155-160), which the JAX
// package left to XLA's scatter because Mosaic could not lower per-cell
// stores. On the card a per-cell byte store is the natural primitive.
//
// Per index i of set s:
//   c = (unsigned) idx_s[i];  if (c < num_cells_s) grid_s[c] = 1;
// (for a set that reads first: ... if (c < num_cells_s && !grid_s[c]) ...)
// The unsigned compare drops every index outside [0, num_cells): the map
// update's sentinel (== num_cells) and, unlike PyTorch's index_put_, any
// negative index. The wrapper zeroes all the grids with one fill before
// the launch. Duplicate indices store the same byte, so the result does
// not depend on the order of the stores: no atomics, and repeated launches
// are bit-identical.
//
// What bounds it on the card: bytes. It reads 4 bytes per index and
// writes at most one byte per painted cell, with no arithmetic to speak
// of. What stands between a launch and that bound, and what the design
// does about it:
//   - A map update paints 2 x levels sets, most of them small (one scan's
//     occupied set is 1,152 indices, ~5 KB), so a set on its own costs a
//     kernel launch, not work. A launch takes a table of up to kMaxSets
//     sets by value (a __grid_constant__ struct), and its blocks are dealt
//     to the sets in proportion to their lengths: one launch and one fill
//     per map update.
//   - On the large sets (a 64-robot fleet's level-0 free set is 47.8 M
//     indices, 191 MB) one 4-byte load per thread keeps ~8 KB in flight
//     per SM, where ~15 KB are needed to keep 3.35 TB/s busy. Each thread
//     issues kUnroll 16-byte int4 loads (16 indices) before its first
//     store, from a persistent grid of kBlocksPerSm blocks per SM. A set
//     whose pointer is not 16-byte aligned, or whose length is not a
//     multiple of 4, paints its head and tail (at most 3 indices each)
//     with scalar loads.
//   - Where many slots name few cells, the stores contend: 64 robots
//     painting one shared grid write a cell near the robots thousands of
//     times per update, and same-cell stores from many SMs serialize in
//     L2 (2-4x the time per index of per-robot grids). A set with at least
//     kReadFirstSlotsPerCell slots per cell (the shared fleet's free sets:
//     45-189; one scan's sets and per-robot grids: at most 3) loads each
//     cell's byte first and stores only where it is still 0. Its grid is
//     small enough to sit in L2, so the load is cheap; on a large,
//     sparsely hit grid each load would cost a sector read from memory,
//     so other sets store blindly. A stale 0 (another SM's store not seen
//     yet) only costs a store, so the result is the same either way.
// The stores scatter, but neighbouring indices of a Bresenham ray are
// neighbouring or one row apart, so they land in few 32-byte sectors,
// mostly in L2. 98.7% of a fleet's level-0 slots are the sentinel: the
// dense [N, K] index layout, not this kernel, decides that.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;        // int4 loads in flight per thread
constexpr int kBlocksPerSm = 8;   // 2,048 threads per SM
constexpr int kMaxSets = 8;
// a set with this many index slots per cell or more reads before it
// writes (see the header)
constexpr long long kReadFirstSlotsPerCell = 16;
constexpr long long kIndicesPerBlockTrip =
    static_cast<long long>(kThreads) * kUnroll * 4;

struct PaintSet {
  const int* idx;           // n indices
  unsigned char* grid;      // num_cells bytes, zeroed
  long long n;
  long long head;           // scalar indices before the first 16-byte line
  unsigned int num_cells;
  int first_block;          // the set's first block of the launch
  int blocks;               // its number of blocks
  int read_first;           // load each cell before storing it
};

struct PaintTable {
  PaintSet set[kMaxSets];
  int count;
};

template <bool kReadFirst>
__device__ __forceinline__ void paint(unsigned char* grid,
                                      unsigned int num_cells, int v) {
  const unsigned int c = static_cast<unsigned int>(v);
  if (c < num_cells && (!kReadFirst || grid[c] == 0)) grid[c] = 1;
}

template <bool kReadFirst>
__device__ void paint_set(const PaintSet& p, long long tid,
                          long long threads) {
  const long long nvec = (p.n - p.head) >> 2;
  const long long tail = p.head + (nvec << 2);
  if (tid < p.head) {
    paint<kReadFirst>(p.grid, p.num_cells, __ldg(p.idx + tid));
  }
  if (tid < p.n - tail) {
    paint<kReadFirst>(p.grid, p.num_cells, __ldg(p.idx + tail + tid));
  }
  const int4* vec = reinterpret_cast<const int4*>(p.idx + p.head);
  for (long long i = tid; i < nvec; i += kUnroll * threads) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * threads;
      v[u] = j < nvec ? __ldg(vec + j) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      paint<kReadFirst>(p.grid, p.num_cells, v[u].x);
      paint<kReadFirst>(p.grid, p.num_cells, v[u].y);
      paint<kReadFirst>(p.grid, p.num_cells, v[u].z);
      paint<kReadFirst>(p.grid, p.num_cells, v[u].w);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
paint_cell_sets_kernel(const __grid_constant__ PaintTable t) {
  int s = 0;
  while (s + 1 < t.count &&
         static_cast<int>(blockIdx.x) >= t.set[s + 1].first_block) {
    ++s;
  }
  const PaintSet& p = t.set[s];
  const long long tid =
      static_cast<long long>(blockIdx.x - p.first_block) * kThreads +
      threadIdx.x;
  const long long threads = static_cast<long long>(p.blocks) * kThreads;
  if (p.read_first) {
    paint_set<true>(p, tid, threads);
  } else {
    paint_set<false>(p, tid, threads);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): paints `count` (1..kMaxSets)
// sets, set k's n[k] indices at idx[k] into the num_cells[k] bytes at
// grid[k], in one launch on `stream`. Does not synchronise; returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for a bad
// count). Empty sets get no block; if every set is empty nothing is
// launched.
extern "C" int hs_paint_cell_sets(int count, const void* const* idx,
                                  const long long* n, void* const* grid,
                                  const unsigned int* num_cells,
                                  void* stream) {
  if (count < 1 || count > kMaxSets) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long total = 0;
  for (int k = 0; k < count; ++k) total += n[k] > 0 ? n[k] : 0;
  if (total == 0) return 0;
  // the persistent grid: as many blocks as the work fills, at most
  // kBlocksPerSm per SM, dealt to the sets in proportion to their lengths
  long long budget = (total + kIndicesPerBlockTrip - 1) / kIndicesPerBlockTrip;
  const long long cap = static_cast<long long>(sms > 0 ? sms : 132) *
                        kBlocksPerSm;
  if (budget > cap) budget = cap;
  PaintTable t{};
  int blocks = 0;
  for (int k = 0; k < count; ++k) {
    if (n[k] <= 0) continue;
    const long long need =
        (n[k] + kIndicesPerBlockTrip - 1) / kIndicesPerBlockTrip;
    long long share = (budget * n[k] + total - 1) / total;
    if (share > need) share = need;
    if (share < 1) share = 1;
    PaintSet& p = t.set[t.count++];
    p.idx = static_cast<const int*>(idx[k]);
    p.grid = static_cast<unsigned char*>(grid[k]);
    p.n = n[k];
    const long long misalign =
        static_cast<long long>(reinterpret_cast<unsigned long long>(idx[k]) &
                               15ULL);
    p.head = misalign ? (16 - misalign) / 4 : 0;
    if (p.head > p.n) p.head = p.n;
    p.num_cells = num_cells[k];
    p.read_first = n[k] >= kReadFirstSlotsPerCell *
                               static_cast<long long>(num_cells[k]);
    p.first_block = blocks;
    p.blocks = static_cast<int>(share);
    blocks += p.blocks;
  }
  paint_cell_sets_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
