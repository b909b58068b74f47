// The map update's dense tail, in place, for Hopper (sm_90a): the painted
// free and occupied cell sets applied to the levels' storage, and the
// matcher's neighbour quads packed anew, only for the maps whose gate
// fired. Two launches an update, each for every level of the pyramid.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA
// (hector_slam_tpu/core/cell_models.py: apply_update, the gate's select
// in core/slam.py and parallel/batch.py, core/interp.py: quad_pack).
// In PyTorch ops it is a dozen whole-map passes per level (the update's
// `&`, `where` and `+`, the gate's `where`, the probability grid, three
// `roll`s, the `stack` of the quads, the copy back into the donated
// state) that run on every map on every step, gated or not: a robot
// moves past the gate on ~13% of its scans, and ~87% of those passes
// rewrite a map with the bits it had.
//
// Pass A (update_kernel), per cell i of a gated map, storage s:
//   log_odds:     s' = (s + (free_only ? lf : 0)) + (occ && s < 50 ? lo : 0)
//   simple_count: s' = (s + (free_only && s > free_limit ? free : 0))
//                      + (occ && s < occ_limit ? occupied : 0)
//   reflectance:  visited' = (visited + free_only) + occ;
//                 reflected' = reflected + occ
// with free_only = free && !occ (occupied wins), in apply_update's order
// of operations: the zeros are added too, since s + 0 turns -0.0 into
// +0.0. A cell is stored only where its bits change, which leaves the
// same bits as storing it.
// Pass B (repack_kernel), per cell (y, x) of a gated map:
//   quad = (P(y, x), P(y, x+1), P(y+1, x), P(y+1, x+1)), indices wrapping
//   at the map's edge as quad_pack's rolls do, with
//   P = exp(s) / (exp(s) + 1) (log_odds; expf, IEEE division),
//   s (simple_count), visited > 0 ? reflected / max(visited, 1) : 0.5
//   (reflectance).
// Pass B reads the neighbours that pass A writes, so the two are two
// launches in stream order. A block first reads its map's gate (one gate
// for every map, or one a map) and returns if it is false: an ungated map
// costs its blocks' gate reads.
//
// What bounds it on the card: bytes. A gated cell reads 4 bytes of
// storage and 2 of cell sets and writes 4 where it changes (pass A), then
// reads 4 and writes a 16-byte quad (pass B); the arithmetic is an add
// or two, or an expf and a division. The design:
//   - Pass A: each thread issues its 16 cells' loads (storage, both sets)
//     before its first store; neighbouring threads read neighbouring
//     cells.
//   - Pass B: a warp packs 32 neighbouring columns down 16 rows, so each
//     thread computes P once a cell (the row below it becomes the next
//     row's top) and takes its right neighbour's from the next lane with a
//     shuffle; only lane 31 and the map's last column compute a
//     neighbour's P themselves. A warp stores 512 contiguous bytes a row.
//   - Both read the gate first, so an ungated map costs no storage read;
//     one launch a pass covers every level (a table of up to kMaxLevels
//     levels by value) and every map (the grid's y).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 8;
constexpr int kUpdateCells = 16;   // cells per thread, pass A
constexpr long long kUpdateTile =
    static_cast<long long>(kThreads) * kUpdateCells;
constexpr int kRepackCols = kThreads;   // a warp per 32 columns
constexpr int kRepackRows = 16;

enum Model { kLogOdds = 0, kSimpleCount = 1, kReflectance = 2 };

struct TailLevel {
  float* storage;                  // maps x channels x cells
  float4* quads;                   // maps x cells
  const unsigned char* free_set;   // maps x cells
  const unsigned char* occ_set;    // maps x cells
  int height;
  int width;
  int first_tile;                  // the level's first block (x) of the launch
  int tiles_x;                     // pass B: tiles across a row
};

struct TailTable {
  TailLevel level[kMaxLevels];
  int count;
  const unsigned char* gate;       // bool
  long long gate_stride;           // 0: one gate for every map; 1: one a map
  float free_add;
  float occ_add;
  float free_limit;
  float occ_limit;
};

__device__ __forceinline__ const TailLevel& level_of(const TailTable& t) {
  int l = 0;
  while (l + 1 < t.count &&
         static_cast<int>(blockIdx.x) >= t.level[l + 1].first_tile) {
    ++l;
  }
  return t.level[l];
}

__device__ __forceinline__ void store_changed(float* p, float old,
                                              float now) {
  if (__float_as_uint(now) != __float_as_uint(old)) *p = now;
}

template <int kModel>
__global__ void __launch_bounds__(kThreads)
update_kernel(const __grid_constant__ TailTable t) {
  const long long r = blockIdx.y;
  if (!t.gate[r * t.gate_stride]) return;
  const TailLevel& lv = level_of(t);
  const long long cells = static_cast<long long>(lv.height) * lv.width;
  constexpr int kChannels = kModel == kReflectance ? 2 : 1;
  float* s = lv.storage + r * cells * kChannels;
  const unsigned char* fs = lv.free_set + r * cells;
  const unsigned char* os = lv.occ_set + r * cells;
  const long long base =
      static_cast<long long>(blockIdx.x - lv.first_tile) * kUpdateTile +
      threadIdx.x;
  float v[kUpdateCells], w[kUpdateCells];
  unsigned char f[kUpdateCells], o[kUpdateCells];
#pragma unroll
  for (int j = 0; j < kUpdateCells; ++j) {
    const long long i = base + static_cast<long long>(j) * kThreads;
    v[j] = 0.0f;
    w[j] = 0.0f;
    f[j] = 0;
    o[j] = 0;
    if (i < cells) {
      v[j] = s[i];
      if (kModel == kReflectance) w[j] = s[cells + i];
      f[j] = fs[i];
      o[j] = os[i];
    }
  }
#pragma unroll
  for (int j = 0; j < kUpdateCells; ++j) {
    const long long i = base + static_cast<long long>(j) * kThreads;
    if (i >= cells) continue;
    const bool occ = o[j] != 0;
    const bool free_only = f[j] != 0 && !occ;
    if (kModel == kLogOdds) {
      store_changed(s + i, v[j],
                    (v[j] + (free_only ? t.free_add : 0.0f)) +
                        ((occ && v[j] < t.occ_limit) ? t.occ_add : 0.0f));
    } else if (kModel == kSimpleCount) {
      store_changed(
          s + i, v[j],
          (v[j] + ((free_only && v[j] > t.free_limit) ? t.free_add : 0.0f)) +
              ((occ && v[j] < t.occ_limit) ? t.occ_add : 0.0f));
    } else {
      store_changed(s + i, v[j],
                    (v[j] + (free_only ? 1.0f : 0.0f)) + (occ ? 1.0f : 0.0f));
      store_changed(s + cells + i, w[j], w[j] + (occ ? 1.0f : 0.0f));
    }
  }
}

template <int kModel>
__device__ __forceinline__ float prob(const float* s, long long cells,
                                      long long i) {
  if (kModel == kLogOdds) {
    const float odds = expf(s[i]);
    return odds / (odds + 1.0f);
  }
  if (kModel == kSimpleCount) return s[i];
  const float visited = s[i];
  return visited > 0.0f ? s[cells + i] / fmaxf(visited, 1.0f) : 0.5f;
}

template <int kModel>
__global__ void __launch_bounds__(kThreads)
repack_kernel(const __grid_constant__ TailTable t) {
  const long long r = blockIdx.y;
  if (!t.gate[r * t.gate_stride]) return;
  const TailLevel& lv = level_of(t);
  const int h = lv.height;
  const int w = lv.width;
  const long long cells = static_cast<long long>(h) * w;
  constexpr int kChannels = kModel == kReflectance ? 2 : 1;
  const float* s = lv.storage + r * cells * kChannels;
  float4* q = lv.quads + r * cells;
  const int tile = static_cast<int>(blockIdx.x) - lv.first_tile;
  const int lane = threadIdx.x & 31;
  const int x = (tile % lv.tiles_x) * kRepackCols + threadIdx.x;
  const int y0 = (tile / lv.tiles_x) * kRepackRows;
  const bool in = x < w;
  const int xr = x + 1 < w ? x + 1 : 0;
  // the next lane does not hold this cell's right neighbour
  const bool own_right = lane == 31 || x + 1 >= w;
  float top = in ? prob<kModel>(s, cells, static_cast<long long>(y0) * w + x)
                 : 0.0f;
  float top_r = __shfl_down_sync(0xffffffffu, top, 1);
  if (in && own_right) {
    top_r = prob<kModel>(s, cells, static_cast<long long>(y0) * w + xr);
  }
  const int rows = h - y0 < kRepackRows ? h - y0 : kRepackRows;
  for (int k = 0; k < rows; ++k) {
    const int y = y0 + k;
    const long long below = static_cast<long long>(y + 1 < h ? y + 1 : 0) * w;
    const float bot = in ? prob<kModel>(s, cells, below + x) : 0.0f;
    float bot_r = __shfl_down_sync(0xffffffffu, bot, 1);
    if (in && own_right) bot_r = prob<kModel>(s, cells, below + xr);
    if (in) {
      q[static_cast<long long>(y) * w + x] =
          make_float4(top, top_r, bot, bot_r);
    }
    top = bot;
    top_r = bot_r;
  }
}

template <int kModel>
void launch(int pass, const TailTable& t, dim3 grid, cudaStream_t stream) {
  if (pass == 0) {
    update_kernel<kModel><<<grid, kThreads, 0, stream>>>(t);
  } else {
    repack_kernel<kModel><<<grid, kThreads, 0, stream>>>(t);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): pass 0 (update) or 1 (repack)
// of `count` (1..kMaxLevels) levels of `maps` (1..65535) maps each, the
// cell model `model` (0 log_odds, 1 simple_count, 2 reflectance), in one
// launch on `stream`. Level k: storage[k] (f32, maps x channels x
// height[k] x width[k]), quads[k] (16-byte aligned f32[maps, cells, 4]),
// free_set[k] and occ_set[k] (bool, maps x cells); map r's gate is
// gate[r * gate_stride] (bool). free_add / occ_add / free_limit /
// occ_limit: the cell model's constants (see the header). Does not
// synchronise; returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue for an argument out of range).
extern "C" int hs_map_tail(int pass, int model, int count,
                           void* const* storage, void* const* quads,
                           const void* const* free_set,
                           const void* const* occ_set, const int* height,
                           const int* width, int maps, const void* gate,
                           long long gate_stride, float free_add,
                           float occ_add, float free_limit, float occ_limit,
                           void* stream) {
  if (pass < 0 || pass > 1 || model < kLogOdds || model > kReflectance ||
      count < 1 || count > kMaxLevels || maps < 1 || maps > 65535 ||
      gate_stride < 0 || gate_stride > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TailTable t{};
  t.count = count;
  t.gate = static_cast<const unsigned char*>(gate);
  t.gate_stride = gate_stride;
  t.free_add = free_add;
  t.occ_add = occ_add;
  t.free_limit = free_limit;
  t.occ_limit = occ_limit;
  long long blocks = 0;
  for (int k = 0; k < count; ++k) {
    if (height[k] < 1 || width[k] < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    TailLevel& lv = t.level[k];
    lv.storage = static_cast<float*>(storage[k]);
    lv.quads = static_cast<float4*>(quads[k]);
    lv.free_set = static_cast<const unsigned char*>(free_set[k]);
    lv.occ_set = static_cast<const unsigned char*>(occ_set[k]);
    lv.height = height[k];
    lv.width = width[k];
    lv.tiles_x = (width[k] + kRepackCols - 1) / kRepackCols;
    lv.first_tile = static_cast<int>(blocks);
    const long long cells = static_cast<long long>(height[k]) * width[k];
    blocks += pass == 0
                  ? (cells + kUpdateTile - 1) / kUpdateTile
                  : static_cast<long long>(lv.tiles_x) *
                        ((height[k] + kRepackRows - 1) / kRepackRows);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>(maps));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (model) {
    case kLogOdds: launch<kLogOdds>(pass, t, grid, s); break;
    case kSimpleCount: launch<kSimpleCount>(pass, t, grid, s); break;
    default: launch<kReflectance>(pass, t, grid, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
