// The map update's rasterization and paint in one launch, for Hopper
// (sm_90a): every beam's Bresenham cells of every level and every scan
// stored straight into the zeroed free and occupied byte grids, with no
// index set in device memory.
//
// Replaces the same TPU work as paint_cells.cu (the Pallas probe
// tools/probe_mosaic_store.py: probe_scalar_store, the map update's
// _scatter_true, hector_slam_tpu/core/mapping.py:155-160) together with
// the index sets the JAX package builds for it in XLA
// (hector_slam_tpu/core/mapping.py: _bresenham_params, the dense [N, K]
// set and rasterize_scan_seg's compacted one). In torch ops that build
// is ~195 small operations on every scan (both free-set layouts, a
// cumsum, a searchsorted, the sentinel selects), and a fleet's dense
// level-0 set alone is [8, 1152, 648] i32, 24 MB, read back by the
// paint. Yet every cell has a closed form: free cell j of a beam is
//   start + j*offset_a + ((abs_da/2 + j*abs_db)/abs_da)*offset_b,
// j < min(abs_da, K), and the occupied cell is the beam's end.
//
// Per beam, in core/mapping.py's _bresenham_params order (the torch route,
// which is the kernel's plain version), with -fmad=false and the _rn
// intrinsics so that no product is contracted into an FMA:
//   map pose    tx = px*s + (o_x*s), ty alike (core/grid.world_to_map:
//               the scale and s*o are f32 values from the wrapper);
//               sin and cos of the angle come from the wrapper's torch ops
//   points      p * point_scale (level_points' 2^-level; x1 is exact)
//   start       bx = (int)((c*gx + ((-s)*gy + tx)) + 0.5f),
//               by = (int)((s*gx + (c*gy + ty)) + 0.5f), from the origo g
//   end         ex, ey alike from the beam's point
//   valid       mask && (ex, ey) != (bx, by) && both inside the level
// The float-to-int casts are the card's truncating, saturating cvt, as
// torch's .to(torch.int32) on the card. Stores as paint_cells.cu's: an
// unsigned bounds check, a byte store of 1, no atomics; duplicate cells
// store the same byte, so repeat launches are bit-identical. Per-robot
// grids offset scan r's cells by r*H*W; a shared grid takes every scan's
// cells at base 0 (the OR over scans). Cells past K of a valid beam are
// counted, not painted (the truncated count): an integer sum a block,
// then integer atomics, whose result does not depend on their order.
//
// What bounds it on the card: bytes. It reads 8 bytes of point and 1 of
// mask a beam and stores about 1 byte a painted cell (a 32-byte sector
// per few cells: a ray's neighbouring cells share sectors, a row apart at
// worst), beside the wrapper's one zero fill of the grids, which at
// 2048^2 x 2 levels is 10.5 MB a map and is most of the bytes. The design:
//   - A warp a beam, its lanes on consecutive j: a 648-cell beam takes 21
//     rounds of stores, not 648 dependent iterations. Every lane computes
//     the beam's parameters itself from the same broadcast loads, so no
//     shuffle is needed.
//   - A block of kWarps beams of one (scan, level); the grid's y is the
//     scan and z the level, so one launch covers a whole update: live40's
//     2 levels x 1,152 beams are 288 blocks, fleet40's 8 robots 2,304.
//   - Lane 0 stores the occupied cell and the beam's truncated cells; the
//     block sums its warps' counts in shared memory and thread 0 adds the
//     sum to the (level, scan) count and to the scan's total over levels.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;   // beams per block
constexpr int kMaxLevels = 8;

struct RasterLevel {
  unsigned char* free_set;   // grids x height x width bytes, zeroed
  unsigned char* occ_set;    // alike
  int height;
  int width;
  int max_ray_cells;         // K: free cells painted per beam at most
  float point_scale;         // 2^-level, or 1 for points at the level
  float map_scale;           // world -> map scale (f32)
  float offset_x;            // offset * map_scale (f32 products)
  float offset_y;
};

struct RasterTable {
  RasterLevel level[kMaxLevels];
  const float* pose;           // scans x 3, world frame
  const float* sin_theta;      // scans
  const float* cos_theta;      // scans
  const float* points;         // scans x beams x 2
  const float* origo;          // scans x 2
  const unsigned char* mask;   // scans x beams
  int* truncated;              // (levels + 1) x scans, zeroed
  int scans;
  int beams;
  int levels;
  int per_robot;               // scan r paints grid r, else grid 0
};

// a + (b + t) with every product and sum rounded on its own, then the
// reference's +0.5 rounding and int cast (OccGridMapBase.h:134-155)
__device__ __forceinline__ int round_cell(float a, float x, float b, float y,
                                          float t) {
  const float v = __fadd_rn(__fmul_rn(a, x), __fadd_rn(__fmul_rn(b, y), t));
  return static_cast<int>(__fadd_rn(v, 0.5f));
}

__global__ void __launch_bounds__(kThreads)
raster_paint_kernel(const __grid_constant__ RasterTable t) {
  __shared__ int part[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.y;
  const int l = blockIdx.z;
  const RasterLevel& lv = t.level[l];
  const int beam = blockIdx.x * kWarps + warp;
  int over = 0;
  if (beam < t.beams &&
      t.mask[static_cast<long long>(r) * t.beams + beam]) {
    const int h = lv.height;
    const int w = lv.width;
    const float tx =
        __fadd_rn(__fmul_rn(t.pose[3 * r], lv.map_scale), lv.offset_x);
    const float ty =
        __fadd_rn(__fmul_rn(t.pose[3 * r + 1], lv.map_scale), lv.offset_y);
    const float s = t.sin_theta[r];
    const float c = t.cos_theta[r];
    const float gx = __fmul_rn(t.origo[2 * r], lv.point_scale);
    const float gy = __fmul_rn(t.origo[2 * r + 1], lv.point_scale);
    const float2 p = reinterpret_cast<const float2*>(
        t.points)[static_cast<long long>(r) * t.beams + beam];
    const float px = __fmul_rn(p.x, lv.point_scale);
    const float py = __fmul_rn(p.y, lv.point_scale);
    const int bx = round_cell(c, gx, -s, gy, tx);
    const int by = round_cell(s, gx, c, gy, ty);
    const int ex = round_cell(c, px, -s, py, tx);
    const int ey = round_cell(s, px, c, py, ty);
    const bool valid = (ex != bx || ey != by) && bx >= 0 && bx < w &&
                       by >= 0 && by < h && ex >= 0 && ex < w && ey >= 0 &&
                       ey < h;
    if (valid) {
      const int dx = ex - bx;
      const int dy = ey - by;
      const int abs_dx = dx < 0 ? -dx : dx;
      const int abs_dy = dy < 0 ? -dy : dy;
      const bool x_dom = abs_dx >= abs_dy;
      const int step_x = dx > 0 ? 1 : -1;         // sign(0) == -1
      const int step_y = (dy > 0 ? 1 : -1) * w;
      const int abs_da = x_dom ? abs_dx : abs_dy;  // >= 1: the cells differ
      const int abs_db = x_dom ? abs_dy : abs_dx;
      const int offset_a = x_dom ? step_x : step_y;
      const int offset_b = x_dom ? step_y : step_x;
      const int base = t.per_robot ? r * h * w : 0;
      const unsigned int cells =
          static_cast<unsigned int>(h * w) *
          static_cast<unsigned int>(t.per_robot ? t.scans : 1);
      const int start = by * w + bx + base;
      const int err0 = abs_da / 2;
      const int len = abs_da < lv.max_ray_cells ? abs_da : lv.max_ray_cells;
      for (int j = lane; j < len; j += 32) {
        const int minor = (err0 + j * abs_db) / abs_da;
        const unsigned int cell =
            static_cast<unsigned int>(start + j * offset_a + minor * offset_b);
        if (cell < cells) lv.free_set[cell] = 1;
      }
      if (lane == 0) {
        const unsigned int end =
            static_cast<unsigned int>(ey * w + ex + base);
        if (end < cells) lv.occ_set[end] = 1;
        over = abs_da - len;
      }
    }
  }
  if (lane == 0) part[warp] = over;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) sum += part[k];
    if (sum != 0) {
      atomicAdd(t.truncated + l * t.scans + r, sum);
      atomicAdd(t.truncated + t.levels * t.scans + r, sum);
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): rasterizes and paints `count`
// (1..kMaxLevels) levels of `scans` scans of `beams` beams in one launch
// on `stream`. Level k paints into free_set[k] / occ_set[k] (scans x
// height x width bytes with per_robot, else height x width; zeroed by
// the caller) and counts its truncated cells into truncated[k * scans +
// r], their sum over levels into truncated[count * scans + r] (zeroed by
// the caller). Does not synchronise; returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for arguments the kernel does not
// take. Nothing is launched for zero beams.
extern "C" int hs_raster_paint(
    int count, void* const* free_set, void* const* occ_set,
    const int* height, const int* width, const int* max_ray_cells,
    const float* point_scale, const float* map_scale, const float* offset_x,
    const float* offset_y, const void* pose, const void* sin_theta,
    const void* cos_theta, const void* points, const void* origo,
    const void* mask, int scans, int beams, int per_robot, void* truncated,
    void* stream) {
  if (count < 1 || count > kMaxLevels || scans < 1 || scans > 65535 ||
      beams < 0 || per_robot < 0 || per_robot > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RasterTable t{};
  for (int k = 0; k < count; ++k) {
    const long long cells = static_cast<long long>(height[k]) * width[k] *
                            (per_robot ? scans : 1);
    if (height[k] < 1 || width[k] < 1 || max_ray_cells[k] < 1 ||
        cells > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    RasterLevel& lv = t.level[k];
    lv.free_set = static_cast<unsigned char*>(free_set[k]);
    lv.occ_set = static_cast<unsigned char*>(occ_set[k]);
    lv.height = height[k];
    lv.width = width[k];
    lv.max_ray_cells = max_ray_cells[k];
    lv.point_scale = point_scale[k];
    lv.map_scale = map_scale[k];
    lv.offset_x = offset_x[k];
    lv.offset_y = offset_y[k];
  }
  if (beams == 0) return 0;
  t.pose = static_cast<const float*>(pose);
  t.sin_theta = static_cast<const float*>(sin_theta);
  t.cos_theta = static_cast<const float*>(cos_theta);
  t.points = static_cast<const float*>(points);
  t.origo = static_cast<const float*>(origo);
  t.mask = static_cast<const unsigned char*>(mask);
  t.truncated = static_cast<int*>(truncated);
  t.scans = scans;
  t.beams = beams;
  t.levels = count;
  t.per_robot = per_robot;
  const dim3 grid((beams + kWarps - 1) / kWarps, scans, count);
  raster_paint_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
