// Sum of dynamic-offset patch loads from a resident grid, for Hopper
// (sm_90a): the patch-load cost probe.
//
// Replaces the Pallas TPU probe tools/probe_pallas.py:dyn_slice (call
// :188, kernel :172-186). With acc = 0 and, for rep i = 0 .. reps-1,
// j = i mod 512:
//   acc += g[y0 : y0+ph, x0 : x0+pw]
// where y0 = ys[j] and x0 is 0 (mode "y"), floor(xs[j] / pw) * pw (mode
// "xal", x aligned to the patch width) or xs[j] (mode "both"). A start
// outside the grid is resolved as the probe's loads resolve it (measured
// in interpret mode): a negative start is wrapped once by the dimension,
// then clamped to [0, dim - patch]. Each output element sums its reps in
// loop order, one f32 add each (__fadd_rn), so kernel, plain version and
// probe agree bit for bit.
//
// Design: each output element is a serial chain of `reps` adds in a fixed
// order, and those 4,096 chains (the probe's [32,128] patch) are all the
// parallelism the function has. A warp takes 32 adjacent elements of one
// patch row, one block each, so the probe's patch runs 128 warps on 128
// of the card's 132 SMs. An element needs only 512 distinct values, one
// per table slot, each reused reps / 512 times, so the warp stages them
// once:
//   1. the 512 offsets y0 * gw + x0, resolved by the warp into shared
//      memory;
//   2. its 512 x 32 grid values, copied into shared memory laid out
//      [slot][lane] (64 KB; the block asks for it with
//      cudaFuncSetAttribute), by cp.async of 4 bytes a lane and slot;
//   3. the chain: acc = acc + stage[(i & 511) * 32 + lane] in loop order,
//      one conflict-free shared load and one dependent add a rep, the
//      next 16 loads issued before the current 16 adds. After staging
//      the loop reads no global memory.
// cp.async, not a TMA box: in mode "both" a row starts at any element, so
// the rows are not 16-byte aligned; a warp's 32 4-byte copies of one slot
// are 128 contiguous bytes and coalesce into the sectors a wider copy
// would touch, and they need no tensor map. A patch width that is not a
// multiple of 32 leaves the last warp of a row with fewer live lanes; the
// stage is the same 512 x 32 floats for every patch, so every patch that
// fits the grid can be staged.
//
// What bounds it on the card: the chain of `reps` dependent f32 adds (a
// few cycles each: 16,384 of them in the probe), plus the staging (512
// copies a lane, from L2 once the grid is resident) and a launch. The bound
// the repo reports (the distinct grid cells read once, one f32 add per
// element and rep over the f32 peak) is far below it; chip_smoke.py puts
// the chain floor beside it.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kOffsets = 512;   // the probe's offset table (i mod 512)
constexpr int kAhead = 16;      // loads issued ahead of the adds
constexpr int kBatch = 32;      // offsets read before their copies
constexpr size_t kStageBytes = kOffsets * kLanes * sizeof(float) +
                               kOffsets * sizeof(int);
static_assert(kOffsets % kAhead == 0 && kOffsets % kBatch == 0,
              "a block of loads or offsets must not wrap");

__device__ __forceinline__ int resolve(int s, int dim, int size) {
  if (s < 0) s += dim;
  const int hi = dim - size;
  return s < 0 ? 0 : (s > hi ? hi : s);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if (a % b != 0 && a < 0) --q;
  return q;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__global__ void __launch_bounds__(kLanes)
dyn_slice_kernel(const float* __restrict__ g, int gh, int gw,
                 const int* __restrict__ ys, const int* __restrict__ xs,
                 int reps, int ph, int pw, int mode,
                 float* __restrict__ out) {
  extern __shared__ float stage[];   // [kOffsets][kLanes]
  int* off = reinterpret_cast<int*>(stage + kOffsets * kLanes);
  const int lane = threadIdx.x;
  const int warps_per_row = (pw + kLanes - 1) / kLanes;
  const int r = blockIdx.x / warps_per_row;
  const int c = (blockIdx.x - r * warps_per_row) * kLanes + lane;
  const int used = reps < kOffsets ? reps : kOffsets;

  for (int j = lane; j < used; j += kLanes) {
    const int y0 = resolve(ys[j], gh, ph);
    int x0 = 0;
    if (mode != 0) {
      const int x = mode == 1 ? floor_div(xs[j], pw) * pw : xs[j];
      x0 = resolve(x, gw, pw);
    }
    off[j] = y0 * gw + x0;
  }
  __syncwarp();
  if (c >= pw) return;   // a row's last warp may have fewer live lanes

  // each lane stages, and later reads, only its own column of the stage
  const float* src = g + static_cast<long long>(r) * gw + c;
  float* col = stage + lane;
  // offsets into registers a batch at a time, then the batch's copies:
  // the compiler keeps a shared load behind an earlier cp.async (both
  // touch shared memory), so a load per copy would wait out each one
  for (int j0 = 0; j0 < used; j0 += kBatch) {
    int o[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) o[u] = off[j0 + u];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (j0 + u < used) cp_async4(col + (j0 + u) * kLanes, src + o[u]);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  float acc = 0.f;
  float v[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) v[u] = col[u * kLanes];
  int j = 0;   // the table slot of v[0]
  for (int b = reps / kAhead; b > 0; --b) {
    const int jn = (j + kAhead) & (kOffsets - 1);
    float w[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) w[u] = col[(jn + u) * kLanes];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) acc = __fadd_rn(acc, v[u]);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) v[u] = w[u];
    j = jn;
  }
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    if (u < reps % kAhead) acc = __fadd_rn(acc, v[u]);
  }
  out[static_cast<long long>(r) * pw + c] = acc;
}

}  // namespace

// Plain C entry point (bound with ctypes). g: f32[gh, gw] row-major with
// gh * gw < 2^31; ys, xs: i32[512]; out: f32[ph, pw]; mode 0 = "y",
// 1 = "xal", 2 = "both". Launches on `stream` and does not synchronise;
// returns the CUDA error of the set-up or the launch.
extern "C" int hs_dyn_slice(const void* g, int gh, int gw, const void* ys,
                            const void* xs, int reps, int ph, int pw,
                            int mode, void* out, void* stream) {
  if (ph <= 0 || pw <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      dyn_slice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kStageBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(ph) * ((pw + kLanes - 1) / kLanes);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dyn_slice_kernel<<<static_cast<unsigned>(blocks), kLanes, kStageBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), gh, gw, static_cast<const int*>(ys),
      static_cast<const int*>(xs), reps, ph, pw, mode,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
