// Batched bilinear interpolation + Gauss-Newton normal-equation moments
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hector_slam_tpu/ops/pallas_interp.py:
// interp_moments_pallas (kernel body _make_kernel.kern, :91-229), holding
// it to its totals AFTER the wrapper's window repair — i.e. to vmapped
// core/interp.py:hessian_derivs_quad up to f32 summation order. The TPU
// kernel's VMEM windows, lane shuffles, scalar prefetch and repair ladder
// exist because the grid must sit in VMEM; here the quad-packed grid
// (f32[H*W, 4], 16.8 MB at 1024^2) sits in the 50 MB L2, so each query
// reads its 2x2 neighbourhood (P00, P10, P01, P11) as ONE 16-byte float4
// load from quad[yi*W + xi], and no query ever leaves the kernel.
//
// Per hypothesis b (one block) and beam n (threads stride over beams):
//   tx = cos_b*px + (-sin_b*py + x_b),  ty = sin_b*px + (cos_b*py + y_b)
//   (Eigen's affine order, pallas_interp.py:257-258), bounds rule
//   0 <= t <= size-2, int-cast floor, bilinear value M and the reference's
//   quirk gradients (OccGridMapUtil.h:332-346), rotation derivative, and
//   the 9 moments J^T J (xx, xy, xt, yy, yt, tt) and J^T (1-M) (x, y, t),
//   plus the count of in-bounds valid queries.
//
// Numerics: built with -fmad=false, so no a*b+c is contracted into an FMA
// and every f32 op rounds as the plain PyTorch version's separate ops do;
// sin/cos come in from the wrapper (torch.sin/torch.cos), so the kernel
// and the plain version see the same f32 inputs and pick the same cells.
// Per-query terms are then bit-equal to the plain version's; the sums are
// reduced in a FIXED order (per-thread serial, warp shuffles, then shared
// memory across warps), with no float atomics, so repeated launches are
// bit-identical. No Kahan compensation: each thread sums <= ceil(N/128)
// terms and the tree adds 7 levels, so the rounding error stays within
// the tolerance the comparison states.
//
// What bounds it on the card: f32 arithmetic, ~59 operations per valid
// in-bounds query (4.4 M queries per GN step at B=4096 and 1081 valid
// beams), against memory traffic of only the distinct quad cells the
// queries touch (hundreds to a few thousand cells for a tracking
// population). The design keeps everything in registers (one 16-byte
// load per query, served by L2) and launches one 128-thread block per
// hypothesis, so 4096 blocks fill the 132 SMs many times over.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kOut = 10;   // 9 moments + used count

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
interp_moments_kernel(const float4* __restrict__ quad, int h, int w,
                      const float* __restrict__ poses,    // [B, 3] map frame
                      const float* __restrict__ sin_t,    // [B]
                      const float* __restrict__ cos_t,    // [B]
                      const float2* __restrict__ points,  // [N] (px, py)
                      const unsigned char* __restrict__ mask,  // [N]
                      int n, float* __restrict__ out) {   // [B, 10]
  const int b = blockIdx.x;
  const float x0 = poses[3 * b + 0];
  const float y0 = poses[3 * b + 1];
  const float s = sin_t[b];
  const float c = cos_t[b];
  const float xmax = static_cast<float>(w - 2);
  const float ymax = static_cast<float>(h - 2);

  float acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = 0.0f;

  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (!mask[i]) continue;
    const float2 p = points[i];
    const float tx = c * p.x + (-s * p.y + x0);
    const float ty = s * p.x + (c * p.y + y0);
    // bounds rule (MapDimensionProperties.h:65-73); NaN fails it too
    if (!(tx >= 0.0f && tx <= xmax && ty >= 0.0f && ty <= ymax)) continue;
    const int xi = min(max(static_cast<int>(tx), 0), w - 2);
    const int yi = min(max(static_cast<int>(ty), 0), h - 2);
    const float fx = tx - static_cast<float>(xi);
    const float fy = ty - static_cast<float>(yi);
    const float4 q = __ldg(quad + static_cast<long long>(yi) * w + xi);
    const float xfi = 1.0f - fx;
    const float yfi = 1.0f - fy;
    const float m = (q.x * xfi + q.y * fx) * yfi + (q.z * xfi + q.w * fx) * fy;
    const float gx = -(((q.x - q.y) * xfi) + ((q.z - q.w) * fx));
    const float gy = -(((q.x - q.z) * yfi) + ((q.y - q.w) * fy));
    const float rot = (-s * p.x - c * p.y) * gx + (c * p.x - s * p.y) * gy;
    const float fun = 1.0f - m;
    acc[0] += gx * gx;
    acc[1] += gx * gy;
    acc[2] += gx * rot;
    acc[3] += gy * gy;
    acc[4] += gy * rot;
    acc[5] += rot * rot;
    acc[6] += gx * fun;
    acc[7] += gy * fun;
    acc[8] += rot * fun;
    acc[9] += 1.0f;
  }

  __shared__ float part[kWarps][kOut];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const float v = warp_sum(acc[k]);
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      const float v = warp_sum(lane < kWarps ? part[lane][k] : 0.0f);
      if (lane == 0) out[b * kOut + k] = v;
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream` and does
// not synchronise; returns cudaGetLastError() of the launch.
extern "C" int hs_interp_moments(const void* quad, int h, int w,
                                 const void* poses, const void* sin_t,
                                 const void* cos_t, int b,
                                 const void* points, const void* mask, int n,
                                 void* out, void* stream) {
  if (b <= 0) return 0;
  interp_moments_kernel<<<b, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(quad), h, w,
      static_cast<const float*>(poses), static_cast<const float*>(sin_t),
      static_cast<const float*>(cos_t), static_cast<const float2*>(points),
      static_cast<const unsigned char*>(mask), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
