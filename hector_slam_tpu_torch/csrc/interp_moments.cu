// Batched bilinear interpolation + Gauss-Newton normal-equation moments
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hector_slam_tpu/ops/pallas_interp.py:
// interp_moments_pallas (kernel body _make_kernel.kern, :91-229), holding
// it to its totals AFTER the wrapper's window repair — i.e. to vmapped
// core/interp.py:hessian_derivs_quad up to f32 rounding. The TPU kernel's
// VMEM windows, lane shuffles, scalar prefetch and repair ladder exist
// because the grid must sit in VMEM; here the quad-packed grid (f32[H*W,
// 4], 16.8 MB at 1024^2) sits in the 50 MB L2, so each query reads its 2x2
// neighbourhood (P00, P10, P01, P11) as ONE 16-byte float4 load from
// quad[yi*W + xi], and no query ever leaves the kernel.
//
// Per hypothesis b and valid beam n:
//   tx = cos_b*px + (-sin_b*py + x_b),  ty = sin_b*px + (cos_b*py + y_b)
//   (Eigen's affine order, pallas_interp.py:257-258), bounds rule
//   0 <= t <= size-2, int-cast floor, bilinear value M and the reference's
//   quirk gradients (OccGridMapUtil.h:332-346), rotation derivative, and
//   the 9 moments J^T J (xx, xy, xt, yy, yt, tt) and J^T (1-M) (x, y, t),
//   plus the count of in-bounds valid queries.
//
// What bounds it on the card: f32 arithmetic, ~53 operations per valid
// in-bounds query (4.4 M queries per GN step at B=4096 and 1081 valid
// beams), against memory traffic of only the distinct quad cells the
// queries touch. The design:
//   - One warp per hypothesis, kWarps per block. The block stages the
//     level's points once in shared memory, compacted to the valid beams
//     in their original order (ballot + popc over kStageTiles tiles whose
//     loads are issued together, one barrier per group), so no lane tests
//     the mask and masked beams cost nothing. kPad far points follow the
//     last beam, so the loop has no tail test.
//   - Lane l takes compacted beams l, l+32, ..., kUnroll at a time: the
//     transforms and cell choices first, their kUnroll 16-byte quad loads
//     issued together, then the arithmetic. Branch-free: a query outside
//     the map reads a clamped cell and adds exactly zero.
//   - Everything after the cell choice is written as explicit FMAs, the
//     bilinear value as lerps that share their differences with the x
//     gradient; the rotation factors reuse the transform's products.
//   - The warp's fixed xor-shuffle tree sums the 10 outputs: no shared
//     memory reduction and no barrier after staging.
// What still holds it back (measured on an H100, PERF.md): the
// exact-rounding transform, the bounds test, two conversions, the address
// and the load are instructions the 53 operations do not count, so a
// query issues about twice the bound's slots; at B=4096 one warp per
// hypothesis leaves ~31 warps per SM to hide latency; a launch plus
// staging costs ~5 us. kUnroll = 2 (55 registers) measured faster than 4
// (63 registers). The level form (55 registers, no spills; a 32-byte
// stack frame for sinf/cosf's far-argument reduction) pays the launch and
// staging once a level: ~12 us a GN step at B=4096 against ~15.5 us a
// moments-only launch.
//
// Numerics. The file is built with -fmad=false, so no a*b+c is contracted
// implicitly: the transform, the bounds test (NaN fails it), the int floor
// and the fractions fx, fy round exactly as the plain PyTorch version's
// separate ops do, and sin/cos are torch.sin/torch.cos's (passed in by the
// wrapper, or sinf/cosf here, which those ops call). Both therefore pick
// the same cells and count the same `used` queries, exactly. The bilinear
// value, gradients, rotation derivative and the nine accumulations use
// explicit __fmaf_rn (which -fmad=false does not stop), so per-query terms
// differ from the plain version's by ulps and the moments are held to a
// relative tolerance (1e-5 of each hypothesis's largest |moment|). The
// sums run in a FIXED order (per lane in beam order, then the shuffle
// tree), with no float atomics, so repeated launches are bit-identical.
//
// Two forms of one body (the template flag kLevel):
//   - moments only (hs_interp_moments): one GN step's 9 moments and used
//     count per hypothesis, for interp_moments();
//   - a pyramid level (hs_interp_moments_level): all of the level's GN
//     steps in one launch. After the butterflies every lane holds the nine
//     sums, so every lane runs the same GN update (gn_update below: guard,
//     adjugate solve, clamp, pose update) and sinf/cosf of the new angle,
//     with no shuffle and no barrier; the estimate stays in registers and
//     the staged points serve every step. It writes the final estimate and
//     the last step's H. The update is written op by op as the port's torch
//     epilogue (core/matcher.py:guarded_step, ops/solve3.py) rounds it, so
//     the level form is bit-equal to launching the moments-only form once a
//     step with that epilogue between launches.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;               // hypotheses per block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 2;              // quad loads in flight per lane
constexpr int kPad = 32 * kUnroll;      // far points after the last beam
constexpr int kStageTiles = 8;          // staging loads issued together
constexpr int kOut = 10;                // 9 moments + used count
constexpr int kMaxPoints = 28672;       // 224 KB of staged points
constexpr float kFar = 1e30f;
constexpr float kClamp = 0.2f;          // |dtheta| per GN step (rad)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// One guarded GN update of the map-frame estimate (x, y, th) from a
// step's sums m = (xx, xy, xt, yy, yt, tt, dx, dy, dt), rounded op by op
// as the torch epilogue it replaces (ScanMatcher.h:201-215):
//   guard H00 != 0 && H11 != 0 (a NaN passes), else the estimate stays;
//   adjugate3's cofactors, det3's right-associated sum, 1/det as an IEEE
//   division, each inverse entry cofactor * (1/det), the right-associated
//   mat-vec (ops/solve3.py); dtheta clamped to +-0.2 with torch.clamp's
//   NaN rule (a NaN passes; fminf/fmaxf alone would drop it).
__device__ __forceinline__ void gn_update(const float (&m)[kOut - 1],
                                          float& x, float& y, float& th) {
  const float a = m[0], b = m[1], c = m[2];
  const float d = m[1], e = m[3], f = m[4];
  const float g = m[2], h = m[4], i = m[5];
  if (!(a != 0.0f && e != 0.0f)) return;
  const float adj00 = e * i - f * h, adj01 = c * h - b * i,
              adj02 = b * f - c * e;
  const float adj10 = f * g - d * i, adj11 = a * i - c * g,
              adj12 = c * d - a * f;
  const float adj20 = d * h - e * g, adj21 = b * g - a * h,
              adj22 = a * e - b * d;
  // det3's column-0 cofactors are the adjugate's first row (h*c - i*b
  // rounds as c*h - b*i: a product is commutative)
  const float r = 1.0f / (adj00 * a + (adj01 * d + adj02 * g));
  const float r0 = m[6], r1 = m[7], r2 = m[8];
  const float sx = (adj00 * r) * r0 + ((adj01 * r) * r1 + (adj02 * r) * r2);
  const float sy = (adj10 * r) * r0 + ((adj11 * r) * r1 + (adj12 * r) * r2);
  float st = (adj20 * r) * r0 + ((adj21 * r) * r1 + (adj22 * r) * r2);
  if (!isnan(st)) st = fminf(fmaxf(st, -kClamp), kClamp);
  x = x + sx;
  y = y + sy;
  th = th + st;
}

// kLevel false: out f32[B, 10] (9 moments, used count) at `poses`, with
// the given sin_t/cos_t. kLevel true: `steps` GN steps from `poses`; out
// f32[B, 3] the final estimate, hess_out f32[B, 9] the last step's H
// (row-major), sin_t/cos_t unused.
template <bool kLevel>
__global__ void __launch_bounds__(kThreads, 4)
interp_moments_kernel(const float4* __restrict__ quad, int h, int w,
                      const float* __restrict__ poses,    // [B, 3] map frame
                      const float* __restrict__ sin_t,    // [B]
                      const float* __restrict__ cos_t,    // [B]
                      int b_count,
                      const float2* __restrict__ points,  // [N] (px, py)
                      const unsigned char* __restrict__ mask,  // [N]
                      int n, int steps, float* __restrict__ out,
                      float* __restrict__ hess_out) {
  // the valid beams in their order, then kPad far points
  extern __shared__ float2 staged[];
  __shared__ int warp_valid[2][kStageTiles][kWarps];
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Stage the valid beams, kStageTiles x kThreads at a time: every mask
  // byte and point of the group is loaded first, each warp's counts go to
  // shared memory, one barrier, then the compacted writes. The counts
  // alternate between two buffers, so a group costs one barrier.
  int nv = 0;
  for (int base = 0, t = 0; base < n;
       base += kStageTiles * kThreads, t ^= 1) {
    bool valid[kStageTiles];
    float2 pt[kStageTiles];
    unsigned int ballot[kStageTiles];
#pragma unroll
    for (int g = 0; g < kStageTiles; ++g) {
      const int i = base + g * kThreads + tid;
      valid[g] = i < n && mask[i];
      pt[g] = i < n ? points[i] : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int g = 0; g < kStageTiles; ++g) {
      ballot[g] = __ballot_sync(0xffffffffu, valid[g]);
      if (lane == 0) warp_valid[t][g][warp] = __popc(ballot[g]);
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < kStageTiles; ++g) {
      int before = nv, tile = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        const int c = warp_valid[t][g][k];
        tile += c;
        if (k < warp) before += c;
      }
      if (valid[g]) {
        staged[before + __popc(ballot[g] & ((1u << lane) - 1u))] = pt[g];
      }
      nv += tile;
    }
  }
  // Far points after the last beam, so the unrolled loop needs no tail
  // test: rotation keeps |p|, so one coordinate of a far point lands
  // >= 1e30 / sqrt(2) away and fails the bounds test.
  if (tid < kPad) staged[nv + tid] = make_float2(kFar, kFar);
  __syncthreads();

  const int b = blockIdx.x * kWarps + warp;
  if (b >= b_count) return;
  float x0 = poses[3 * b + 0];
  float y0 = poses[3 * b + 1];
  float th = 0.0f;
  float s, c;
  if constexpr (kLevel) {
    th = poses[3 * b + 2];
    s = sinf(th);
    c = cosf(th);
  } else {
    s = sin_t[b];
    c = cos_t[b];
  }
  const float xmax = static_cast<float>(w - 2);
  const float ymax = static_cast<float>(h - 2);
  float m[kOut - 1];   // the step's sums, in every lane

  for (int step = 0;;) {
    const float ns = -s;
    float acc[kOut - 1];
#pragma unroll
    for (int k = 0; k < kOut - 1; ++k) acc[k] = 0.0f;
    int used = 0;

    // Branch-free: a query outside the map reads a clamped cell and
    // contributes gx = gy = 0, which adds exactly nothing.
    for (int j0 = lane; j0 < nv; j0 += 32 * kUnroll) {
      float fx[kUnroll], fy[kUnroll], dxr[kUnroll], dyr[kUnroll];
      float4 q[kUnroll];
      bool in[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float2 p = staged[j0 + 32 * u];
        const float cpx = c * p.x;
        const float spx = s * p.x;
        const float cpy = c * p.y;
        const float nspy = ns * p.y;
        const float tx = cpx + (nspy + x0);
        const float ty = spx + (cpy + y0);
        // bounds rule (MapDimensionProperties.h:65-73): t equals its clamp
        // into [0, size-2] exactly when it passes; NaN clamps to 0 and
        // fails
        const float cx = fminf(fmaxf(tx, 0.0f), xmax);
        const float cy = fminf(fmaxf(ty, 0.0f), ymax);
        in[u] = cx == tx && cy == ty;
        const int xi = static_cast<int>(cx);
        const int yi = static_cast<int>(cy);
        fx[u] = cx - static_cast<float>(xi);
        fy[u] = cy - static_cast<float>(yi);
        q[u] = __ldg(quad + (yi * w + xi));
        // the rotation derivative's factors from the transform's products,
        // rounded as the plain version's: (-s*px - c*py), (c*px - s*py)
        dxr[u] = -(spx + cpy);
        dyr[u] = cpx + nspy;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4 v = q[u];                 // (P00, P10, P01, P11)
        const float dx1 = v.y - v.x;
        const float dx2 = v.w - v.z;
        // bilinear value as two x lerps and one y lerp (sharing dx1, dx2
        // with the x gradient)
        const float top = __fmaf_rn(fx[u], dx1, v.x);
        const float bottom = __fmaf_rn(fx[u], dx2, v.z);
        const float m_ = __fmaf_rn(fy[u], bottom - top, top);
        // quirk gradients (OccGridMapUtil.h:332-346), negation folded in:
        // -((P00-P10)*xfi + (P01-P11)*fx), -((P00-P01)*yfi + (P10-P11)*fy)
        const float gx =
            in[u] ? __fmaf_rn(dx1, 1.0f - fx[u], dx2 * fx[u]) : 0.0f;
        const float gy =
            in[u] ? __fmaf_rn(v.z - v.x, 1.0f - fy[u], (v.w - v.y) * fy[u])
                  : 0.0f;
        const float rot = __fmaf_rn(dxr[u], gx, dyr[u] * gy);
        const float fun = 1.0f - m_;
        acc[0] = __fmaf_rn(gx, gx, acc[0]);
        acc[1] = __fmaf_rn(gx, gy, acc[1]);
        acc[2] = __fmaf_rn(gx, rot, acc[2]);
        acc[3] = __fmaf_rn(gy, gy, acc[3]);
        acc[4] = __fmaf_rn(gy, rot, acc[4]);
        acc[5] = __fmaf_rn(rot, rot, acc[5]);
        acc[6] = __fmaf_rn(gx, fun, acc[6]);
        acc[7] = __fmaf_rn(gy, fun, acc[7]);
        acc[8] = __fmaf_rn(rot, fun, acc[8]);
        used += in[u];
      }
    }

    // xor butterflies: every lane ends with the same (commutative) sums
#pragma unroll
    for (int k = 0; k < kOut - 1; ++k) m[k] = warp_sum(acc[k]);
    if constexpr (!kLevel) {
      float mine = static_cast<float>(warp_sum(used));
#pragma unroll
      for (int k = 0; k < kOut - 1; ++k) {
        if (lane == k) mine = m[k];
      }
      if (lane < kOut) out[b * kOut + lane] = mine;
      return;
    } else {
      gn_update(m, x0, y0, th);
      if (++step == steps) break;
      s = sinf(th);
      c = cosf(th);
    }
  }

  // the final estimate and the last step's H, row-major
  constexpr int kHess[9] = {0, 1, 2, 1, 3, 4, 2, 4, 5};
  float mine = x0;
  if (lane == 1) mine = y0;
  if (lane == 2) mine = th;
  if (lane < 3) out[3 * b + lane] = mine;
  mine = m[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    if (lane == k) mine = m[kHess[k]];
  }
  if (lane < 9) hess_out[9 * b + lane] = mine;
}

constexpr int kMaxDevices = 64;
// per form (moments only, level) and device: the limit was raised
int g_smem_raised[2][kMaxDevices];

// Checks the sizes, raises the form's shared memory limit once per device
// at its first launch (to what the largest launch needs: a CUDA graph
// records launches, not attribute calls, so an eager launch, the graphs'
// warm-up in core/graphs.py, has raised it before any capture), then
// launches on `stream` without synchronising. Returns cudaGetLastError()
// of the launch, or cudaErrorInvalidValue for more than kMaxPoints beams.
template <bool kLevel>
int launch(const void* quad, int h, int w, const void* poses,
           const void* sin_t, const void* cos_t, int b, const void* points,
           const void* mask, int n, int steps, void* out, void* hess_out,
           void* stream) {
  if (b <= 0) return 0;
  if (n < 0 || n > kMaxPoints) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(n + kPad) * sizeof(float2);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (!g_smem_raised[kLevel][dev]) {
    err = cudaFuncSetAttribute(
        interp_moments_kernel<kLevel>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>((kMaxPoints + kPad) * sizeof(float2)));
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_raised[kLevel][dev] = 1;
  }
  interp_moments_kernel<kLevel><<<(b + kWarps - 1) / kWarps, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(quad), h, w,
      static_cast<const float*>(poses), static_cast<const float*>(sin_t),
      static_cast<const float*>(cos_t), b,
      static_cast<const float2*>(points),
      static_cast<const unsigned char*>(mask), n, steps,
      static_cast<float*>(out), static_cast<float*>(hess_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).

// One GN step's moments: out f32[B, 10] at map-frame `poses` [B, 3] with
// their sin/cos [B].
extern "C" int hs_interp_moments(const void* quad, int h, int w,
                                 const void* poses, const void* sin_t,
                                 const void* cos_t, int b,
                                 const void* points, const void* mask, int n,
                                 void* out, void* stream) {
  return launch<false>(quad, h, w, poses, sin_t, cos_t, b, points, mask, n,
                       1, out, nullptr, stream);
}

// A pyramid level's `steps` GN steps from map-frame `poses` [B, 3]:
// est_out f32[B, 3] the final estimate, hess_out f32[B, 3, 3] the last
// step's H. cudaErrorInvalidValue for steps < 1.
extern "C" int hs_interp_moments_level(const void* quad, int h, int w,
                                       const void* poses, int b,
                                       const void* points, const void* mask,
                                       int n, int steps, void* est_out,
                                       void* hess_out, void* stream) {
  if (steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(quad, h, w, poses, nullptr, nullptr, b, points, mask,
                      n, steps, est_out, hess_out, stream);
}
