// One pyramid level of the SLAM step's scan matcher for R robots, each
// with its own scan and its own map (or all on one shared map), for Hopper
// (sm_90a): every GN step's moments, guard, adjugate solve, clamp and pose
// update in ONE launch.
//
// Replaces the same TPU kernel as interp_moments.cu,
// hector_slam_tpu/ops/pallas_interp.py: interp_moments_pallas (body
// :91-229), on the paths that kernel's hypothesis geometry does not fit:
// the single robot of slam_step (R = 1) and the fleets (fleet_step: a map
// a robot; shared_fleet_step: one map). In torch ops a level was about 160
// small kernels a GN step (the interpolation chain, beam_sum's halving
// adds, the guarded solve), ~1,600 a match, each over about a thousand
// floats: the card spent the step on launch latency.
//
// The design:
//   - One block of kThreads (256) a robot. The block stages the robot's
//     valid beams in shared memory, compacted in beam order (the hypothesis
//     kernel's ballot/popc staging), then kPad far points, so the loop has
//     no tail test. 1,152 beams are 9.2 KB.
//   - Thread t takes compacted beams t, t + kThreads, ..., kUnroll of them
//     at a time with their quad loads issued together before the
//     arithmetic; kUnroll is sized so a UTM-30LX scan (<= 1,152 beams) is
//     one round.
//   - Each warp's xor butterflies sum its threads' nine moments; lane 0
//     writes them to partials[step % 2][warp], one barrier, and every
//     thread then sums the kWarps partials in warp order. Every thread
//     holds the same sums, so every thread runs gn_update and sinf/cosf of
//     the new angle: no broadcast and no second barrier. The partials
//     alternate between two buffers: a warp that writes step i + 2's
//     passed step i + 1's barrier, which every warp reached after reading
//     step i's.
//   - The estimate stays in registers across the steps; thread 0 writes
//     the final estimate and the last step's H.
// A robot's grid starts at quad + r * map_stride (64-bit: 64 robots of
// 2048^2 cells are 268 M quads); map_stride 0 is the shared map.
//
// Numerics: the hypothesis kernel's (interp_moments.cu, -fmad=false, its
// per-query body and gn_update, copied below). The sum order is fixed and
// depends only on the robot's own beams: per thread in beam order, the
// butterflies, then the warps in order; there are no float atomics. So
// robot r of a fleet is bit-equal to the same robot launched alone, and
// repeated launches are bit-identical. Against the torch ops
// (core/matcher.py's hessian_derivs_quad + guarded_step) the per-query
// terms differ by ulps (explicit FMAs, another sum order), and the
// estimates are held to the level form's tolerances.

#include <cuda_runtime.h>

namespace {

// ---- copied from interp_moments.cu, op for op --------------------------
// The staging, the per-query body and the GN update are the hypothesis
// kernel's. They are copies rather than a shared header: moving that
// kernel's code into shared functions changed its SASS (register choices
// and a few instructions), and its code stays as measured.

constexpr int kSums = 9;                // J^T J (6 distinct) and J^T (1-M)
constexpr float kFar = 1e30f;
constexpr float kClamp = 0.2f;          // |dtheta| per GN step (rad)
// 256 threads a robot: faster than 128 and 512 at live40's and fleet40's
// inputs on an H100 (PERF.md section 6)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// quad loads in flight per thread: a UTM-30LX scan (<= 1,152 beams) in
// one round
constexpr int kUnroll = (1152 + kThreads - 1) / kThreads;
constexpr int kPad = kThreads * kUnroll;  // far points after the last beam
constexpr int kStageTiles = 4;          // staging loads issued together
constexpr int kMaxPoints = 24576;       // beams a block stages (192 KB)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Stages the valid beams of points/mask [n] into `staged`, compacted in
// their order, kStageTiles x kThreads at a time: every mask byte and point
// of the group is loaded first, each warp's counts go to shared memory, one
// barrier, then the compacted writes. The counts alternate between two
// buffers, so a group costs one barrier. Returns the number of valid
// beams (the same in every thread); the caller pads and syncs.
__device__ __forceinline__ int stage_valid(
    const float2* __restrict__ points, const unsigned char* __restrict__ mask,
    int n, float2* staged, int (&warp_valid)[2][kStageTiles][kWarps],
    int tid, int lane, int warp) {
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
  return nv;
}

// One query's cell choice at the pose (x0, y0) with sin s, cos c (ns =
// -s): the map-frame transform in Eigen's affine order, the bounds rule
// (MapDimensionProperties.h:65-73: t equals its clamp into [0, size-2]
// exactly when it passes; NaN clamps to 0 and fails), the int-cast floor
// and fractions, the quad's index, and the rotation derivative's factors
// from the transform's products, rounded as the plain version's:
// (-s*px - c*py), (c*px - s*py). Branch-free: a query outside the map
// reads a clamped cell.
struct Query {
  int idx;
  float fx, fy, dxr, dyr;
  bool in;
};

__device__ __forceinline__ Query query_cell(float2 p, float s, float c,
                                            float ns, float x0, float y0,
                                            float xmax, float ymax, int w) {
  const float cpx = c * p.x;
  const float spx = s * p.x;
  const float cpy = c * p.y;
  const float nspy = ns * p.y;
  const float tx = cpx + (nspy + x0);
  const float ty = spx + (cpy + y0);
  const float cx = fminf(fmaxf(tx, 0.0f), xmax);
  const float cy = fminf(fmaxf(ty, 0.0f), ymax);
  Query q;
  q.in = cx == tx && cy == ty;
  const int xi = static_cast<int>(cx);
  const int yi = static_cast<int>(cy);
  q.fx = cx - static_cast<float>(xi);
  q.fy = cy - static_cast<float>(yi);
  q.idx = yi * w + xi;
  q.dxr = -(spx + cpy);
  q.dyr = cpx + nspy;
  return q;
}

// One query's moment terms from its quad v = (P00, P10, P01, P11), added
// to acc = (xx, xy, xt, yy, yt, tt, dx, dy, dt). A query outside the map
// has gx = gy = 0 and adds exactly nothing.
__device__ __forceinline__ void query_terms(const float4 v, const Query& q,
                                            float (&acc)[kSums]) {
  const float dx1 = v.y - v.x;
  const float dx2 = v.w - v.z;
  // bilinear value as two x lerps and one y lerp (sharing dx1, dx2 with
  // the x gradient)
  const float top = __fmaf_rn(q.fx, dx1, v.x);
  const float bottom = __fmaf_rn(q.fx, dx2, v.z);
  const float m_ = __fmaf_rn(q.fy, bottom - top, top);
  // quirk gradients (OccGridMapUtil.h:332-346), negation folded in:
  // -((P00-P10)*xfi + (P01-P11)*fx), -((P00-P01)*yfi + (P10-P11)*fy)
  const float gx = q.in ? __fmaf_rn(dx1, 1.0f - q.fx, dx2 * q.fx) : 0.0f;
  const float gy =
      q.in ? __fmaf_rn(v.z - v.x, 1.0f - q.fy, (v.w - v.y) * q.fy) : 0.0f;
  const float rot = __fmaf_rn(q.dxr, gx, q.dyr * gy);
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
}

// One guarded GN update of the map-frame estimate (x, y, th) from a
// step's sums m = (xx, xy, xt, yy, yt, tt, dx, dy, dt), rounded op by op
// as the torch epilogue it replaces (ScanMatcher.h:201-215):
//   guard H00 != 0 && H11 != 0 (a NaN passes), else the estimate stays;
//   adjugate3's cofactors, det3's right-associated sum, 1/det as an IEEE
//   division, each inverse entry cofactor * (1/det), the right-associated
//   mat-vec (ops/solve3.py); dtheta clamped to +-0.2 with torch.clamp's
//   NaN rule (a NaN passes; fminf/fmaxf alone would drop it).
__device__ __forceinline__ void gn_update(const float (&m)[kSums], float& x,
                                          float& y, float& th) {
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

// ---- the robot kernel ---------------------------------------------------

// est f32[R, 3] map-frame start estimates; points f32[R, n, 2] and mask
// u8[R, n] the robots' scans; quad f32[., H*W, 4] with robot r's grid at
// r * map_stride. est_out f32[R, 3] after `steps` GN steps, hess_out
// f32[R, 9] the last step's H (row-major).
__global__ void __launch_bounds__(kThreads)
robot_match_kernel(const float4* __restrict__ quad, long long map_stride,
                   int h, int w, const float* __restrict__ est,
                   const float2* __restrict__ points,
                   const unsigned char* __restrict__ mask, int n, int steps,
                   float* __restrict__ est_out,
                   float* __restrict__ hess_out) {
  extern __shared__ float2 staged[];
  __shared__ int warp_valid[2][kStageTiles][kWarps];
  __shared__ float partials[2][kWarps][kSums];
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long r = blockIdx.x;
  quad += r * map_stride;

  const int nv = stage_valid(points + r * n, mask + r * n, n, staged,
                             warp_valid, tid, lane, warp);
  // far points: rotation keeps |p|, so one coordinate lands >= 1e30 /
  // sqrt(2) away and fails the bounds test
  for (int i = tid; i < kPad; i += kThreads) {
    staged[nv + i] = make_float2(kFar, kFar);
  }
  __syncthreads();

  float x0 = est[3 * r + 0];
  float y0 = est[3 * r + 1];
  float th = est[3 * r + 2];
  float s = sinf(th);
  float c = cosf(th);
  const float xmax = static_cast<float>(w - 2);
  const float ymax = static_cast<float>(h - 2);
  float m[kSums];   // the step's sums, in every thread

  for (int step = 0, buf = 0;; buf ^= 1) {
    const float ns = -s;
    float acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
    for (int j0 = tid; j0 < nv; j0 += kPad) {
      Query q[kUnroll];
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        q[u] = query_cell(staged[j0 + kThreads * u], s, c, ns, x0, y0, xmax,
                          ymax, w);
        v[u] = __ldg(quad + q[u].idx);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) query_terms(v[u], q[u], acc);
    }
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      const float part = warp_sum(acc[k]);
      if (lane == 0) partials[buf][warp][k] = part;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      float sum = partials[buf][0][k];
#pragma unroll
      for (int wi = 1; wi < kWarps; ++wi) sum += partials[buf][wi][k];
      m[k] = sum;
    }
    gn_update(m, x0, y0, th);
    if (++step == steps) break;
    s = sinf(th);
    c = cosf(th);
  }

  if (tid == 0) {
    est_out[3 * r + 0] = x0;
    est_out[3 * r + 1] = y0;
    est_out[3 * r + 2] = th;
    constexpr int kHess[9] = {0, 1, 2, 1, 3, 4, 2, 4, 5};
#pragma unroll
    for (int k = 0; k < 9; ++k) hess_out[9 * r + k] = m[kHess[k]];
  }
}

constexpr int kMaxDevices = 64;
int g_smem_raised[kMaxDevices];   // per device: the limit was raised

}  // namespace

// Plain C entry point (bound with ctypes): `steps` GN steps of each of
// `robots` robots from map-frame `est` [R, 3]; est_out f32[R, 3], hess_out
// f32[R, 3, 3]. Raises the kernel's shared memory limit once per device at
// its first launch (a CUDA graph records launches, not attribute calls:
// the graphs' eager warm-up has raised it before any capture), then
// launches on `stream` without synchronising and returns
// cudaGetLastError(). cudaErrorInvalidValue for steps < 1, more than
// kMaxPoints beams or a negative map stride; nothing is launched for
// robots == 0.
extern "C" int hs_robot_match_level(const void* quad, long long map_stride,
                                    int h, int w, const void* est, int robots,
                                    const void* points, const void* mask,
                                    int n, int steps, void* est_out,
                                    void* hess_out, void* stream) {
  if (steps < 1 || n < 0 || n > kMaxPoints || map_stride < 0 || robots < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (robots == 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (!g_smem_raised[dev]) {
    err = cudaFuncSetAttribute(
        robot_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>((kMaxPoints + kPad) * sizeof(float2)));
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_raised[dev] = 1;
  }
  const size_t smem = static_cast<size_t>(n + kPad) * sizeof(float2);
  robot_match_kernel<<<robots, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(quad), map_stride, h, w,
      static_cast<const float*>(est), static_cast<const float2*>(points),
      static_cast<const unsigned char*>(mask), n, steps,
      static_cast<float*>(est_out), static_cast<float*>(hess_out));
  return static_cast<int>(cudaGetLastError());
}
