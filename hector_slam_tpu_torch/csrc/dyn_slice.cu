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
// loop order, one f32 add each, so kernel, plain version and probe agree
// bit for bit.
//
// Design: one thread per output element (a block per patch row, 128
// threads reading 512 contiguous bytes of a grid row per rep); the 512
// resolved offsets go to shared memory once. Each thread's add chain is
// serial, but its loads depend only on the offsets, so the unrolled loop
// issues them ahead of the adds. The probe's patch has 4,096 elements, so
// the kernel runs 32 blocks: the card is mostly idle, and the time is the
// latency of reps dependent adds plus the loads' latency where they are
// not hidden.
//
// What bounds it on the card: the distinct grid cells the offsets touch
// (at most the 4 MB grid, L2-resident after the first rep) and one f32 add
// per element and rep; both far below the serial chain's latency.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kOffsets = 512;   // the probe's offset table (i mod 512)

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

__global__ void __launch_bounds__(kThreads)
dyn_slice_kernel(const float* __restrict__ g, int gh, int gw,
                 const int* __restrict__ ys, const int* __restrict__ xs,
                 int reps, int ph, int pw, int mode,
                 float* __restrict__ out) {
  __shared__ int off[kOffsets];   // y0 * gw + x0 per table slot
  for (int j = threadIdx.x; j < kOffsets; j += kThreads) {
    const int y0 = resolve(ys[j], gh, ph);
    int x0 = 0;
    if (mode != 0) {
      const int x = mode == 1 ? floor_div(xs[j], pw) * pw : xs[j];
      x0 = resolve(x, gw, pw);
    }
    off[j] = y0 * gw + x0;
  }
  __syncthreads();
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= ph * pw) return;
  const int r = e / pw, c = e - r * pw;
  const float* ge = g + r * gw + c;
  float acc = 0.f;
#pragma unroll 8
  for (int i = 0; i < reps; ++i) {
    acc = acc + __ldg(ge + off[i & (kOffsets - 1)]);
  }
  out[e] = acc;
}

}  // namespace

// Plain C entry point (bound with ctypes). g: f32[gh, gw] row-major with
// gh * gw < 2^31; ys, xs: i32[512]; out: f32[ph, pw]; mode 0 = "y",
// 1 = "xal", 2 = "both". Launches on `stream` and does not synchronise;
// returns cudaGetLastError() of the launch.
extern "C" int hs_dyn_slice(const void* g, int gh, int gw, const void* ys,
                            const void* xs, int reps, int ph, int pw,
                            int mode, void* out, void* stream) {
  const int n = ph * pw;
  if (n <= 0) return 0;
  dyn_slice_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), gh, gw, static_cast<const int*>(ys),
      static_cast<const int*>(xs), reps, ph, pw, mode,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
