// Chained bf16 product with a stationary right operand, for Hopper
// (sm_90a): the matrix-unit cost probe.
//
// Replaces the Pallas TPU probe tools/probe_pallas.py:matmul_stationary
// (call :144, kernel :134-142): reps times a <- bf16(a @ w), the product
// of bf16 operands accumulated in f32 and rounded to bf16 (to nearest
// even) after each rep; the result is returned as f32. w is [128, 128]
// (k == n == 128, the probe's shape); a is [m, 128] with m % 16 == 0.
//
// Design: rows of a are independent across reps, so each warp owns 16
// rows for all reps and never leaves the kernel between them. w is
// loaded once per block, transposed into shared memory (32 KB plus a
// padding of 8 bf16 per row, so that the eight rows a fragment load
// touches fall into distinct banks). Each rep is 8 (k) x 16 (n)
// mma.sync.m16n8k16 bf16 tensor-core products into f32 accumulators held
// in registers; the accumulators of two neighbouring n8 tiles are, after
// rounding to bf16, exactly the A fragment of one k16 tile of the next
// rep, so a never goes back to memory until the last rep. Four warps (64
// rows) per block: the probe's m = 8192 gives 128 blocks, about one per
// SM.
//
// What bounds it on the card: operations. 2 * m * 128 * 128 bf16 tensor
// operations per rep (268 M at m = 8192) against 6 MB moved once. mma.sync
// reaches only part of the dense bf16 peak (that takes wgmma, later work),
// and every warp reads all of w from shared memory each rep (as many
// shared-memory bytes as tensor-core cycles at four warps per SM).
//
// Numbers: each product of two bf16 is exact in f32; the tensor core sums
// them in its own order, so a rep's f32 sum may differ from another
// order's in the last bits and its bf16 rounding by one ulp. The chain
// shrinks a by about 0.64 per rep at the probe's w ~ U(0, 0.01); past
// about 200 reps the values are denormal, and past about 220 zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDim = 128;               // k == n
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = kWarps * 16;
constexpr int kLd = kDim + 8;           // padded row of w^T, in bf16

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
matmul_stationary_kernel(const __nv_bfloat16* __restrict__ a,
                         const __nv_bfloat16* __restrict__ w,
                         float* __restrict__ out, int m, int reps) {
  __shared__ __align__(16) __nv_bfloat16 wt[kDim * kLd];   // wt[n][k]
  for (int e = threadIdx.x; e < kDim * kDim; e += kThreads) {
    const int k = e / kDim, n = e - k * kDim;
    wt[n * kLd + k] = w[e];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;   // fragment row group, column pair
  const int r0 = blockIdx.x * kRowsPerBlock + warp * 16;
  if (r0 >= m) return;

  // A fragments of the warp's 16 rows, one per k16 tile: registers
  // {rows g, g+8} x {columns 2q, 2q+1, 2q+8, 2q+9} of the tile
  const uint32_t* a32 = reinterpret_cast<const uint32_t*>(a);
  uint32_t af[8][4];
#pragma unroll
  for (int kt = 0; kt < 8; ++kt) {
    const int col = kt * 16 + 2 * q;
    af[kt][0] = a32[((r0 + g) * kDim + col) / 2];
    af[kt][1] = a32[((r0 + g + 8) * kDim + col) / 2];
    af[kt][2] = a32[((r0 + g) * kDim + col + 8) / 2];
    af[kt][3] = a32[((r0 + g + 8) * kDim + col + 8) / 2];
  }

  const uint32_t* wt32 = reinterpret_cast<const uint32_t*>(wt);
  for (int i = 0; i < reps; ++i) {
    float c[16][4];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
    }
#pragma unroll
    for (int kt = 0; kt < 8; ++kt) {
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        // B fragment: w[k = kt*16 + 2q (+1), (+8, +9)][n = nt*8 + g]
        const int b = ((nt * 8 + g) * kLd + kt * 16 + 2 * q) / 2;
        mma_16816(c[nt], af[kt], wt32[b], wt32[b + 4]);
      }
    }
    // round to bf16: n8 tiles 2kt and 2kt+1 become the k16 tile kt
#pragma unroll
    for (int kt = 0; kt < 8; ++kt) {
      af[kt][0] = pack_bf16(c[2 * kt][0], c[2 * kt][1]);
      af[kt][1] = pack_bf16(c[2 * kt][2], c[2 * kt][3]);
      af[kt][2] = pack_bf16(c[2 * kt + 1][0], c[2 * kt + 1][1]);
      af[kt][3] = pack_bf16(c[2 * kt + 1][2], c[2 * kt + 1][3]);
    }
  }

  float2* o2 = reinterpret_cast<float2*>(out);
#pragma unroll
  for (int kt = 0; kt < 8; ++kt) {
    const int col = kt * 16 + 2 * q;
    o2[((r0 + g) * kDim + col) / 2] = unpack_bf16(af[kt][0]);
    o2[((r0 + g + 8) * kDim + col) / 2] = unpack_bf16(af[kt][1]);
    o2[((r0 + g) * kDim + col + 8) / 2] = unpack_bf16(af[kt][2]);
    o2[((r0 + g + 8) * kDim + col + 8) / 2] = unpack_bf16(af[kt][3]);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). a: bf16[m, 128], w: bf16[128,
// 128], out: f32[m, 128], all row-major; m % 16 == 0. Launches on
// `stream` and does not synchronise; returns cudaGetLastError() of the
// launch.
extern "C" int hs_matmul_stationary(const void* a, const void* w, void* out,
                                    int m, int reps, void* stream) {
  if (m <= 0) return 0;
  matmul_stationary_kernel<<<(m + kRowsPerBlock - 1) / kRowsPerBlock,
                             kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(w), static_cast<float*>(out), m,
      reps);
  return static_cast<int>(cudaGetLastError());
}
