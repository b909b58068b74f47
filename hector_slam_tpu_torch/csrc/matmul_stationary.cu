// Chained bf16 product with a stationary right operand, for Hopper
// (sm_90a): the matrix-unit cost probe.
//
// Replaces the Pallas TPU probe tools/probe_pallas.py:matmul_stationary
// (call :144, kernel :134-142): reps times a <- bf16(a @ w), the product
// of bf16 operands accumulated in f32 and rounded to bf16 (to nearest
// even) after each rep; the result is returned as f32. w is [128, 128]
// (k == n == 128, the probe's shape); a is [m, 128] with m % 16 == 0.
//
// What bounds it on the card: operations. 2 * m * 128 * 128 bf16 tensor
// operations per rep (268 M at m = 8192) against 6 MB moved once. Rows
// of a are independent across reps, but each rep of a row needs the
// whole previous rep of that row: a 64-row tile is one dependent chain,
// and the probe's m = 8192 gives 128 tiles, one chain per SM. Per rep an
// SM owes 64 x 128 x 128 MACs, 512 cycles at the dense bf16 rate.
//
// Design: one warpgroup (128 threads) per 64-row tile, for all reps, on
// wgmma.mma_async m64nNk16 with A from registers (the RS form):
//  * w is staged once per block into shared memory as w^T (K-major: each
//    n row holds its 128 k values), in the 128-byte-swizzle layout a wgmma
//    B descriptor reads: two 64-wide k halves of 128 rows x 128 bytes,
//    16-byte chunk c of row n at chunk c ^ (n % 8). The transpose is done
//    while staging (a 2-byte store per element, once per block) rather
//    than with the descriptor's transpose bit, so B has the canonical
//    K-major layout, and a k16 step is the descriptor advanced by 32 bytes.
//  * a never leaves registers between reps: a wgmma accumulator gives each
//    warp rows 16w..16w+15 in the per-thread layout of mma.sync's C, so
//    two neighbouring n8 column tiles, rounded to bf16
//    (__floats2bfloat162_rn), are exactly the A fragment of one k16 tile
//    of the next rep. No global memory is touched inside the rep loop.
//  * The rep boundary is hidden by splitting n into two chunks of 64
//    columns (m64n64k16). Chunk j of rep r is the next rep's k tiles
//    4j..4j+3. A rep runs two phases; phase j waits only for chunk j of
//    the previous rep, rounds it, and issues its four k tiles into both
//    chunks of this rep, while the previous rep's chunk 1 may still run
//    on the tensor cores. In phase 1 each chunk is its own commit group,
//    so chunk 0 completes first; every wait is wait_group(1). Accumulators
//    are double-buffered by rep parity (the loop is unrolled by two so
//    every register index is a constant): 2 x 64 f32 and 32 A registers
//    a thread. The unsplit chain (wait for the whole rep, round, issue)
//    and four n32 chunks were built and timed while choosing, and read
//    slower; neither is kept. Two warpgroups per tile, each owning 64
//    columns, were not built: both issue to the SM's same four tensor
//    cores, so a rep still costs 512 cycles, and each needs the other's
//    half of the rep before it can start the next, so nothing overlaps
//    the boundary; the exchange adds a shared-memory round trip and a
//    barrier to it.
//  * A tile past m (m % 64 != 0): its warps run the wgmmas on zero
//    fragments (a warpgroup instruction needs all four warps) and store
//    nothing.
//
// Numbers: each product of two bf16 is exact in f32; the tensor core sums
// a k16 step's products in its own order, and the k steps in k order
// into one accumulator, so a rep's f32 sum may differ from another
// order's in the last bits and its bf16 rounding by one ulp. The split
// does not change the order (a chunk's k steps still run 0..7 into one
// accumulator), and repeats are bit-identical. The chain shrinks a by
// about 0.64 per rep at the probe's w ~ U(0, 0.01): near 190 reps every
// value is denormal, and from about 200 reps on each sits at the smallest
// bf16 denormal, 2^-133 (0.64 of it rounds back up to it). The tensor
// cores keep denormal operands and sums: at 195 reps, where the values
// are 3-6 steps of 2^-133, the kernel reads within 1 ulp of the plain
// version on the card (chip_smoke.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDim = 128;                        // k == n
constexpr int kThreads = 128;                    // one warpgroup
constexpr int kRowsPerBlock = 64;                // wgmma's m
constexpr int kKTiles = kDim / 16;               // k16 steps a rep
constexpr int kChunkN = kDim / 2;                // a chunk's wgmma n
constexpr int kAcc = kChunkN / 2;                // its f32 a thread
constexpr int kPhaseTiles = kKTiles / 2;         // k tiles a phase
constexpr int kHalfBytes = kDim * 128;           // 128 rows x 64 k (bf16)
constexpr int kSmemBytes = 2 * kHalfBytes + 1024;   // + 1024-byte alignment

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// Compiler-level fences on registers that a wgmma reads or writes
// asynchronously: a value read after wait_group is read after it, and an
// operand stays live until the wait.
__device__ __forceinline__ void keep(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void keep(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The B descriptor of a K-major tile with the 128-byte swizzle: start
// address, leading offset 1 (unused for this layout), stride 1024 bytes
// between groups of 8 n rows.
__device__ __forceinline__ uint64_t b_desc(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

#define HS_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HS_F16(d, i) HS_F4(d, i), HS_F4(d, i + 4), HS_F4(d, i + 8), \
    HS_F4(d, i + 12)
#define HS_A4(a) "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3])

// d (+)= a (64 x 16 bf16, registers) x B (16 x 64, shared memory), f32.
__device__ __forceinline__ void mma_n64(float (&d)[kAcc],
                                        const uint32_t (&a)[4],
                                        uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : HS_F16(d, 0), HS_F16(d, 16)
      : HS_A4(a), "l"(desc), "r"(scale_d));
}

#undef HS_A4
#undef HS_F16
#undef HS_F4

using Acc = float[2][kAcc];
using Frag = uint32_t[kKTiles][4];

// The descriptor of chunk c's k tile kt: its k half, its first n row,
// and the tile's 32-byte step within the half's 128-byte rows.
__device__ __forceinline__ uint64_t tile_desc(uint64_t base, int c, int kt) {
  return base + (((kt / 4) * kHalfBytes + c * kChunkN * 128 + (kt % 4) * 32)
                 >> 4);
}

// Phase J of a rep: issue k tiles J * kPhaseTiles .. of a into both
// chunks of acc (overwriting in phase 0), commit. Phase 1 commits each
// chunk on its own, so that chunk 0 completes first.
template <int J>
__device__ __forceinline__ void issue_phase(Acc& acc, Frag& af,
                                            uint64_t base) {
#pragma unroll
  for (int kt = J * kPhaseTiles; kt < (J + 1) * kPhaseTiles; ++kt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) keep(af[kt][i]);
  }
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int kt = J * kPhaseTiles; kt < (J + 1) * kPhaseTiles; ++kt) {
      mma_n64(acc[c], af[kt], tile_desc(base, c, kt), J > 0 || kt > 0);
    }
    if (J == 1) wgmma_commit();
  }
  if (J == 0) wgmma_commit();
}

// Chunk J of acc, rounded to bf16: the A fragments of k tiles
// J * kPhaseTiles .. (n8 tiles 2l and 2l+1 of the chunk are k tile l).
template <int J>
__device__ __forceinline__ void round_chunk(Acc& acc, Frag& af) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) keep(acc[J][i]);
#pragma unroll
  for (int l = 0; l < kPhaseTiles; ++l) {
    const float* c = acc[J] + 8 * l;
    uint32_t* a = af[J * kPhaseTiles + l];
    a[0] = pack_bf16(c[0], c[1]);
    a[1] = pack_bf16(c[2], c[3]);
    a[2] = pack_bf16(c[4], c[5]);
    a[3] = pack_bf16(c[6], c[7]);
  }
}

// One rep after the first: prev holds the previous rep (its chunk 1
// possibly still in flight), cur receives this one.
__device__ __forceinline__ void rep(Acc& cur, Acc& prev, Frag& af,
                                    uint64_t base) {
  wgmma_wait<1>();   // chunk 0 of the previous rep is done
  round_chunk<0>(prev, af);
  issue_phase<0>(cur, af, base);
  wgmma_wait<1>();   // chunk 1 of the previous rep is done
  round_chunk<1>(prev, af);
  issue_phase<1>(cur, af, base);
}

// The last rep, rounded: the result.
__device__ __forceinline__ void finish(Acc& last, Frag& af) {
  wgmma_wait<0>();
  round_chunk<0>(last, af);
  round_chunk<1>(last, af);
}

__global__ void __launch_bounds__(kThreads)
matmul_stationary_kernel(const __nv_bfloat16* __restrict__ a,
                         const __nv_bfloat16* __restrict__ w,
                         float* __restrict__ out, int m, int reps) {
  extern __shared__ uint8_t smem[];
  // w^T in the swizzled K-major layout, at a 1024-byte-aligned address
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t base_addr = (raw + 1023u) & ~1023u;
  uint8_t* wt = smem + (base_addr - raw);
  auto wt_at = [wt](int k, int n) {   // element (k, n) of w, as w^T
    const int kk = k % 64;
    return reinterpret_cast<__nv_bfloat16*>(
        wt + (k / 64) * kHalfBytes + n * 128 + (((kk / 8) ^ (n % 8)) * 16) +
        (kk % 8) * 2);
  };
  // 16 bytes (8 n) of one k row a load (w is 16-byte aligned);
  // neighbouring threads take neighbouring k, so a warp's 2-byte stores of
  // one n hit distinct banks or share a word
  const uint4* w4 = reinterpret_cast<const uint4*>(w);
#pragma unroll
  for (int e = threadIdx.x; e < kDim * kDim / 8; e += kThreads) {
    const int k = e % kDim, n0 = e / kDim * 8;
    const uint4 v = w4[k * (kDim / 8) + n0 / 8];
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) *wt_at(k, n0 + j) = h[j];
  }
  // the generic-proxy stores, made visible to wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;   // fragment row group, column pair
  const int r0 = blockIdx.x * kRowsPerBlock + warp * 16;
  const bool live = r0 < m;               // m % 16 == 0: all 16 rows or none

  // A fragments of the warp's 16 rows, one per k16 tile: registers
  // {rows g, g+8} x {columns 2q, 2q+1, 2q+8, 2q+9} of the tile
  const uint32_t* a32 = reinterpret_cast<const uint32_t*>(a);
  Frag af;
#pragma unroll
  for (int kt = 0; kt < kKTiles; ++kt) {
    const int col = kt * 16 + 2 * q;
    af[kt][0] = live ? a32[((r0 + g) * kDim + col) / 2] : 0u;
    af[kt][1] = live ? a32[((r0 + g + 8) * kDim + col) / 2] : 0u;
    af[kt][2] = live ? a32[((r0 + g) * kDim + col + 8) / 2] : 0u;
    af[kt][3] = live ? a32[((r0 + g + 8) * kDim + col + 8) / 2] : 0u;
  }

  if (reps > 0) {
    const uint64_t base = b_desc(base_addr);
    Acc acc0, acc1;
    issue_phase<0>(acc0, af, base);
    issue_phase<1>(acc0, af, base);
    int r = 1;
    for (; r + 1 < reps; r += 2) {
      rep(acc1, acc0, af, base);
      rep(acc0, acc1, af, base);
    }
    if (r < reps) {
      rep(acc1, acc0, af, base);
      finish(acc1, af);
    } else {
      finish(acc0, af);
    }
  }
  if (!live) return;

  float2* o2 = reinterpret_cast<float2*>(out);
#pragma unroll
  for (int kt = 0; kt < kKTiles; ++kt) {
    const int col = kt * 16 + 2 * q;
    o2[((r0 + g) * kDim + col) / 2] = unpack_bf16(af[kt][0]);
    o2[((r0 + g + 8) * kDim + col) / 2] = unpack_bf16(af[kt][1]);
    o2[((r0 + g) * kDim + col + 8) / 2] = unpack_bf16(af[kt][2]);
    o2[((r0 + g + 8) * kDim + col + 8) / 2] = unpack_bf16(af[kt][3]);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). a: bf16[m, 128], w: bf16[128,
// 128], out: f32[m, 128], all row-major and 16-byte aligned; m % 16 == 0.
// Launches on `stream` and does not synchronise; returns
// cudaGetLastError() of the launch.
extern "C" int hs_matmul_stationary(const void* a, const void* w, void* out,
                                    int m, int reps, void* stream) {
  if (m <= 0) return 0;
  matmul_stationary_kernel<<<(m + kRowsPerBlock - 1) / kRowsPerBlock,
                             kThreads, kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(w), static_cast<float*>(out), m,
      reps);
  return static_cast<int>(cudaGetLastError());
}
