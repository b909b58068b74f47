// Chained take-along-axis over the tiles of a resident operand, for Hopper
// (sm_90a): the gather cost probe.
//
// Replaces two Pallas TPU probes of tools/probe_pallas.py, which compute
// one function: gather_tiles (call :86, kernel :73-84) over T static
// [th, tw] tiles, and gather_big (call :116, kernel :106-114), which is
// gather_tiles with one tile (tile_rows = p.shape[0]). With
// mod = (axis == 1 ? tw : th), acc = 0 and, for rep i = 0 .. reps-1,
// element (r, c) of tile t:
//   ix  = (idx[t][r][c] + i) mod mod
//   (s) = (r, ix) on axis 1, (ix, c) on axis 0
//   acc[t][r][c] += p[t][s] + acc[0][s] * 1e-30
// where acc[0] is the FIRST tile's accumulator of rep i-1 (the probe adds
// acc[:th] to every tile). The f32 expression order is the probe's, with
// the product and the adds as explicit __fmul_rn / __fadd_rn, so the
// result is the plain version's bit for bit. The 1e-30 term is kept: it
// is the loop-carried dependency the probe measures, and it changes the
// result where p[s] is 0.
//
// Design: the chain unit is a LINE of tile 0 -- a row on axis 1, a column
// on axis 0 -- because a gather never leaves its line: rep i of element
// (line u, position q) reads only line u of tile 0's rep i-1. In line
// coordinates both axes are one function (a line of length L = mod, the
// gathered position s = (idx + i) mod L within it), so one kernel serves
// both; only the staging address differs. One warp holds one line (L > 32:
// lane l holds positions l, l+32, ..., K = 2, 4 or 8 a lane) or 32 / L
// whole lines (L <= 32: one position a lane), so every exchange stays
// inside the warp and the rep loop has no block barrier.
//
// A warp works for one tile t. For t = 0 it runs tile 0's lines; for
// t > 0 it runs the same lines of tile 0 again beside tile t's, reading
// the exchanged tile-0 values at tile t's own indices. The recomputation
// (K elements a lane) is cheaper than any wait on another warp, so no
// warp waits for another. Blocks are as small as the grid allows (one warp
// unless there are more than 32 warps per SM to place), so the probes'
// 512 (64 [8,128] tiles, axis 1), 2048 (axis 0), 32 and 256 warps spread
// over the card's SMs.
//
// The exchange, by line length (one kernel, K a template argument):
//  * L <= 32 (one position a lane): __shfl_sync from the lane that holds
//    the gathered position, for tile 0's accumulator and for p, so a rep
//    needs no store and no __syncwarp. On an H100 SXM this read 49 and
//    23 ns a rep (64 [8,128] tiles and one [32,256] operand, axis 0)
//    where a double-buffered shared-memory exchange read 107 and 56.
//  * L > 32 (K = 2, 4, 8 a lane): a warp-private, double-buffered line in
//    shared memory (read rep i-1's buffer, write rep i's), one __syncwarp
//    a rep. Shuffles cost K per gathered value here (a shuffle moves one
//    register slot, then a select), so 2 K^2 a lane and rep; shared
//    memory costs one load per gathered value at any length. Each slot
//    holds {p, accumulator} (one 8-byte load gathers both), and the buffer
//    is rotated (chain_shared) so that every gather reads a fixed address.
// A rep issues all its loads before its arithmetic and stores: the
// compiler does not move a shared load above an earlier shared store, so
// a load-compute-store sequence per element would run the K elements one
// after another.
//
// What bounds it on the card: the chain. One rep is the exchange (a
// shuffle, or a store, __syncwarp and a load), a multiply and two adds,
// in order, for every rep; a rep's independent work is a few gathers a
// lane. A one-warp line of 256 issues ~100 instructions a rep on one
// scheduler; where many warps share an SM (the 64-tile probe) the
// shared-memory pipe adds its own limit: random gathers within a line
// meet bank conflicts. The bound the repo reports is 3 f32 operations per
// element and rep over the f32 peak, and the operand, indices and output
// moved once; chip_smoke.py puts the chain floor beside it.
//
// Lines longer than 256 (take_along_long_kernel): one block of up to
// 1024 threads owns one line of tile 0 (and, for t > 0, the same line of
// tile t, with tile 0's recomputed beside it as the warp path does). The
// line's state lives in shared memory: p of tile 0 and of tile t, tile
// 0's accumulator double-buffered (read rep i-1's, write rep i's), tile
// t's accumulator, and both tiles' indices mod L: 7 words, 28 bytes a
// position. A thread walks its positions (q = thread, thread + block
// size, ...), and a rep ends with one __syncthreads(). This path is for
// correctness: every input the plain version takes up to the limit is
// computed here as there; its speed is recorded, not targeted.
//
// Limit: a line of at most kMaxLine = 8,192 positions, 224 KB of the 227
// KB of shared memory a block may hold (the TPU probe, too, holds its
// whole operand in VMEM). The number of lines, and so the tile size, is
// free.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxPerLane = 8;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kMaxLine = 8192;         // the long path's shared-memory line
constexpr int kLongThreads = 1024;
constexpr int kLongWordsPerPos = 7;
constexpr int kMaxBlocksPerSm = 32;   // Hopper's resident-block limit
constexpr float kTiny = 1e-30f;

__device__ __forceinline__ int floor_mod(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

// 8-byte shared-memory accesses at 32-bit shared addresses. Volatile, so
// they stay in program order with each other and with __syncwarp.
__device__ __forceinline__ float2 load2(unsigned addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void store2(unsigned addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x),
               "f"(y)
               : "memory");
}

// The rep loop of a warp whose line is longer than 32 (K positions a
// lane), exchanged through shared memory. Each buffer holds, per line
// position, the pair {p, tile 0's accumulator}: buffers `a` (at shared
// address a, two of kBuf bytes) for tile 0's gathers, and `b` (at a +
// 2 kBuf) = {tile t's p, tile 0's accumulator} for tile t's. The buffers
// are ROTATED: in the buffer rep i reads, logical position s sits at slot
// (s - i) mod L, so the position a lane gathers, (idx + i) mod L, is
// always slot idx mod L: every gather is one 8-byte load (p and the
// accumulator together) at a fixed address plus the buffer's, and only
// the slot an element stores into, (q - i - 1) mod L, steps once per rep.
// rd0, rdt, wr: byte offsets within a buffer; last: slot L - 1's. A rep
// issues its loads first, then the arithmetic and the stores.
template <int K, bool OWN>
__device__ __forceinline__ void chain_shared(
    unsigned a, const bool (&live)[K], const unsigned (&rd0)[K],
    const unsigned (&rdt)[K], unsigned (&wr)[K], const float (&q0)[K],
    const float (&qt)[K], float (&a0)[K], float (&at)[K], unsigned last,
    int reps) {
  constexpr unsigned kBuf = kWarp * K * sizeof(float2);
  for (int i = 0; i < reps; ++i) {
    const unsigned cur = a + (i & 1) * kBuf, nxt = a + kBuf - (i & 1) * kBuf;
    float2 g0[K], gt[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      g0[k] = load2(cur + rd0[k]);
      if (OWN) gt[k] = load2(cur + 2 * kBuf + rdt[k]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      a0[k] = __fadd_rn(a0[k], __fadd_rn(g0[k].x, __fmul_rn(g0[k].y, kTiny)));
      if (OWN) {
        at[k] = __fadd_rn(at[k],
                          __fadd_rn(gt[k].x, __fmul_rn(gt[k].y, kTiny)));
      }
      wr[k] = wr[k] == 0 ? last : wr[k] - sizeof(float2);
      if (live[k]) {
        store2(nxt + wr[k], q0[k], a0[k]);
        if (OWN) store2(nxt + 2 * kBuf + wr[k], qt[k], a0[k]);
      }
    }
    __syncwarp();
  }
}

// The rep loop of a warp whose lines are at most 32 long (one position a
// lane): every value is gathered from its lane by a shuffle, so the rep
// needs no store and no __syncwarp. Lanes outside the warp's lines run
// along (a shuffle needs every lane) and are never gathered from.
template <bool OWN>
__device__ __forceinline__ void chain_shfl(float p0, float pt, int base,
                                           int ix0, int ixt, float& a0,
                                           float& at, int len, int reps) {
  constexpr unsigned kAll = 0xffffffffu;
  for (int i = 0; i < reps; ++i) {
    const float c0 = __shfl_sync(kAll, a0, base + ix0);
    const float q0 = __shfl_sync(kAll, p0, base + ix0);
    if (OWN) {
      const float ct = __shfl_sync(kAll, a0, base + ixt);
      const float qt = __shfl_sync(kAll, pt, base + ixt);
      at = __fadd_rn(at, __fadd_rn(qt, __fmul_rn(ct, kTiny)));
      ixt = ixt + 1 == len ? 0 : ixt + 1;
    }
    a0 = __fadd_rn(a0, __fadd_rn(q0, __fmul_rn(c0, kTiny)));
    ix0 = ix0 + 1 == len ? 0 : ix0 + 1;
  }
}

template <int K>
__global__ void __launch_bounds__(kWarp * kMaxWarpsPerBlock)
take_along_kernel(const float* __restrict__ p, const int* __restrict__ idx,
                  float* __restrict__ out, int tiles, int th, int tw,
                  int reps, int axis, int lines_per_warp,
                  int warps_per_tile) {
  extern __shared__ float2 smem[];   // 4 buffers of 32 K pairs a warp
  constexpr int kSlots = kWarp * K;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long w =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (w >= static_cast<long long>(tiles) * warps_per_tile) return;  // whole warp
  const int t = static_cast<int>(w / warps_per_tile);
  const int first_line = static_cast<int>(w % warps_per_tile) * lines_per_warp;
  const int len = axis == 1 ? tw : th;
  const int lines = axis == 1 ? th : tw;
  const long long n = static_cast<long long>(th) * tw;

  // slot e = lane + 32 k of the warp's lines: line e / len, position q
  bool live[K];
  int base[K], ix0[K], ixt[K];
  long long at_elem[K];
  float a0[K], at[K], q0[K], qt[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = lane + kWarp * k;
    const int line = e / len, q = e - line * len;
    const int u = first_line + line;
    live[k] = line < lines_per_warp && u < lines;
    base[k] = line * len;
    ix0[k] = ixt[k] = 0;
    a0[k] = at[k] = q0[k] = qt[k] = 0.f;
    at_elem[k] = 0;
    if (live[k]) {
      const long long el = axis == 1 ? static_cast<long long>(u) * tw + q
                                     : static_cast<long long>(q) * tw + u;
      at_elem[k] = static_cast<long long>(t) * n + el;
      ix0[k] = floor_mod(idx[el], len);
      ixt[k] = floor_mod(idx[at_elem[k]], len);
      q0[k] = p[el];
      qt[k] = p[at_elem[k]];
    }
  }

  if (K == 1) {
    if (t == 0) {
      chain_shfl<false>(q0[0], qt[0], base[0], ix0[0], ixt[0], a0[0], at[0],
                        len, reps);
    } else {
      chain_shfl<true>(q0[0], qt[0], base[0], ix0[0], ixt[0], a0[0], at[0],
                       len, reps);
    }
  } else {
    // one line a warp (base 0, q = e): rep 0 reads buffer 0 unrotated
    constexpr unsigned kBuf = kWarp * K * sizeof(float2);
    const unsigned a =
        static_cast<unsigned>(__cvta_generic_to_shared(smem)) + warp * 4 * kBuf;
    unsigned rd0[K], rdt[K], wr[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      rd0[k] = ix0[k] * sizeof(float2);
      rdt[k] = ixt[k] * sizeof(float2);
      wr[k] = (lane + kWarp * k) * sizeof(float2);
      if (live[k]) {
        store2(a + wr[k], q0[k], 0.f);
        store2(a + 2 * kBuf + wr[k], qt[k], 0.f);
      }
    }
    __syncwarp();
    const unsigned last = (len - 1) * sizeof(float2);
    if (t == 0) {
      chain_shared<K, false>(a, live, rd0, rdt, wr, q0, qt, a0, at, last,
                             reps);
    } else {
      chain_shared<K, true>(a, live, rd0, rdt, wr, q0, qt, a0, at, last,
                            reps);
    }
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (live[k]) out[at_elem[k]] = t == 0 ? a0[k] : at[k];
  }
}

template <int K>
cudaError_t launch(const float* p, const int* idx, float* out, int tiles,
                   int th, int tw, int reps, int axis, cudaStream_t stream) {
  const int len = axis == 1 ? tw : th;
  const int lines = axis == 1 ? th : tw;
  const int lines_per_warp = len < kWarp ? kWarp / len : 1;
  const int warps_per_tile = (lines + lines_per_warp - 1) / lines_per_warp;
  const long long warps = static_cast<long long>(tiles) * warps_per_tile;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // the fewest warps per block that place every warp in one wave
  const long long resident = static_cast<long long>(sms) * kMaxBlocksPerSm;
  long long per_block = (warps + resident - 1) / resident;
  if (per_block > kMaxWarpsPerBlock) per_block = kMaxWarpsPerBlock;
  const long long blocks = (warps + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int threads = static_cast<int>(per_block) * kWarp;
  const size_t smem = K == 1 ? 0 : static_cast<size_t>(per_block) * 4 *
                                      kWarp * K * sizeof(float2);
  err = cudaFuncSetAttribute(take_along_kernel<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  take_along_kernel<K><<<static_cast<unsigned>(blocks), threads, smem,
                         stream>>>(p, idx, out, tiles, th, tw, reps, axis,
                                   lines_per_warp, warps_per_tile);
  return cudaGetLastError();
}

// One block per (tile t, line u) of a line longer than 256 positions.
// Shared memory per position q of the line: p0, pt (p of tiles 0 and t),
// two buffers of tile 0's accumulator, tile t's accumulator, s0, st (the
// tiles' indices mod L). Rep i gathers position (s + i) mod L.
__global__ void __launch_bounds__(kLongThreads)
take_along_long_kernel(const float* __restrict__ p, const int* __restrict__ idx,
                       float* __restrict__ out, int th, int tw, int reps,
                       int axis) {
  extern __shared__ float line_smem[];
  const int len = axis == 1 ? tw : th;
  const int lines = axis == 1 ? th : tw;
  const int u = static_cast<int>(blockIdx.x % lines);
  const int t = static_cast<int>(blockIdx.x / lines);
  const long long n = static_cast<long long>(th) * tw;
  const long long tile = static_cast<long long>(t) * n;
  float* p0 = line_smem;
  float* pt = p0 + len;
  float* buf = pt + len;   // two buffers of len
  float* at = buf + 2 * len;
  int* s0 = reinterpret_cast<int*>(at + len);
  int* st = s0 + len;
  for (int q = threadIdx.x; q < len; q += blockDim.x) {
    const long long el = axis == 1 ? static_cast<long long>(u) * tw + q
                                   : static_cast<long long>(q) * tw + u;
    p0[q] = p[el];
    s0[q] = floor_mod(idx[el], len);
    buf[q] = 0.f;
    if (t > 0) {
      pt[q] = p[tile + el];
      st[q] = floor_mod(idx[tile + el], len);
      at[q] = 0.f;
    }
  }
  __syncthreads();
  for (int i = 0, ir = 0; i < reps; ++i, ir = ir + 1 == len ? 0 : ir + 1) {
    const float* cur = buf + (i & 1) * len;
    float* nxt = buf + len - (i & 1) * len;
    for (int q = threadIdx.x; q < len; q += blockDim.x) {
      int s = s0[q] + ir;
      if (s >= len) s -= len;
      nxt[q] = __fadd_rn(cur[q], __fadd_rn(p0[s], __fmul_rn(cur[s], kTiny)));
      if (t > 0) {
        s = st[q] + ir;
        if (s >= len) s -= len;
        at[q] = __fadd_rn(at[q], __fadd_rn(pt[s], __fmul_rn(cur[s], kTiny)));
      }
    }
    __syncthreads();
  }
  const float* fin = buf + (reps & 1) * len;
  for (int q = threadIdx.x; q < len; q += blockDim.x) {
    const long long el = axis == 1 ? static_cast<long long>(u) * tw + q
                                   : static_cast<long long>(q) * tw + u;
    out[tile + el] = t == 0 ? fin[q] : at[q];
  }
}

cudaError_t launch_long(const float* p, const int* idx, float* out, int tiles,
                        int th, int tw, int reps, int axis,
                        cudaStream_t stream) {
  const int len = axis == 1 ? tw : th;
  const int lines = axis == 1 ? th : tw;
  if (len > kMaxLine) return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(tiles) * lines;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int threads = len < kLongThreads ? (len + kWarp - 1) / kWarp * kWarp
                                         : kLongThreads;
  const size_t smem = static_cast<size_t>(kLongWordsPerPos) * len * 4;
  cudaError_t err = cudaFuncSetAttribute(
      take_along_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  take_along_long_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                           stream>>>(p, idx, out, th, tw, reps, axis);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). p, idx, out: [tiles * th, tw]
// row-major; the gathered axis (tw on axis 1, th on axis 0) at most
// kMaxLine = 8,192 (lines of at most 256 take the warp path, longer ones
// the block path).
// Launches on `stream` and does not synchronise; returns the CUDA error of
// the set-up or the launch.
extern "C" int hs_take_along(const void* p, const void* idx, void* out,
                             int tiles, int th, int tw, int reps, int axis,
                             void* stream) {
  if (tiles <= 0 || th <= 0 || tw <= 0) return 0;
  const int len = axis == 1 ? tw : th;
  const auto* pf = static_cast<const float*>(p);
  const auto* ix = static_cast<const int*>(idx);
  auto* of = static_cast<float*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (len <= kWarp) {
    err = launch<1>(pf, ix, of, tiles, th, tw, reps, axis, st);
  } else if (len <= 2 * kWarp) {
    err = launch<2>(pf, ix, of, tiles, th, tw, reps, axis, st);
  } else if (len <= 4 * kWarp) {
    err = launch<4>(pf, ix, of, tiles, th, tw, reps, axis, st);
  } else if (len <= kMaxPerLane * kWarp) {
    err = launch<8>(pf, ix, of, tiles, th, tw, reps, axis, st);
  } else {
    err = launch_long(pf, ix, of, tiles, th, tw, reps, axis, st);
  }
  return static_cast<int>(err);
}
