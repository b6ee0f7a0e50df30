// The design both ELL-slab kernels share (firstfit.cu, round_fused.cu):
// a persistent grid walks the slab in tiles of R rows, a ring of shared-
// memory stages is fed by 1-D bulk async copies, and each row's forbidden
// bitset lives in registers (W <= 8 words) or in shared memory (W > 8).
//
// Tiles. R rows of a row-strided [V, D] view are one contiguous span of
// R*S int32 (S = row stride >= D). The engines hand in the [:V, :D] view
// of a (V+1, D+1) slab, so S = D + 1 and the sink column rides along in the
// copy and is simply not read. R is a multiple of 4, so every tile starts
// 16 bytes after the last one's start. Each block takes tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...; the grid is the occupancy API's blocks per
// SM times the SM count.
//
// Two ways to bring a tile in:
//  * bulk (base pointers 16-byte aligned): thread 0 issues
//    cp.async.bulk of the span into stage s of a ring of 2-4 stages, each
//    with its own mbarrier (complete_tx counts the bytes). The copy of
//    tile i+ring is issued as soon as every thread is done with tile i, so
//    ring-1 tiles are in flight while one is processed. The last tile of a
//    contiguous S = D tensor has no sink row behind it: its span is copied
//    up to the last 16-byte boundary and the 0-3 words after it are loaded
//    by thread 0 with plain loads before it arrives on the barrier.
//  * plain (a misaligned base, or rows too wide for two stages): the rows
//    are read straight from global memory, lanes on neighbouring words.
//
// Rows. Narrow path (W <= 8): a group of G lanes takes a row (G = 4 for
// D <= 64, so 8 rows per warp; else G = 32). Lane k reads words k, k+G, ...
// < D and ORs each color into kP 64-bit registers (kP = 1, 2, 4 for W <= 2,
// 4, 8) with one shift per pair: PTX clamps a shift of 64 or more to a zero
// result, so negative and too-large colors drop with no compare. log2(G)
// __shfl_xor_sync steps per word OR the group's words together, and the
// group's first lane takes __ffs(~word) over them: no shared bitset, no
// atomic. At S = 40 the eight groups of a warp meet in pairs on the same
// banks (a two-way conflict); that costs less than the extra shuffle round
// and the per-pass work of G = 8, which has none.
// Wide path (W > 8): one warp per row, the W-word bitset in shared memory
// (atomicOr marks, then a __ffs scan with a warp min-reduce). A mark skips
// color 0 (preset) and any bit already set, so the empty slots and the few
// colors of a high-degree row do not queue atomics on one word.
//
// Results go to a per-stage stash in shared memory and leave one tile at a
// time with coalesced stores, after the block barrier that ends the tile.
//
// Drop rule (both paths, the reference kernel's semantics): colors < 0 or
// >= 32*W change nothing; color 0 is always forbidden; a row whose 32*W
// bits are all set has mex INT_MAX.
#pragma once

#include <climits>
#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;            // threads per block, both paths
constexpr int kNarrowMaxWords = 8;       // W above this takes the wide path
constexpr int kMaxStages = 4;
constexpr int kBarrierBytes = 128;       // mbarriers at the head of smem
constexpr int kMaxTileRows = 1024;
constexpr int kNarrowStageBytes = 40 << 10;  // ~40 KB of slab per stage
constexpr int kWideStageBytes = 64 << 10;    // ~8 rows at D = 2000
constexpr int kNarrowSmemBudget = 100 << 10; // two blocks fit on an SM

// packed round_fused entries: bits 0-27 color, bit 28 FORBID, bit 29 CONFLICT
constexpr int kColorMask = (1 << 28) - 1;
constexpr int kForbidBit = 1 << 28;
constexpr int kConflictBit = 1 << 29;

struct SlabArgs {
  const int* slab;   // row r starts at slab + r * stride
  long long stride;  // S >= D
  const int* own;    // round_fused: [V] own colors
  int* mex;          // [V]
  int* conflict;     // round_fused: [V]
  int V, D, W;
  int tile_rows;     // R, a multiple of 4
  int stages;        // ring depth on the bulk path (>= 2), 0 on the plain path
  int num_tiles;
};

__host__ __device__ inline long long round4(long long n) { return (n + 3) & ~3LL; }

// int32 words of one ring stage: the slab span and the own colors (bulk
// path only), then the mex and conflict stash.
__host__ __device__ inline long long stage_words(int R, long long S, bool bulk,
                                                 bool fused) {
  long long n = fused ? 2LL * R : R;
  if (bulk) n += round4(R * S) + (fused ? R : 0);
  return n;
}

// ---- PTX wrappers: mbarriers and the 1-D bulk copy ----------------------
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- bringing a tile into its stage (thread 0 only) -----------------------
// Copy `n` words from src to dst: the 16-byte part in bulk, the 0-3 words
// after it with plain loads. Returns the bytes the bulk copy will deliver.
__device__ __forceinline__ unsigned stage_span(int* dst, const int* src, long long n) {
  const long long nb = n & ~3LL;
  for (long long k = nb; k < n; ++k) dst[k] = __ldg(src + k);
  return static_cast<unsigned>(nb * 4);
}

template <bool kFused>
__device__ void issue_tile(const SlabArgs& a, int t, int* st, uint64_t* bar) {
  const int R = a.tile_rows;
  const long long r0 = static_cast<long long>(t) * R;
  const int nrows = static_cast<int>(min(static_cast<long long>(R), a.V - r0));
  const int* src = a.slab + r0 * a.stride;
  // whole rows, except that the last tile stops at the view's last word
  const long long n = (r0 + nrows < a.V) ? nrows * a.stride
                                         : (nrows - 1) * a.stride + a.D;
  const unsigned bytes = stage_span(st, src, n);
  int* own_st = st + round4(R * a.stride);
  unsigned own_bytes = 0;
  if (kFused) own_bytes = stage_span(own_st, a.own + r0, nrows);
  // the plain stores above are released to the waiting threads by this
  // arrive; the fence orders the earlier tile's shared reads before the
  // async proxy writes this stage again
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  mbar_arrive_expect_tx(bar, bytes + own_bytes);
  if (bytes) bulk_copy(st, src, bytes, bar);
  if (own_bytes) bulk_copy(own_st, a.own + r0, own_bytes, bar);
}

// ---- the rows of one tile ----------------------------------------------
// 1 << s in 64 bits. PTX clamps a shift of 64 or more to 64, so s >= 64,
// and a negative color seen as unsigned, give 0: the drop rule for free.
__device__ __forceinline__ uint64_t bit64(unsigned s) {
  uint64_t r;
  asm("shl.b64 %0, %1, %2;" : "=l"(r) : "l"(1ull), "r"(s));
  return r;
}

// OR of v over the kG lanes of this lane's row group.
template <int kG>
__device__ __forceinline__ unsigned group_or(unsigned v) {
#pragma unroll
  for (int off = kG / 2; off > 0; off >>= 1) v |= __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// The packed-entry value a CONFLICT entry equals, masked to its CONFLICT
// bit and color field, when it matches the row's own color; -1 (never
// equal) for an uncolored row or an own color outside the color field.
__device__ __forceinline__ int conflict_key(int mine) {
  return (mine > 0 && mine <= kColorMask) ? (kConflictBit | mine) : -1;
}

// Narrow path: kG lanes per row, the bitset in kP 64-bit registers per
// lane (words 2q and 2q+1 in pair q). Colors in words >= W may set bits
// there; the scan never reads those words, so they drop as the rule says.
template <int kP, int kG, bool kFused>
__device__ __forceinline__ void narrow_rows(const SlabArgs& a, const int* rows,
                                            const int* own, int nrows, int* stash) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int k = lane & (kG - 1);
  const int per_pass = blockDim.x / kG;
  constexpr unsigned group = (kG == kWarp) ? kFullMask : ((1u << kG) - 1u);
  for (int p = 0; p < nrows; p += per_pass) {  // block-uniform
    const int lr = p + static_cast<int>(threadIdx.x) / kG;
    const bool live = lr < nrows;
    uint64_t bits[kP];
#pragma unroll
    for (int q = 0; q < kP; ++q) bits[q] = (q == 0) ? 1ull : 0ull;  // color 0
    bool hit = false;
    if (live) {
      const int* row = rows + lr * a.stride;
      const int key = kFused ? conflict_key(own[lr]) : 0;
      for (int j = k; j < a.D; j += kG) {
        const int e = row[j];
        // firstfit marks the color itself; round_fused marks the color of
        // a FORBID entry: without the bit, color - 2^28 is a huge shift
        const unsigned s = kFused ? static_cast<unsigned>((e & (kColorMask | kForbidBit)) -
                                                          kForbidBit)
                                  : static_cast<unsigned>(e);
        if (kFused) hit |= (e & (kConflictBit | kColorMask)) == key;
#pragma unroll
        for (int q = 0; q < kP; ++q) bits[q] |= bit64(s - 64u * q);
      }
    }
    unsigned words[2 * kP];
#pragma unroll
    for (int q = 0; q < kP; ++q) {
      words[2 * q] = group_or<kG>(static_cast<unsigned>(bits[q]));
      words[2 * q + 1] = group_or<kG>(static_cast<unsigned>(bits[q] >> 32));
    }
    const unsigned hits = kFused ? __ballot_sync(kFullMask, hit) : 0u;
    if (live && k == 0) {
      int m = INT_MAX;
#pragma unroll
      for (int w = 2 * kP - 1; w >= 0; --w)
        if (w < a.W && ~words[w]) m = w * 32 + __ffs(~words[w]) - 1;
      stash[lr] = m;
      if (kFused) stash[a.tile_rows + lr] = ((hits >> lane) & group) ? 1 : 0;
    }
  }
}

// Wide path: one warp per row, the W-word bitset in shared memory.
template <bool kFused>
__device__ __forceinline__ void wide_rows(const SlabArgs& a, const int* rows,
                                          const int* own, int nrows, int* stash,
                                          unsigned* forb) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int warps = blockDim.x / kWarp;
  const int W = a.W;
  const unsigned limit = 32u * static_cast<unsigned>(W);
  for (int lr = threadIdx.x / kWarp; lr < nrows; lr += warps) {  // warp-uniform
    for (int w = lane; w < W; w += kWarp) forb[w] = (w == 0) ? 1u : 0u;
    __syncwarp();
    const int* row = rows + lr * a.stride;
    const int key = kFused ? conflict_key(own[lr]) : 0;
    bool hit = false;
    auto visit = [&](int e) {
      const unsigned c = kFused ? static_cast<unsigned>((e & (kColorMask | kForbidBit)) - kForbidBit)
                                : static_cast<unsigned>(e);
      if (kFused) hit |= (e & (kConflictBit | kColorMask)) == key;
      // color 0 is preset; a bit already set needs no atomic (empty slots
      // and the few colors of a high-degree row would all hit one word)
      if (c - 1u < limit - 1u) {
        const unsigned bit = 1u << (c & 31);
        if (!(forb[c >> 5] & bit)) atomicOr(&forb[c >> 5], bit);
      }
    };
    // loads in batches of 8 ahead of their atomics (the compiler may not
    // move a load past an atomic to the same memory space)
    constexpr int kBatch = 8;
    int j = lane;
    for (; j + (kBatch - 1) * kWarp < a.D; j += kBatch * kWarp) {
      int e[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) e[u] = row[j + u * kWarp];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) visit(e[u]);
    }
    for (; j < a.D; j += kWarp) visit(row[j]);
    __syncwarp();
    int m = INT_MAX;
    for (int w0 = 0; w0 < W; w0 += kWarp) {  // first window with a clear bit
      const int w = w0 + lane;
      const unsigned free_bits = (w < W) ? ~forb[w] : 0u;
      m = __reduce_min_sync(kFullMask, free_bits ? (w * 32 + __ffs(free_bits) - 1) : INT_MAX);
      if (m != INT_MAX) break;
    }
    const bool any_hit = kFused && __any_sync(kFullMask, hit);
    if (lane == 0) {
      stash[lr] = m;
      if (kFused) stash[a.tile_rows + lr] = any_hit ? 1 : 0;
    }
    __syncwarp();
  }
}

// ---- the kernel -----------------------------------------------------------
// kP: the narrow path's 64-bit register pairs (1, 2, 4 for W <= 2, 4, 8),
// or 0 for the wide path; kG: lanes per row on the narrow path.
template <int kP, int kG, bool kFused, bool kBulk>
__global__ void __launch_bounds__(kThreads) slab_rows_kernel(const SlabArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int* ring = reinterpret_cast<int*>(smem + kBarrierBytes);
  const int R = a.tile_rows;
  const int depth = kBulk ? a.stages : 2;
  const long long sw = stage_words(R, a.stride, kBulk, kFused);
  unsigned* forb = reinterpret_cast<unsigned*>(ring + depth * sw) +
                   (threadIdx.x / kWarp) * static_cast<long long>(a.W);
  const long long slab_words = round4(R * a.stride);
  const long long stash_at = kBulk ? slab_words + (kFused ? R : 0) : 0;

  if constexpr (kBulk) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < depth; ++s) mbar_init(&bars[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int s = 0; s < depth; ++s) {
        const int t = blockIdx.x + s * gridDim.x;
        if (t < a.num_tiles) issue_tile<kFused>(a, t, ring + s * sw, &bars[s]);
      }
  }
  int i = 0;
  for (int t = blockIdx.x; t < a.num_tiles; t += gridDim.x, ++i) {
    const int s = i % depth;
    int* st = ring + s * sw;
    int* stash = st + stash_at;
    const long long r0 = static_cast<long long>(t) * R;
    const int nrows = static_cast<int>(min(static_cast<long long>(R), a.V - r0));
    const int* rows = a.slab + r0 * a.stride;
    const int* own = kFused ? a.own + r0 : nullptr;
    if constexpr (kBulk) {
      mbar_wait(&bars[s], (i / depth) & 1);
      rows = st;
      own = st + slab_words;
    }
    if constexpr (kP > 0)
      narrow_rows<kP, kG, kFused>(a, rows, own, nrows, stash);
    else
      wide_rows<kFused>(a, rows, own, nrows, stash, forb);
    __syncthreads();  // the stage is read and the stash complete
    if (kBulk && threadIdx.x == 0) {
      const int tn = t + depth * gridDim.x;
      if (tn < a.num_tiles) issue_tile<kFused>(a, tn, st, &bars[s]);
    }
    const int outs = kFused ? 2 * nrows : nrows;
    for (int j = threadIdx.x; j < outs; j += blockDim.x) {
      if (j < nrows)
        a.mex[r0 + j] = stash[j];
      else
        a.conflict[r0 + j - nrows] = stash[R + j - nrows];
    }
  }
}

// ---- the launcher ---------------------------------------------------------
struct DeviceInfo {
  int sms = 0;
  int max_smem = 0;  // dynamic shared memory a block may opt in to
};

// The device's SM count and opt-in shared memory, queried once per device.
inline cudaError_t device_info(int dev, DeviceInfo* out) {
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static DeviceInfo cache[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (cache[dev].sms == 0) {
    DeviceInfo info;
    cudaError_t err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&info.max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    cache[dev] = info;
  }
  *out = cache[dev];
  return cudaSuccess;
}

// Blocks of `fn` resident per SM at this block size and shared memory, from
// the occupancy API. The first call for a kernel on a device also raises its
// dynamic shared-memory limit to the opt-in maximum. Both are cached.
inline cudaError_t blocks_per_sm(const void* fn, int dev, int max_smem, int threads,
                                 size_t smem, int* out) {
  struct Entry {
    const void* fn;
    int dev, threads;
    size_t smem;
    int blocks;
  };
  constexpr int kEntries = 128;
  static std::mutex mu;
  static Entry cache[kEntries];
  static int used = 0;
  std::lock_guard<std::mutex> lock(mu);
  bool configured = false;
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.fn != fn || e.dev != dev) continue;
    configured = true;
    if (e.threads == threads && e.smem == smem) {
      *out = e.blocks;
      return cudaSuccess;
    }
  }
  cudaError_t err;
  if (!configured) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) return err;
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  if (err != cudaSuccess) return err;
  if (used < kEntries) cache[used++] = Entry{fn, dev, threads, smem, blocks};
  *out = blocks;
  return cudaSuccess;
}

template <int kP, int kG, bool kFused>
const void* kernel_for(bool bulk) {
  return bulk ? reinterpret_cast<const void*>(slab_rows_kernel<kP, kG, kFused, true>)
              : reinterpret_cast<const void*>(slab_rows_kernel<kP, kG, kFused, false>);
}

template <int kG, bool kFused>
const void* pick_narrow(int W, bool bulk) {
  if (W <= 2) return kernel_for<1, kG, kFused>(bulk);
  if (W <= 4) return kernel_for<2, kG, kFused>(bulk);
  return kernel_for<4, kG, kFused>(bulk);
}

template <bool kFused>
const void* pick_kernel(int W, int lanes, bool bulk) {
  if (W > kNarrowMaxWords) return kernel_for<0, kWarp, kFused>(bulk);
  return lanes == 4 ? pick_narrow<4, kFused>(W, bulk) : pick_narrow<kWarp, kFused>(W, bulk);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Choose the path, tile and ring for this slab and launch. Returns the
// launch's CUDA error; cudaErrorInvalidValue for arguments no path takes.
template <bool kFused>
cudaError_t launch_slab_rows(SlabArgs a, cudaStream_t stream) {
  if (a.V <= 0) return cudaSuccess;
  if (a.D <= 0 || a.W <= 0 || a.stride < a.D) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  DeviceInfo info;
  err = device_info(dev, &info);
  if (err != cudaSuccess) return err;

  const bool narrow = a.W <= kNarrowMaxWords;
  const int lanes = (narrow && a.D <= 64) ? 4 : kWarp;  // per row
  int threads = kThreads;
  size_t bitsets = 0;
  if (!narrow) {  // one W-word bitset per warp; fewer warps if they are large
    const long long per_warp = 4LL * a.W;
    long long warps = (info.max_smem - kBarrierBytes - 1024) / per_warp;
    if (warps < 1) return cudaErrorInvalidValue;
    if (warps > kThreads / kWarp) warps = kThreads / kWarp;
    threads = static_cast<int>(warps) * kWarp;
    bitsets = static_cast<size_t>(warps * per_warp);
  }
  // R: the stage's slab bytes near the target, in whole passes of the
  // block's rows, a multiple of 4, and small enough for two stages
  const int per_pass = threads / lanes;
  const long long row_bytes = 4 * a.stride;
  const long long target = narrow ? kNarrowStageBytes : kWideStageBytes;
  long long R = (target + row_bytes / 2) / row_bytes;
  R = (R + per_pass / 2) / per_pass * per_pass;
  if (R < per_pass) R = per_pass;
  R = round4(R);
  if (R > kMaxTileRows) R = kMaxTileRows;
  const long long budget =
      (narrow ? kNarrowSmemBudget : info.max_smem) - kBarrierBytes - static_cast<long long>(bitsets);
  while (R > 4 && 2 * 4 * stage_words(static_cast<int>(R), a.stride, true, kFused) > budget) R -= 4;
  a.tile_rows = static_cast<int>(R);

  // bulk copies need aligned bases, at least two stages, and rows whose
  // gap past D is small (the copy reads it too)
  const long long bulk_stage = 4 * stage_words(a.tile_rows, a.stride, true, kFused);
  long long stages = budget / bulk_stage;
  if (stages > kMaxStages) stages = kMaxStages;
  const bool bulk = aligned16(a.slab) && (!kFused || aligned16(a.own)) && stages >= 2 &&
                    a.stride - a.D <= 16 + a.D / 4;
  a.stages = bulk ? static_cast<int>(stages) : 0;
  const long long depth = bulk ? stages : 2;
  const size_t smem = kBarrierBytes + bitsets +
                      4 * depth * stage_words(a.tile_rows, a.stride, bulk, kFused);
  if (smem > static_cast<size_t>(info.max_smem)) return cudaErrorInvalidValue;

  const long long tiles = (static_cast<long long>(a.V) + R - 1) / R;
  a.num_tiles = static_cast<int>(tiles);
  const void* fn = pick_kernel<kFused>(a.W, lanes, bulk);
  int per_sm = 0;
  err = blocks_per_sm(fn, dev, info.max_smem, threads, smem, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long grid = static_cast<long long>(per_sm) * info.sms;
  if (grid > tiles) grid = tiles;
  void* args[] = {&a};
  err = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(grid)), dim3(threads), args, smem,
                         stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace repro_torch
