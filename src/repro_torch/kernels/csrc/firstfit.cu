// firstfit: per row of an ELL slab of neighbor colors, the smallest positive
// color absent from the row (the paper's Alg. 1 lines 5-6).
//
// Replaces the Pallas TPU kernel src/repro/kernels/firstfit.py::firstfit
// (body _firstfit_kernel), which tiles the slab into (BV, BD) VMEM blocks and
// carries a [BV, W] bitset scratch across the sequential slot-tile axis.
//
// Bound on an H100 SXM: the slab is read once and the mex written once,
// 4*V*D + 4*V bytes at 3.35 TB/s (0.200 ms at [4,194,304 x 39]). The bit
// arithmetic per entry (a compare, a shift, an OR) is far below it. So the
// design is about bytes in flight: at ~1 us of load latency the card needs
// ~25 KB in flight per SM to stream at its rate.
//
// Design (bitset.cuh holds it, shared with round_fused.cu): a persistent
// grid of 2 blocks per SM walks the slab in tiles of R rows (R = 256 at the
// engines' stride of 40: 40 KB). Thread 0 of a block issues each tile as a
// 1-D bulk async copy into a ring of shared-memory stages, each with its
// own mbarrier, so one tile streams in while the block works on the last.
// On the narrow path (W <= 8) a group of 4 lanes takes a row (8 rows per
// warp at D <= 64), each lane ORs its colors into 64-bit registers with
// one clamped shift per color, and a shuffle tree ORs the group's words;
// the first clear bit is one __ffs per word. Mex values leave one tile at
// a time, coalesced.
//
// Limits of each path:
//  * narrow, bulk: W <= 8, slab base 16-byte aligned, row stride at most
//    D/4 + 16 words past D (the copy reads the gap), two stages of at
//    least 4 rows fit in 100 KB. The last tile copies up to its last
//    16-byte boundary and loads the rest with plain loads, so a contiguous
//    [V, D] tensor is never read past its end.
//  * wide (W > 8): one warp per row, the W-word bitset in shared memory;
//    bulk tiles of ~64 KB (8 rows at D = 2000) when two stages fit in the
//    block's shared memory next to the bitsets.
//  * plain: anything else (a misaligned base, a wide row gap, rows too
//    long for two stages) reads the rows straight from global memory with
//    the same row code.
// Any V, any D >= 1, any row stride >= D, and any W whose bitset fits in
// a block's shared memory (the wrapper checks it).
#include "bitset.cuh"

namespace repro_torch {
cudaError_t firstfit_attributes(int W, int D, cudaFuncAttributes* attr, int* threads) {
  return slab_attributes<false>(W, D, attr, threads);
}
}  // namespace repro_torch

extern "C" int repro_firstfit(const void* nbr, long long stride, int V, int D, int W,
                              void* out, void* stream) {
  using namespace repro_torch;
  SlabArgs a{};
  a.slab = static_cast<const int*>(nbr);
  a.stride = stride;
  a.mex = static_cast<int*>(out);
  a.V = V;
  a.D = D;
  a.W = W;
  return static_cast<int>(launch_slab_rows<false>(a, static_cast<cudaStream_t>(stream)));
}
