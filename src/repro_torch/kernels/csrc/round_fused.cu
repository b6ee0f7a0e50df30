// round_fused: one read of a packed ELL slab gives, per row, the mex over
// its FORBID entries AND the Alg. 2 conflict flag (some CONFLICT entry's
// color equals the row's own color > 0).
//
// Replaces the Pallas TPU kernel src/repro/kernels/round_fused.py::round_fused
// (body _round_fused_kernel). Packed entry: bits 0-27 color, bit 28 FORBID,
// bit 29 CONFLICT; entries with neither bit are inert.
//
// Bound on an H100 SXM: 4*V*D bytes of slab + 4*V of own colors read once,
// 8*V bytes of mex and flag written once, at 3.35 TB/s (0.210 ms at
// [4,194,304 x 39]).
//
// Design: firstfit.cu's (bitset.cuh): a persistent grid, R-row tiles fed
// into a ring of shared-memory stages by 1-D bulk async copies, 4 lanes per
// row with the bitset in registers on the narrow path (W <= 8), one warp
// per row with a shared bitset on the wide path. The tile's own colors
// come in with the same bulk copy (one more span of R words on the same
// mbarrier). An entry's shift is (entry & (color | FORBID)) - FORBID, which
// is out of range, and so marks nothing, when FORBID is clear. Each lane
// keeps a conflict bit beside its bitset words; one __ballot_sync gives
// every row group its flag, so the detect costs no extra pass over the
// slab. Mex and flag leave one tile at a time, coalesced.
//
// Limits: firstfit.cu's, and the bulk path also needs the own colors'
// base 16-byte aligned (else the plain path reads them from global memory).
#include "bitset.cuh"

extern "C" int repro_round_fused(const void* ent, long long stride, const void* own, int V,
                                 int D, int W, void* mex, void* conflict, void* stream) {
  using namespace repro_torch;
  SlabArgs a{};
  a.slab = static_cast<const int*>(ent);
  a.stride = stride;
  a.own = static_cast<const int*>(own);
  a.mex = static_cast<int*>(mex);
  a.conflict = static_cast<int*>(conflict);
  a.V = V;
  a.D = D;
  a.W = W;
  return static_cast<int>(launch_slab_rows<true>(a, static_cast<cudaStream_t>(stream)));
}
