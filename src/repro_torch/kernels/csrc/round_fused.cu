// round_fused: one read of a packed ELL slab gives, per row, the mex over
// its FORBID entries AND the Alg. 2 conflict flag (some CONFLICT entry's
// color equals the row's own color > 0).
//
// Replaces the Pallas TPU kernel src/repro/kernels/round_fused.py::round_fused
// (body _round_fused_kernel). Packed entry: bits 0-27 color, bit 28 FORBID,
// bit 29 CONFLICT; entries with neither bit are inert.
//
// Bound on an H100 SXM: 4*V*D bytes of slab + 4*V of own colors read once,
// 8*V bytes of mex and flag written once, at 3.35 TB/s.
//
// Design: firstfit.cu's structure (one warp per row, lanes striding over the
// row, the W-word bitset in shared memory, __ffs + warp min-reduce), plus a
// per-lane conflict bit folded with __any_sync — the detect costs no extra
// pass over the slab.
#include "bitset.cuh"

namespace repro_torch {

constexpr int kColorMask = (1 << 28) - 1;
constexpr int kForbidBit = 1 << 28;
constexpr int kConflictBit = 1 << 29;

__global__ void round_fused_kernel(const int* __restrict__ ent, long long stride,
                                   const int* __restrict__ own, int V, int D, int W,
                                   int* __restrict__ mex, int* __restrict__ conflict) {
  extern __shared__ unsigned int smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int rows = blockDim.x / kWarp;
  unsigned int* forb = smem + static_cast<size_t>(warp) * W;
  for (long long row = static_cast<long long>(blockIdx.x) * rows + warp; row < V;
       row += static_cast<long long>(gridDim.x) * rows) {
    bitset_reset(forb, W, lane);
    const int mine = __ldg(own + row);
    const int* r = ent + row * stride;
    bool hit = false;
    for (int j = lane; j < D; j += kWarp) {
      const int e = __ldg(r + j);
      const int c = e & kColorMask;
      if (e & kForbidBit) bitset_mark(forb, W, c);
      hit |= (e & kConflictBit) && c == mine && mine > 0;
    }
    const bool any_hit = __any_sync(0xffffffffu, hit);
    const int m = bitset_first_clear(forb, W, lane);
    if (lane == 0) {
      mex[row] = m;
      conflict[row] = any_hit ? 1 : 0;
    }
    __syncwarp();
  }
}

}  // namespace repro_torch

extern "C" int repro_round_fused(const void* ent, long long stride, const void* own,
                                 int V, int D, int W, void* mex, void* conflict,
                                 void* stream) {
  using namespace repro_torch;
  if (V <= 0) return static_cast<int>(cudaSuccess);
  if (D <= 0 || W <= 0 || stride < D) return static_cast<int>(cudaErrorInvalidValue);
  int rows = 0;
  size_t smem = 0;
  cudaError_t err = rows_per_block(W, &rows, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(round_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  round_fused_kernel<<<grid_for_rows(V, rows), rows * kWarp, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ent), stride, static_cast<const int*>(own), V, D, W,
      static_cast<int*>(mex), static_cast<int*>(conflict));
  return static_cast<int>(cudaGetLastError());
}
