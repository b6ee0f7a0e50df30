// firstfit: per row of an ELL slab of neighbor colors, the smallest positive
// color absent from the row (the paper's Alg. 1 lines 5-6).
//
// Replaces the Pallas TPU kernel src/repro/kernels/firstfit.py::firstfit
// (body _firstfit_kernel), which tiles the slab into (BV, BD) VMEM blocks and
// carries a [BV, W] bitset scratch across the sequential slot-tile axis.
//
// Bound on an H100 SXM: the slab is read once and the mex written once —
// 4*V*D + 4*V bytes, at 3.35 TB/s; the bit arithmetic per entry (a shift, a
// mask, an atomicOr into shared memory) is far below the byte bound.
//
// Design: Hopper blocks run in no order, so nothing carries between blocks.
// One warp owns one row at a time (grid-stride over rows): lanes stride over
// the row's D slots, so a warp's loads are contiguous in the row, and each
// lane ORs its colors into the row's W-word bitset in shared memory. The
// bitset is sized from W and lives only while the row is processed; the
// scan takes the lowest clear bit with __ffs and a warp min-reduce. Any D
// works (rows of Delta ~ 2000 are ~63 loads per lane), and any W whose
// bitset fits in a block's shared memory (the wrapper checks W*4 bytes
// against 227 KB). The row stride is a parameter, so the engines hand in
// the [:V, :D] view of a (V+1, D+1) slab whose last row and column are the
// scatter sink, with no copy.
#include "bitset.cuh"

namespace repro_torch {

__global__ void firstfit_kernel(const int* __restrict__ nbr, long long stride,
                                int V, int D, int W, int* __restrict__ out) {
  extern __shared__ unsigned int smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int rows = blockDim.x / kWarp;
  unsigned int* forb = smem + static_cast<size_t>(warp) * W;
  for (long long row = static_cast<long long>(blockIdx.x) * rows + warp; row < V;
       row += static_cast<long long>(gridDim.x) * rows) {
    bitset_reset(forb, W, lane);
    const int* r = nbr + row * stride;
    for (int j = lane; j < D; j += kWarp) bitset_mark(forb, W, __ldg(r + j));
    __syncwarp();
    const int m = bitset_first_clear(forb, W, lane);
    if (lane == 0) out[row] = m;
    __syncwarp();
  }
}

}  // namespace repro_torch

extern "C" int repro_firstfit(const void* nbr, long long stride, int V, int D,
                              int W, void* out, void* stream) {
  using namespace repro_torch;
  if (V <= 0) return static_cast<int>(cudaSuccess);
  if (D <= 0 || W <= 0 || stride < D) return static_cast<int>(cudaErrorInvalidValue);
  int rows = 0;
  size_t smem = 0;
  cudaError_t err = rows_per_block(W, &rows, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(firstfit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  firstfit_kernel<<<grid_for_rows(V, rows), rows * kWarp, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nbr), stride, V, D, W, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
