// Shared pieces of the two ELL-slab kernels (firstfit.cu, round_fused.cu):
// the per-row forbidden bitset in shared memory and its lowest-clear-bit
// scan, plus the launch geometry both kernels use.
//
// Layout: one warp per slab row; each warp owns W uint32 words of dynamic
// shared memory (bit c of word c/32 set = color c forbidden; bit 0 of word
// 0 preset, since color 0 means "uncolored" and is never a mex).
#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kWarp = 32;
constexpr int kMaxRowsPerBlock = 8;  // 8 warps = 256 threads per block

// Reset a warp's bitset: word 0 = 1 (color 0 forbidden), the rest 0.
__device__ __forceinline__ void bitset_reset(unsigned int* forb, int W, int lane) {
  for (int w = lane; w < W; w += kWarp) forb[w] = (w == 0) ? 1u : 0u;
  __syncwarp();
}

// Mark color c forbidden. Colors < 0 or >= 32*W drop out of the bitset
// (an arithmetic c >> 5 of a negative color is a negative word index, which
// matches no word — the reference kernel's semantics).
__device__ __forceinline__ void bitset_mark(unsigned int* forb, int W, int c) {
  if (c >= 0) {
    const int wi = c >> 5;
    if (wi < W) atomicOr(&forb[wi], 1u << (c & 31));
  }
}

// The lowest clear bit of the W-word bitset, INT_MAX if all 32*W are set.
// Lanes scan 32 words at a time; the first window with a clear bit ends the
// scan (the result of __reduce_min_sync is warp-uniform, so is the break).
__device__ __forceinline__ int bitset_first_clear(const unsigned int* forb, int W, int lane) {
  for (int w0 = 0; w0 < W; w0 += kWarp) {
    const int w = w0 + lane;
    const unsigned int free_bits = (w < W) ? ~forb[w] : 0u;
    const int cand = free_bits ? (w * 32 + __ffs(free_bits) - 1) : INT_MAX;
    const int m = __reduce_min_sync(0xffffffffu, cand);
    if (m != INT_MAX) return m;
  }
  return INT_MAX;
}

// Rows per block from the bitset size; 0 if one row's bitset does not fit
// in the shared memory a block may use on this device.
inline cudaError_t rows_per_block(int W, int* rows, size_t* smem_bytes) {
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t per_row = static_cast<size_t>(W) * sizeof(unsigned int);
  size_t r = per_row ? static_cast<size_t>(max_optin) / per_row : kMaxRowsPerBlock;
  if (r > static_cast<size_t>(kMaxRowsPerBlock)) r = kMaxRowsPerBlock;
  *rows = static_cast<int>(r);
  *smem_bytes = r * per_row;
  return cudaSuccess;
}

inline unsigned int grid_for_rows(long long V, int rows) {
  long long blocks = (V + rows - 1) / rows;
  const long long cap = 1LL << 20;  // grid-stride beyond this
  return static_cast<unsigned int>(blocks < cap ? blocks : cap);
}

}  // namespace repro_torch
