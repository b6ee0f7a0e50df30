// conflict_mask: per edge, c_src == c_dst && c_src > 0 && src > dst — the
// Alg. 2 line-13 predicate that queues the higher-index endpoint of a
// monochromatic same-round pair for recoloring.
//
// Replaces the Pallas TPU kernel src/repro/kernels/conflict.py::conflict_mask
// (body _conflict_kernel).
//
// Bound on an H100 SXM: four int32 inputs read once and one int32 output
// written once — 20*E bytes at 3.35 TB/s; three compares per edge.
//
// Design: one thread per edge over a grid-stride loop; neighbouring threads
// touch neighbouring addresses, so every access is a coalesced 128-byte
// line per warp and the kernel streams at the memory rate.
#include <cuda_runtime.h>

namespace repro_torch {

__global__ void conflict_kernel(const int* __restrict__ csrc, const int* __restrict__ cdst,
                                const int* __restrict__ src, const int* __restrict__ dst,
                                long long E, int* __restrict__ out) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < E;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int a = __ldg(csrc + i);
    out[i] = (a == __ldg(cdst + i) && a > 0 && __ldg(src + i) > __ldg(dst + i)) ? 1 : 0;
  }
}

}  // namespace repro_torch

extern "C" int repro_conflict_mask(const void* csrc, const void* cdst, const void* src,
                                   const void* dst, long long E, void* out, void* stream) {
  using namespace repro_torch;
  if (E <= 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  long long blocks = (E + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  conflict_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(csrc), static_cast<const int*>(cdst),
      static_cast<const int*>(src), static_cast<const int*>(dst), E,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
