// repro_kernel_attributes: cudaFuncGetAttributes of the kernel a launcher
// picks, for the static analyzer's budget pass (repro_torch.analysis.budgets)
// and for chip_smoke.py. kernel: 0 firstfit, 1 round_fused, 2 conflict_mask
// (the order of repro_torch.kernels.ops.KERNELS). out[6]: registers per
// thread, static shared bytes, local (spill) bytes per thread, the most
// threads a block of it may have, the block size the launcher asks for, and
// the card's opt-in shared memory per block.
#include <cuda_runtime.h>

namespace repro_torch {
cudaError_t firstfit_attributes(int W, int D, cudaFuncAttributes* attr, int* threads);
cudaError_t round_fused_attributes(int W, int D, cudaFuncAttributes* attr, int* threads);
cudaError_t conflict_attributes(cudaFuncAttributes* attr, int* threads);
}  // namespace repro_torch

extern "C" int repro_kernel_attributes(int kernel, int W, int D, int* out) {
  using namespace repro_torch;
  cudaFuncAttributes attr{};
  int threads = 0;
  cudaError_t err;
  if (kernel == 0)
    err = firstfit_attributes(W, D, &attr, &threads);
  else if (kernel == 1)
    err = round_fused_attributes(W, D, &attr, &threads);
  else if (kernel == 2)
    err = conflict_attributes(&attr, &threads);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, optin = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = attr.maxThreadsPerBlock;
  out[4] = threads;
  out[5] = optin;
  return static_cast<int>(cudaSuccess);
}
