// A kernel's build and residency on the current card, for the record:
// the body of the query entry points (matmul.cu: sfc_matmul_simt_info,
// attention.cu: sfc_flash_tiled_info), which launch nothing.  Read by
// kernels/_build.py::kernel_info.
#pragma once

#include <cuda_runtime.h>

namespace sfc {

// out[0..7] = registers a thread, local (spill) bytes a thread, resident
// CTAs an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor at `threads`
// threads and `smem` bytes of dynamic shared memory, after raising the
// kernel's limit to smem), smem, threads, and three constants of the
// kernel's design
inline int kernel_info(const void* fn, int threads, int smem, const int (&design)[3], int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  int ctas = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, threads, smem);
  if (err != cudaSuccess) return (int)err;
  const int vals[8] = {attr.numRegs, (int)attr.localSizeBytes, ctas, smem, threads,
                       design[0], design[1], design[2]};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 0;
}

}  // namespace sfc
