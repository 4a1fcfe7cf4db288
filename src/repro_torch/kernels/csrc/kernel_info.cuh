// A kernel's build and residency on the current card, for the record:
// the body of the query entry points (matmul.cu: sfc_matmul_simt_info,
// attention.cu: sfc_flash_tiled_info, kmeans.cu: sfc_kmeans_info,
// simjoin.cu: sfc_simjoin_info), which launch nothing.  Read by
// kernels/_build.py::kernel_info.  Also the once-per-device raise of a
// kernel's dynamic shared-memory limit that the launches of matmul.cu,
// attention.cu, kmeans.cu and simjoin.cu share, and the once-per-device
// count of resident CTAs that sizes the join's persistent grid.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace sfc {

constexpr int MAX_DEVICES = 64;

// kernel Kern's dynamic shared-memory limit (above the 48 KB static one),
// raised once per device to `bytes`, the most a launch of it can ask for,
// not on every launch
template <auto Kern>
cudaError_t raise_smem_limit(int bytes) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t attr[MAX_DEVICES];
  std::call_once(once[dev], [dev, bytes] {
    attr[dev] = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  });
  return attr[dev];
}

// the CTAs of kernel Kern resident at once on the current device: SMs x
// CTAs an SM at `threads` threads and `bytes` of dynamic shared memory
// (its limit raised first), asked once per device; a persistent launch's
// largest grid
template <auto Kern>
cudaError_t resident_ctas(int threads, int bytes, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t res[MAX_DEVICES];
  static int ctas[MAX_DEVICES];
  std::call_once(once[dev], [dev, threads, bytes] {
    int per_sm = 0, sms = 0;
    res[dev] = raise_smem_limit<Kern>(bytes);
    if (res[dev] == cudaSuccess)
      res[dev] = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kern, threads, bytes);
    if (res[dev] == cudaSuccess)
      res[dev] = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (res[dev] == cudaSuccess && per_sm * sms < 1) res[dev] = cudaErrorLaunchOutOfResources;
    ctas[dev] = per_sm * sms;
  });
  *out = ctas[dev];
  return res[dev];
}

// out[0..7] = registers a thread, local (spill) bytes a thread, resident
// CTAs an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor at `threads`
// threads and `smem` bytes of dynamic shared memory, after raising the
// kernel's limit to smem if it is lower; a limit raise_smem_limit set
// higher stays, so the launches that need it still run), smem, threads,
// and three constants of the kernel's design
inline int kernel_info(const void* fn, int threads, int smem, const int (&design)[3], int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess && attr.maxDynamicSharedSizeBytes < smem)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int ctas = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, threads, smem);
  if (err != cudaSuccess) return (int)err;
  const int vals[8] = {attr.numRegs, (int)attr.localSizeBytes, ctas, smem, threads,
                       design[0], design[1], design[2]};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 0;
}

}  // namespace sfc
