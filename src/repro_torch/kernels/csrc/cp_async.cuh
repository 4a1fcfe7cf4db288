// Asynchronous copies from device memory to shared memory (cp.async,
// sm_80 and later): 16 bytes for the decode kernel's K/V rows, the
// Cholesky trailing kernel's operand and output tiles and the SIMT GEMM's
// B stages; 4 bytes for the SIMT GEMM's A stages, which the copy itself
// transposes (simt_gemm.cuh).  A thread issues
// copies, closes them into a group with cp_async_commit, and waits with
// cp_async_wait<N> until at most N of its groups are still in flight; a
// CTA barrier (or a warp barrier, for copies a warp reads alone) then
// makes every thread's landed copies visible.
#pragma once

#include <cstdint>

namespace sfc {

// copy 16 bytes from src to dst; with fill set, write 16 zero bytes and
// read nothing (src is not dereferenced)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill = false) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = fill ? 0 : 16;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

// copy 4 bytes (one float) from src to dst, through L1
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

// the same, or with fill set, write 4 zero bytes and read nothing
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool fill) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = fill ? 0 : 4;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace sfc
