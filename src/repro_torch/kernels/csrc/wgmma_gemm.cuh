// A bf16 tile-GEMM mainloop for Hopper: TMA loads into a ring of
// shared-memory stages, mbarrier hand-off between one producer thread and
// two consumer warpgroups, wgmma products with f32 accumulators in
// registers.  The same header holds the wgmma forms the flash-attention
// kernel (attention.cu) adds: a K-major B from shared memory (S = Q K^T)
// and A from registers (O += P V).
//
// The CTA computes one 128x128 output tile: consumer warpgroup g (warps
// 4g .. 4g + 3) owns rows 64 g .. 64 g + 63 and issues m64n128k16 wgmmas;
// warpgroup 2 is the producer, whose first thread issues every TMA load.
// A stage is 64 deep: A's 128x64 box (K-major, 128-byte swizzle, 16 KB)
// and B's two 64x64 boxes (B is (K, N) row-major, so MN-major for wgmma's
// transposed-B form, 128-byte swizzle, 16 KB).  The caller's producer
// callback names the depth of each stage in the order the CTA should sum
// them, which is how a curve schedule's k order reaches the tensor cores.
//
// Host side: make_tensor_map_bf16(_nd) encodes a 2-D (or n-D) TMA
// descriptor with cuTensorMapEncodeTiled, looked up at run time through cudart
// (cudaGetDriverEntryPoint), so the library needs no -lcuda.  Descriptors
// are kernel parameters (__grid_constant__).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>

#include <cstdint>

namespace sfc {
namespace wg {

constexpr int BM = 128;      // CTA tile rows (two m64 warpgroups)
constexpr int BN = 128;      // CTA tile columns (one n128 wgmma)
constexpr int BKS = 64;      // depth of one stage: 64 bf16 = one 128-byte swizzle row
constexpr int STAGES = 4;    // ring depth: 4 x 32 KB
constexpr int THREADS = 384; // two consumer warpgroups + the producer warpgroup
constexpr int A_BYTES = BM * BKS * 2;
constexpr int B_HALF_BYTES = BKS * 64 * 2;
constexpr int STAGE_BYTES = A_BYTES + 2 * B_HALF_BYTES;
// the ring, its barriers and the slack to align the ring to 1024 bytes
// (the 128-byte swizzle pattern repeats every 1024 bytes)
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one 2-D TMA box: coordinates innermost first, completion on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// a 3-D / 4-D TMA box (the paged prefill's pools and its grouped queries)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a wgmma shared-memory descriptor for a 128-byte-swizzled operand
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

#define SFC_R8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                  "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d += A (64x16, K-major) . B (16x128, MN-major): one m64n128k16 wgmma
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}"
      : SFC_R8(0), SFC_R8(8), SFC_R8(16), SFC_R8(24), SFC_R8(32), SFC_R8(40), SFC_R8(48),
        SFC_R8(56)
      : "l"(da), "l"(db), "r"(1));
}

// S = A (64x16, K-major) . B (16x128, K-major: B's 128 rows are the
// columns of S, each 16 deep), overwriting S when `accumulate` is 0
__device__ __forceinline__ void wgmma_m64n128k16_kmajor(float (&d)[64], uint64_t da, uint64_t db,
                                                        int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}"
      : SFC_R8(0), SFC_R8(8), SFC_R8(16), SFC_R8(24), SFC_R8(32), SFC_R8(40), SFC_R8(48),
        SFC_R8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A (64x16, bf16 pairs in registers, the wgmma A-fragment layout) .
// B (16x64, MN-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}"
      : SFC_R8(0), SFC_R8(8), SFC_R8(16), SFC_R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A (64x16, registers) . B (16x80, MN-major: a 64-column swizzle atom
// and the first 16 columns of the next)
__device__ __forceinline__ void wgmma_m64n80k16_rs(float (&d)[40], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n"
      "}"
      : SFC_R8(0), SFC_R8(8), SFC_R8(16), SFC_R8(24), SFC_R8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A (64x16, registers) . B (16x128, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}"
      : SFC_R8(0), SFC_R8(8), SFC_R8(16), SFC_R8(24), SFC_R8(32), SFC_R8(40), SFC_R8(48),
        SFC_R8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef SFC_R8

struct Ring {
  uint8_t* base;     // STAGES x STAGE_BYTES, 1024-aligned
  uint64_t* full;    // producer -> consumers: the stage's bytes have landed
  uint64_t* empty;   // consumers -> producer: both warpgroups are done with it

  __device__ __forceinline__ uint8_t* a(int s) const { return base + s * STAGE_BYTES; }
  __device__ __forceinline__ uint8_t* b(int s) const { return base + s * STAGE_BYTES + A_BYTES; }
};

// Carve the ring out of dynamic shared memory and initialise its barriers
// (every thread calls this; it ends in a CTA barrier).
__device__ __forceinline__ Ring make_ring(uint8_t* smem) {
  const uintptr_t p = (reinterpret_cast<uintptr_t>(smem) + 1023) & ~(uintptr_t)1023;
  Ring r;
  r.base = reinterpret_cast<uint8_t*>(p);
  r.full = reinterpret_cast<uint64_t*>(r.base + STAGES * STAGE_BYTES);
  r.empty = r.full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The producer thread: stage i (i = 0 .. n - 1) loads A's box at (depth
// k_of(i), row0) and B's two boxes at (col0, k_of(i)), (col0 + 64, k_of(i)).
// `used` is how many stages the ring has served before this call (a CTA
// that computes several tiles runs the ring on from one to the next).
template <typename KOf>
__device__ __forceinline__ void produce(const Ring& r, const CUtensorMap* ma, const CUtensorMap* mb,
                                        int row0, int col0, int n, KOf k_of, int used = 0) {
  int s = used % STAGES;
  uint32_t phase = (used / STAGES) & 1;
  for (int i = 0; i < n; ++i) {
    mbar_wait(&r.empty[s], phase ^ 1);
    mbar_expect_tx(&r.full[s], STAGE_BYTES);
    const int k = k_of(i);
    tma_load_2d(r.a(s), ma, &r.full[s], k, row0);
    tma_load_2d(r.b(s), mb, &r.full[s], col0, k);
    tma_load_2d(r.b(s) + B_HALF_BYTES, mb, &r.full[s], col0 + 64, k);
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
}

// A consumer warpgroup (g = 0 or 1): n stages into acc (which the caller
// zeroes), in stage order; one wgmma group in flight while the next stage
// is issued, each stage handed back as soon as its group has finished.
// `used` as for produce.
__device__ __forceinline__ void consume(const Ring& r, int g, int n, float (&acc)[64], int used = 0) {
  const bool signals = (threadIdx.x & 127) == 0;
  int s = used % STAGES, prev = -1;
  uint32_t phase = (used / STAGES) & 1;
  for (int i = 0; i < n; ++i) {
    mbar_wait(&r.full[s], phase);
    // A: K-major, rows 64 g .. 64 g + 63 of the box, 8-row groups 1024 B
    // apart; each k16 step is 32 B further along the swizzled row.
    // B: MN-major, 8-deep groups 1024 B apart, the two 64-column halves
    // 8192 B apart; each k16 step is 16 rows = 2048 B further.
    const uint32_t a0 = smem_u32(r.a(s)) + g * 64 * 128;
    const uint32_t b0 = smem_u32(r.b(s));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKS / 16; ++kk)
      wgmma_m64n128k16(acc, desc_sw128(a0 + kk * 32, 16, 1024),
                       desc_sw128(b0 + kk * 2048, B_HALF_BYTES, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0 && signals) mbar_arrive(&r.empty[prev]);
    prev = s;
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  if (prev >= 0 && signals) mbar_arrive(&r.empty[prev]);
}

// Element (row, col) of a consumer thread's accumulator register i, rows
// relative to the warpgroup's 64, columns to the tile's 128 (the wgmma
// D-fragment layout: per 8-column block j = i / 4, registers {0, 1} at
// row w 16 + lane / 4 and {2, 3} eight rows below, columns 2 (lane % 4)
// + {0, 1}).
__device__ __forceinline__ int acc_row(int i) {
  const int t = threadIdx.x & 127;
  return (t >> 5) * 16 + ((t & 31) >> 2) + ((i & 2) ? 8 : 0);
}
__device__ __forceinline__ int acc_col(int i) {
  return (i >> 2) * 8 + (threadIdx.x & 3) * 2 + (i & 1);
}

}  // namespace wg

// Host: a bf16 tensor map of `rank` dimensions, innermost first: extents
// dims[rank], byte strides of dimensions 1 .. rank - 1 in strides[rank - 1]
// (each a multiple of 16), box[rank]; 128-byte swizzle (box[0] is 64
// elements, one swizzle row), zero fill outside the tensor.  Returns 0 or a
// CUresult / cudaError code.
inline int make_tensor_map_bf16_nd(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
                                   const uint64_t* strides, const uint32_t* box) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || !fn) return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  cuuint64_t d[5], st[4];
  cuuint32_t bx[5], elem[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    elem[i] = 1;
    if (i) st[i - 1] = strides[i - 1];
  }
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), d,
                              st, bx, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Host: a 2-D bf16 tensor map of a row-major (rows, cols) matrix, box
// (box_rows, box_cols), 128-byte swizzle, zero fill outside the matrix.
inline int make_tensor_map_bf16(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols,
                                uint32_t box_rows, uint32_t box_cols) {
  const uint64_t dims[2] = {cols, rows};
  const uint64_t strides[1] = {cols * 2};
  const uint32_t box[2] = {box_cols, box_rows};
  return make_tensor_map_bf16_nd(map, ptr, 2, dims, strides, box);
}

}  // namespace sfc
