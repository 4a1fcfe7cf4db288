// sfc_matmul: C = A . B over a curve-ordered table of (i, j) output tiles.
//
// Replaces: src/repro/kernels/matmul.py::_matmul_kernel (the TPU kernel
// of matmul_swizzled).  There the grid is (tiles, k_tiles) and a VMEM
// accumulator lives across the sequential k steps; a GPU grid runs its
// CTAs concurrently and in no order, so here the whole K reduction is a
// loop inside one CTA and each output tile is written exactly once.
//
// f32 inputs: bound on the H100 by FP32 FLOP/s.  TF32 is off, so f32
// products cannot use the tensor cores (67 TFLOP/s on the FP32 pipes).
// The design is a plain SIMT tile product (tile_gemm.cuh: 128x128 CTA
// tile, 8x8 outputs per thread, 16-deep shared-memory chunks with a
// register prefetch of the next chunk).  The curve order of the schedule
// decides which A row panels and B column panels neighbouring CTAs share
// in L2.
// bf16 inputs: bound by the bf16 tensor cores (2 M N K at 989 TFLOP/s:
// 0.68 ms at 8000x7000x6000).  Widened to f32 on the SIMT path they took
// 19.35 ms there (NVIDIA H100 80GB HBM3, 700.00 W), against
// torch.matmul's 1.01.  They run matmul_wgmma_kernel instead, the
// wgmma_gemm.cuh mainloop of sfc_matmul3d's bf16 kernel: TMA loads 64-deep
// stages of A and B into a 4-stage ring, one producer thread walks k =
// 0, 64, .. over the whole K (the JAX kernel's k order; TMA fills past K
// with zeros), two consumer warpgroups keep the f32 accumulator in
// registers and write bf16 or f32 once.  Every CTA streams its panels in
// the same k order, so CTAs that are neighbours on the curve read the
// same A and B stages from L2 at about the same time: 1.35-1.43 ms on
// the same card over four runs, within 3.4 % of sfc_matmul3d's bf16
// kernel in each (below it in three), against torch.matmul's 0.91-0.92
// (chip_smoke.py): the shared order buys nothing measurable.  A 128x128
// tile reads (128 + 128) K bf16 of operands, 64 flops a byte: 10.6 GB
// from L2 at this shape, 7.9 TB/s at 1.35 ms; a 128x256 tile or TMA
// multicast across a CTA pair would read less.
//
// CTA s reads (i, j) = sched[s]; a (bm, bn) tile wider than 128 is
// covered by a loop of 128x128 sub-tiles inside the CTA (bf16: bm, bn
// multiples of 128, or the whole M or N below 128).
//
// sfc_tile_update: O[i, j] += alpha * A_i . B_j^T over a scheduled subset
// of (i, j) tiles, O updated in place.
//
// Replaces: src/repro/kernels/matmul.py::_accum_update_kernel (the TPU
// kernel of tile_update_swizzled, the per-k Cholesky's trailing SYRK
// update).  Each tile of the schedule is visited once, so the in-place
// read-modify-write needs no ordering between CTAs.  Both operands are
// row panels, A (M, Kp) and B (N, Kp), read by RowLoader as x . c^T is in
// kmeans.cu; the epilogue is tile_gemm.cuh::tile_update, which the fused
// Cholesky's trailing phase (cholesky.cu) runs too.
// Bound on the H100: FP32 FLOP/s (2 M N Kp over the whole grid; TF32 is
// off).  Same SIMT tile product and sub-tile loop as sfc_matmul.
//
// sfc_matmul3d: C = A . B over a 3-D (i, j, k) curve table.
//
// Replaces: src/repro/kernels/matmul.py::_matmul3d_kernel (the TPU kernel
// of matmul_swizzled_3d, ops.matmul(schedule_ndim=3)).  There every grid
// step is one (i, j, k) tile product read-modify-written into the f32
// output block, and the k tiles of one output tile are not adjacent in
// the grid.  On a GPU, concurrent CTAs must not read-modify-write one
// tile, so the host turns the table into a CSR (kernels/matmul.py:
// matmul3d_csr): the (i, j) tiles in first-visit order, one CTA each,
// launched in that order, and per tile its k tiles in the order the 3-D
// table visits them.  The CTA walks its own k list in that order (the
// JAX kernel's summation order), keeps the accumulator in registers
// across the k tiles (tile_gemm.cuh::tile_accumulate) and writes C once.
// f32 inputs: bound on the H100 by FP32 FLOP/s (2 M N K; TF32 is off), as
// sfc_matmul; the same SIMT tile product.  The curve order of the (i, j)
// first visits decides which panels neighbouring CTAs share in L2, and
// each CTA's k order which depth panels it streams first.
// bf16 inputs: bound by the bf16 tensor cores (2 M N K at 989 TFLOP/s:
// 0.68 ms at 8000x7000x6000).  The first design widened bf16 to f32 on
// the SIMT path: 26.55 ms there (H100 80GB HBM3, 700 W), against
// torch.matmul's 0.97.  This design (wgmma_gemm.cuh) runs the CTA's 128x128
// tile on wgmma: TMA loads 64-deep stages of A and B into a 4-stage
// shared-memory ring, one producer thread walks the CTA's k list in the
// table's order (so the tile products are summed in the JAX kernel's
// order at tile granularity, each tile in 64-deep steps), two consumer
// warpgroups keep the f32 accumulator in registers, and the epilogue
// writes bf16 or f32 once, masked at M and N.  The bf16 kernel takes
// 128x128 output tiles (or one tile of the whole M or N when it is
// smaller) and tiles 64 deep (or one tile of the whole K); the wrapper
// pads K to 16 and N to 8 for TMA's 16-byte strides.
#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace sfc;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// two neighbouring columns (an even column of an even-width row)
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const T* __restrict__ A, const T* __restrict__ B, TO* __restrict__ C,
              const int* __restrict__ sched, int M, int N, int K, int bm, int bn) {
  __shared__ __align__(16) float As[BK * TILE];
  __shared__ __align__(16) float Bs[BK * TILE];
  const int ti = sched[2 * (size_t)blockIdx.x];
  const int tj = sched[2 * (size_t)blockIdx.x + 1];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  for (int sr = 0; sr < bm; sr += TILE) {
    const int row0 = ti * bm + sr;
    const int rows = min(min(TILE, bm - sr), M - row0);
    for (int sc = 0; sc < bn; sc += TILE) {
      const int col0 = tj * bn + sc;
      const int cols = min(min(TILE, bn - sc), N - col0);
      RowLoader<T> la{A + (size_t)row0 * K, (size_t)K, rows, K};
      KLoader<T> lb{B + col0, (size_t)N, cols, K};
      float acc[8][8];
      tile_product<false>(acc, la, lb, K, As, Bs, nullptr);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = tile_row(ty, i);
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tile_col(tx, j);
          if (c < cols) store_out(C + (size_t)(row0 + r) * N + col0 + c, acc[i][j]);
        }
      }
    }
  }
}

template <typename T, typename TO>
int launch(const void* a, const void* b, void* c, const void* sched, int steps, int M, int N,
           int K, int bm, int bn, void* stream) {
  matmul_kernel<T, TO><<<steps, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)b, (TO*)c, (const int*)sched, M, N, K, bm, bn);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(THREADS)
tile_update_kernel(float* O, const float* A, const float* B, const int* __restrict__ sched, int M,
                   int N, int Kp, int bm, int bn, float alpha) {
  __shared__ __align__(16) float As[BK * TILE];
  __shared__ __align__(16) float Bs[BK * TILE];
  const int ti = sched[2 * (size_t)blockIdx.x];
  const int tj = sched[2 * (size_t)blockIdx.x + 1];
  for (int sr = 0; sr < bm; sr += TILE) {
    const int row0 = ti * bm + sr;
    const int rows = min(min(TILE, bm - sr), M - row0);
    for (int sc = 0; sc < bn; sc += TILE) {
      const int col0 = tj * bn + sc;
      const int cols = min(min(TILE, bn - sc), N - col0);
      tile_update(O + (size_t)row0 * N + col0, (size_t)N, A + (size_t)row0 * Kp, (size_t)Kp,
                  B + (size_t)col0 * Kp, (size_t)Kp, rows, cols, Kp, alpha, As, Bs);
    }
  }
}

// CTA r owns output tile (i, j) = ij[r] and adds A(i, k) B(k, j) for k =
// ks[r kt], ..., ks[r kt + kt - 1] in that order; K % bk == 0.
template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS)
matmul3d_kernel(const T* __restrict__ A, const T* __restrict__ B, TO* __restrict__ C,
                const int* __restrict__ ij, const int* __restrict__ ks, int kt, int M, int N,
                int K, int bm, int bn, int bk) {
  __shared__ __align__(16) float As[BK * TILE];
  __shared__ __align__(16) float Bs[BK * TILE];
  const int ti = ij[2 * (size_t)blockIdx.x];
  const int tj = ij[2 * (size_t)blockIdx.x + 1];
  const int* kr = ks + (size_t)blockIdx.x * kt;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  for (int sr = 0; sr < bm; sr += TILE) {
    const int row0 = ti * bm + sr;
    const int rows = min(min(TILE, bm - sr), M - row0);
    for (int sc = 0; sc < bn; sc += TILE) {
      const int col0 = tj * bn + sc;
      const int cols = min(min(TILE, bn - sc), N - col0);
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int q = 0; q < kt; ++q) {
        const size_t k0 = (size_t)kr[q] * bk;
        RowLoader<T> la{A + (size_t)row0 * K + k0, (size_t)K, rows, bk};
        KLoader<T> lb{B + k0 * N + col0, (size_t)N, cols, bk};
        tile_accumulate<false>(acc, la, lb, bk, As, Bs, nullptr);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = tile_row(ty, i);
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tile_col(tx, j);
          if (c < cols) store_out(C + (size_t)(row0 + r) * N + col0 + c, acc[i][j]);
        }
      }
    }
  }
}

template <typename T, typename TO>
int launch3d(const void* a, const void* b, void* c, const void* ij, const void* ks, int steps,
             int kt, int M, int N, int K, int bm, int bn, int bk, void* stream) {
  matmul3d_kernel<T, TO><<<steps, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)b, (TO*)c, (const int*)ij, (const int*)ks, kt, M, N, K, bm, bn, bk);
  return (int)cudaGetLastError();
}

// bf16 inputs: CTA r owns the 128x128 output tile ij[r] and sums its k
// tiles ks[r kt] .. ks[r kt + kt - 1] in that order, each in 64-deep
// stages; the maps cover A (M, K) and B (K, N), zero outside them.
template <typename TO>
__global__ void __launch_bounds__(wg::THREADS, 1)
matmul3d_wgmma_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                      TO* __restrict__ C, const int* __restrict__ ij, const int* __restrict__ ks,
                      int kt, int M, int N, int bk) {
  extern __shared__ __align__(16) uint8_t smem[];
  const wg::Ring ring = wg::make_ring(smem);
  const int row0 = ij[2 * (size_t)blockIdx.x] * wg::BM;
  const int col0 = ij[2 * (size_t)blockIdx.x + 1] * wg::BN;
  const int per_tile = (bk + wg::BKS - 1) / wg::BKS;
  const int n = kt * per_tile;
  const int g = threadIdx.x / 128;
  if (g == 2) {  // the producer warpgroup: one thread issues every load
    if (threadIdx.x == 256) {
      const int* kr = ks + (size_t)blockIdx.x * kt;
      wg::produce(ring, &ma, &mb, row0, col0, n,
                  [&](int i) { return kr[i / per_tile] * bk + (i % per_tile) * wg::BKS; });
    }
    return;
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  wg::consume(ring, g, n, acc);
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = row0 + g * 64 + wg::acc_row(i);
    const int c = col0 + wg::acc_col(i);
    if (r < M && c < N) store_pair(C + (size_t)r * N + c, acc[i], acc[i + 1]);
  }
}

// bf16 inputs, the 2-D table: CTA r owns the (bm, bn) output tile sched[r]
// and covers it with 128x128 sub-tiles, each summed over the whole K in
// 64-deep stages (0, 64, ...), the ring running on from one sub-tile to
// the next; bm, bn are multiples of 128 or the whole M, N below 128.
template <typename TO>
__global__ void __launch_bounds__(wg::THREADS, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                    TO* __restrict__ C, const int* __restrict__ sched, int M, int N, int K, int bm,
                    int bn) {
  extern __shared__ __align__(16) uint8_t smem[];
  const wg::Ring ring = wg::make_ring(smem);
  const int ti = sched[2 * (size_t)blockIdx.x];
  const int tj = sched[2 * (size_t)blockIdx.x + 1];
  const int n = (K + wg::BKS - 1) / wg::BKS;
  const int subs_r = (bm + wg::BM - 1) / wg::BM, subs_c = (bn + wg::BN - 1) / wg::BN;
  const int g = threadIdx.x / 128;
  if (g == 2) {  // the producer warpgroup: one thread issues every load
    if (threadIdx.x == 256)
      for (int u = 0; u < subs_r * subs_c; ++u)
        wg::produce(ring, &ma, &mb, ti * bm + (u / subs_c) * wg::BM, tj * bn + (u % subs_c) * wg::BN,
                    n, [](int i) { return i * wg::BKS; }, u * n);
    return;
  }
  for (int u = 0; u < subs_r * subs_c; ++u) {
    const int row0 = ti * bm + (u / subs_c) * wg::BM, col0 = tj * bn + (u % subs_c) * wg::BN;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    wg::consume(ring, g, n, acc, u * n);
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = row0 + g * 64 + wg::acc_row(i);
      const int c = col0 + wg::acc_col(i);
      if (r < M && c < N) store_pair(C + (size_t)r * N + c, acc[i], acc[i + 1]);
    }
  }
}

template <typename TO>
int launch_wgmma(const void* a, const void* b, void* c, const void* sched, int steps, int M, int N,
                 int K, int bm, int bn, void* stream) {
  // TMA: 16-byte aligned bases and row strides (the wrapper pads)
  if (K % 8 || N % 8 || (uintptr_t)a % 16 || (uintptr_t)b % 16) return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  int err = make_tensor_map_bf16(&ma, a, M, K, wg::BM, wg::BKS);
  if (err) return err;
  err = make_tensor_map_bf16(&mb, b, K, N, wg::BKS, 64);
  if (err) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      matmul_wgmma_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  matmul_wgmma_kernel<TO><<<steps, wg::THREADS, wg::SMEM_BYTES, (cudaStream_t)stream>>>(
      ma, mb, (TO*)c, (const int*)sched, M, N, K, bm, bn);
  return (int)cudaGetLastError();
}

// the blocks the bf16 kernels take: a multiple of 128 (2-D table only:
// the sub-tile loop), 128, or the whole dimension below 128
bool wgmma_block(int blk, int dim, bool multiples) {
  return blk == wg::BM || (multiples && blk > 0 && blk % wg::BM == 0) || (blk == dim && dim < wg::BM);
}

template <typename TO>
int launch3d_wgmma(const void* a, const void* b, void* c, const void* ij, const void* ks, int steps,
                   int kt, int M, int N, int K, int bk, void* stream) {
  // TMA: 16-byte aligned bases and row strides (the wrapper pads)
  if (K % 8 || N % 8 || (uintptr_t)a % 16 || (uintptr_t)b % 16) return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  int err = make_tensor_map_bf16(&ma, a, M, K, wg::BM, wg::BKS);
  if (err) return err;
  err = make_tensor_map_bf16(&mb, b, K, N, wg::BKS, 64);
  if (err) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      matmul3d_wgmma_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  matmul3d_wgmma_kernel<TO><<<steps, wg::THREADS, wg::SMEM_BYTES, (cudaStream_t)stream>>>(
      ma, mb, (TO*)c, (const int*)ij, (const int*)ks, kt, M, N, bk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sfc_tile_update(void* o, const void* a, const void* b, const void* sched, int steps,
                               int M, int N, int Kp, int bm, int bn, float alpha, void* stream) {
  tile_update_kernel<<<steps, THREADS, 0, (cudaStream_t)stream>>>(
      (float*)o, (const float*)a, (const float*)b, (const int*)sched, M, N, Kp, bm, bn, alpha);
  return (int)cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16 (inputs share one dtype).
// bf16 inputs run the wgmma kernel (bm, bn: multiples of 128 or the whole
// M, N below 128; K, N multiples of 8).
extern "C" int sfc_matmul(const void* a, const void* b, void* c, const void* sched, int steps,
                          int M, int N, int K, int bm, int bn, int in_dtype, int out_dtype,
                          void* stream) {
  if (in_dtype == 0 && out_dtype == 0)
    return launch<float, float>(a, b, c, sched, steps, M, N, K, bm, bn, stream);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(a, b, c, sched, steps, M, N, K, bm, bn, stream);
  if (in_dtype == 1 && (!wgmma_block(bm, M, true) || !wgmma_block(bn, N, true)))
    return (int)cudaErrorInvalidValue;
  if (in_dtype == 1 && out_dtype == 0)
    return launch_wgmma<float>(a, b, c, sched, steps, M, N, K, bm, bn, stream);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_wgmma<__nv_bfloat16>(a, b, c, sched, steps, M, N, K, bm, bn, stream);
  return (int)cudaErrorInvalidValue;
}

// dtype codes as sfc_matmul's; ij int32[steps, 2], ks int32[steps, kt].
// bf16 inputs run the wgmma kernel (bm, bn: 128 or the whole M, N).
extern "C" int sfc_matmul3d(const void* a, const void* b, void* c, const void* ij, const void* ks,
                            int steps, int kt, int M, int N, int K, int bm, int bn, int bk,
                            int in_dtype, int out_dtype, void* stream) {
  if (in_dtype == 0 && out_dtype == 0)
    return launch3d<float, float>(a, b, c, ij, ks, steps, kt, M, N, K, bm, bn, bk, stream);
  if (in_dtype == 0 && out_dtype == 1)
    return launch3d<float, __nv_bfloat16>(a, b, c, ij, ks, steps, kt, M, N, K, bm, bn, bk, stream);
  if (in_dtype == 1 && (!wgmma_block(bm, M, false) || !wgmma_block(bn, N, false) ||
                        (bk % wg::BKS && kt != 1)))
    return (int)cudaErrorInvalidValue;
  if (in_dtype == 1 && out_dtype == 0)
    return launch3d_wgmma<float>(a, b, c, ij, ks, steps, kt, M, N, K, bk, stream);
  if (in_dtype == 1 && out_dtype == 1)
    return launch3d_wgmma<__nv_bfloat16>(a, b, c, ij, ks, steps, kt, M, N, K, bk, stream);
  return (int)cudaErrorInvalidValue;
}
