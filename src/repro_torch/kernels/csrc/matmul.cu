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
// They run the SIMT core of simt_gemm.cuh: a 128x128 CTA sub-tile of 8x8
// thread tiles in 32x64 warp tiles, operands streamed through a 3-stage
// ring of 32-deep shared-memory stages filled by cp.async (A transposed
// by 4-byte copies, B by 16-byte ones), one barrier a stage, the ring
// running on across the CTA's sub-tiles: 24.3 ms at 8192^3 on an NVIDIA
// H100 80GB HBM3 at 700 W, 0.68 of the bound, against torch.matmul's
// 21.4.  The first design (tile_gemm.cuh: register-staged 16-deep
// chunks, two barriers a chunk) took 34.6-35.1 ms, 0.47 of the bound.  Every output element is one
// __fmaf_rn chain over k ascending, as it was: the same bits.  The curve
// order of the schedule decides which A row panels and B column panels
// neighbouring CTAs share in L2.
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
// read-modify-write needs no ordering between CTAs.
// Bound on the H100: FP32 FLOP/s (2 M N Kp over the whole grid; TF32 is
// off): 0.256 ms for the 64 x 64 grid of 128 x 128 tiles at Kp = 128.
// The first design (tile_gemm.cuh's 8 x 8 loop, one CTA a tile, 16-deep
// chunks staged through registers behind two barriers a chunk, O read
// and written a scalar at a time) took 0.795 ms there, 0.32 of the
// bound, against torch.addmm's 0.693 (H100 80GB HBM3, 700.00 W).  Now
// (tile_update_kernel) the grid is persistent: min(steps, SMs x resident
// CTAs an SM) CTAs, two an SM on the H100 (a 99 KB ring each;
// kernels/matmul.py::tile_update_launch, the residency from the occupancy
// query sfc_matmul_simt_info), each walking table rows x, x + grid, ... on
// simt_gemm.cuh's loop.  Both operands are row panels, A (M, Kp) and B
// (N, Kp), transposed on the way in by 4-byte cp.async; the ring runs on
// from one tile to the next, so the next tile's stages are in flight
// while this one's last stages are multiplied, and the O sub-tile is
// prefetched into L2 meanwhile.  The epilogue reads O and writes it 16
// bytes at a time (N, bn multiples of 4), else a float at a time.  Staging
// O in shared memory by cp.async instead (one CTA an SM, 163 KB) ran 5-7 %
// slower in the same A/B call (PERF.md, row 3).  Each element is the
// chain it was: acc from +0 by __fmaf_rn over k ascending (zeros past Kp
// add nothing), then __fadd_rn(o, __fmul_rn(alpha, acc)); the fused
// Cholesky's trailing kernel (cholesky.cu) computes the same chain, so
// both forms agree to the bit.
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
// across the k tiles and writes C once.
// f32 inputs: bound on the H100 by FP32 FLOP/s (2 M N K; TF32 is off), as
// sfc_matmul; the same SIMT core, whose cp.async ring runs on across the
// CTA's k list (a k-tile boundary does not drain it): every element is
// one __fmaf_rn chain over the k tiles in list order, each ascending, so
// ascending k lists give sfc_matmul's bits.  The curve order of the
// (i, j) first visits decides which panels neighbouring CTAs share in L2,
// and each CTA's k order which depth panels it streams first.
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
#include "kernel_info.cuh"
#include "simt_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace sfc;

// two neighbouring columns (an even column of an even-width row)
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// f32 inputs: CTA r owns the (bm, bn) output tile sched[r] and covers it
// with 128x128 sub-tiles, each summed over k = 0 .. K - 1 (simt_gemm.cuh).
template <typename TO>
__global__ void __launch_bounds__(simt::THREADS, simt::MIN_CTAS)
matmul_kernel(const float* __restrict__ A, const float* __restrict__ B, TO* __restrict__ C,
              const int* __restrict__ sched, int M, int N, int K, int bm, int bn) {
  const simt::Walk w{sched, (int)blockIdx.x, 0, 1, bm, bn, M, N, nullptr, 1, K};
  simt::gemm<simt::BPanel::KN>(A, K, B, N, w, simt::Store<TO>{C, N});
}

// f32 inputs: CTA r owns output tile (i, j) = ij[r] and adds A(i, k) B(k, j)
// for k = ks[r kt], ..., ks[r kt + kt - 1] in that order; K % bk == 0.
template <typename TO>
__global__ void __launch_bounds__(simt::THREADS, simt::MIN_CTAS)
matmul3d_kernel(const float* __restrict__ A, const float* __restrict__ B, TO* __restrict__ C,
                const int* __restrict__ ij, const int* __restrict__ ks, int kt, int M, int N,
                int K, int bm, int bn, int bk) {
  const simt::Walk w{ij, (int)blockIdx.x, 0, 1, bm, bn, M, N, ks + (size_t)blockIdx.x * kt, kt, bk};
  simt::gemm<simt::BPanel::KN>(A, K, B, N, w, simt::Store<TO>{C, N});
}

// the f32 matmuls' launch checks: cp.async's 16-byte B rows and the
// epilogue's 4-wide stores need N and bn multiples of 4 and 16-byte
// aligned B and C (the wrapper pads: kernels/matmul.py::simt_layout)
template <auto Kern>
int simt_prepare(const void* b, const void* c, int N, int bn) {
  if (N % 4 || bn % 4 || (uintptr_t)b % 16 || (uintptr_t)c % 16) return (int)cudaErrorInvalidValue;
  return raise_smem_limit<Kern>(simt::SMEM_BYTES);
}

template <typename TO>
int launch(const void* a, const void* b, void* c, const void* sched, int steps, int M, int N,
           int K, int bm, int bn, void* stream) {
  const int err = simt_prepare<matmul_kernel<TO>>(b, c, N, bn);
  if (err) return err;
  matmul_kernel<TO><<<steps, simt::THREADS, simt::SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (TO*)c, (const int*)sched, M, N, K, bm, bn);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch3d(const void* a, const void* b, void* c, const void* ij, const void* ks, int steps,
             int kt, int M, int N, int K, int bm, int bn, int bk, void* stream) {
  const int err = simt_prepare<matmul3d_kernel<TO>>(b, c, N, bn);
  if (err) return err;
  matmul3d_kernel<TO><<<steps, simt::THREADS, simt::SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (TO*)c, (const int*)ij, (const int*)ks, kt, M, N, K, bm,
      bn, bk);
  return (int)cudaGetLastError();
}

// O (M x N) += alpha A . B^T over the table rows x = blockIdx.x,
// blockIdx.x + gridDim.x, ... < steps; A (M x Kp) and B (N x Kp) row
// panels.  vec: N and bn multiples of 4, O 16-byte aligned.
__global__ void __launch_bounds__(simt::THREADS, simt::UPDATE_MIN_CTAS)
tile_update_kernel(float* O, const float* __restrict__ A, const float* __restrict__ B,
                   const int* __restrict__ sched, int steps, int M, int N, int Kp, int bm, int bn,
                   float alpha, int vec) {
  const int tiles = (steps - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const simt::Walk w{sched, (int)blockIdx.x, (int)gridDim.x, tiles, bm, bn, M, N, nullptr, 1, Kp};
  simt::gemm<simt::BPanel::NK>(A, Kp, B, Kp, w, simt::Update{O, N, alpha, vec != 0});
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
  err = raise_smem_limit<matmul_wgmma_kernel<TO>>(wg::SMEM_BYTES);
  if (err) return err;
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
  err = raise_smem_limit<matmul3d_wgmma_kernel<TO>>(wg::SMEM_BYTES);
  if (err) return err;
  matmul3d_wgmma_kernel<TO><<<steps, wg::THREADS, wg::SMEM_BYTES, (cudaStream_t)stream>>>(
      ma, mb, (TO*)c, (const int*)ij, (const int*)ks, kt, M, N, bk);
  return (int)cudaGetLastError();
}

}  // namespace

// grid: the persistent CTAs, 1 .. steps (kernels/matmul.py::tile_update_launch)
extern "C" int sfc_tile_update(void* o, const void* a, const void* b, const void* sched, int steps,
                               int grid, int M, int N, int Kp, int bm, int bn, float alpha,
                               void* stream) {
  if (steps == 0) return 0;
  if (grid < 1 || grid > steps || bm < 1 || bn < 1 || Kp < 0) return (int)cudaErrorInvalidValue;
  const int err = raise_smem_limit<tile_update_kernel>(simt::UPDATE_SMEM_BYTES);
  if (err) return err;
  const int vec = N % 4 == 0 && bn % 4 == 0 && (uintptr_t)o % 16 == 0;
  tile_update_kernel<<<grid, simt::THREADS, simt::UPDATE_SMEM_BYTES, (cudaStream_t)stream>>>(
      (float*)o, (const float*)a, (const float*)b, (const int*)sched, steps, M, N, Kp, bm, bn, alpha,
      vec);
  return (int)cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16 (inputs share one dtype).
// f32 inputs run the SIMT kernel (N, bn multiples of 4; B and C 16-byte
// aligned); bf16 inputs the wgmma kernel (bm, bn: multiples of 128 or the whole
// M, N below 128; K, N multiples of 8).
extern "C" int sfc_matmul(const void* a, const void* b, void* c, const void* sched, int steps,
                          int M, int N, int K, int bm, int bn, int in_dtype, int out_dtype,
                          void* stream) {
  if (in_dtype == 0 && out_dtype == 0)
    return launch<float>(a, b, c, sched, steps, M, N, K, bm, bn, stream);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<__nv_bfloat16>(a, b, c, sched, steps, M, N, K, bm, bn, stream);
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
    return launch3d<float>(a, b, c, ij, ks, steps, kt, M, N, K, bm, bn, bk, stream);
  if (in_dtype == 0 && out_dtype == 1)
    return launch3d<__nv_bfloat16>(a, b, c, ij, ks, steps, kt, M, N, K, bm, bn, bk, stream);
  if (in_dtype == 1 && (!wgmma_block(bm, M, false) || !wgmma_block(bn, N, false) ||
                        (bk % wg::BKS && kt != 1)))
    return (int)cudaErrorInvalidValue;
  if (in_dtype == 1 && out_dtype == 0)
    return launch3d_wgmma<float>(a, b, c, ij, ks, steps, kt, M, N, K, bk, stream);
  if (in_dtype == 1 && out_dtype == 1)
    return launch3d_wgmma<__nv_bfloat16>(a, b, c, ij, ks, steps, kt, M, N, K, bk, stream);
  return (int)cudaErrorInvalidValue;
}

// The SIMT core's kernels' build and residency, for the record: which = 0
// (sfc_matmul, f32 out), 1 (bf16 out), 2 (sfc_matmul3d, f32 out), 3 (bf16
// out), 4 (sfc_tile_update); out as kernel_info.cuh's, the design
// constants the core's TN, BK and STAGES.
extern "C" int sfc_matmul_simt_info(int which, int* out) {
  const void* fn = which == 0   ? (const void*)matmul_kernel<float>
                   : which == 1 ? (const void*)matmul_kernel<__nv_bfloat16>
                   : which == 2 ? (const void*)matmul3d_kernel<float>
                   : which == 3 ? (const void*)matmul3d_kernel<__nv_bfloat16>
                                : (const void*)tile_update_kernel;
  const int smem = which == 4 ? simt::UPDATE_SMEM_BYTES : simt::SMEM_BYTES;
  return sfc::kernel_info(fn, simt::THREADS, smem, {simt::TN, simt::BK, simt::STAGES}, out);
}
