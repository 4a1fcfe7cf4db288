// Blocked right-looking Cholesky: one launch per barrier group of the
// phased table.
//
// Replaces: src/repro/kernels/cholesky.py::_fused_chol_kernel (the fused
// TPU kernel, all k-blocks in one pallas_call) and its per-k oracle's
// _diag_kernel (_chol_tile) and _panel_kernel (_solve_tile).  The TPU
// kernel walks the phased (phase, k, i, j) table in grid order and keeps
// L_kk and the finished L_*k panel in VMEM scratch.  A GPU grid runs its
// CTAs concurrently and the phases of one k depend on each other, so here
// every (k, phase) barrier group is its own launch, one CTA per table
// row: CTA x reads (i, j) at row `row_begin + x` (columns col_i and
// col_i + 1).  The per-k form launches the diag and panel kernels with
// its own per-k tables and its trailing update through sfc_tile_update
// (matmul.cu); the fused trailing kernel here runs the same device
// function (tile_gemm.cuh::tile_update), so both forms agree to the bit.
//
// No workspace: the panel phase writes only column k below the diagonal
// and reads L_kk, which no CTA of that launch writes; trailing tiles
// (k < j <= i) never write column k, so they read L_ik and L_jk straight
// from the matrix.
//
// Bound on the H100: FP32 FMAs with TF32 off (n^3/3 flops in all, nearly
// all of them in the trailing phase: the SIMT 128x128 tile product of
// tile_gemm.cuh).  The diag phase (one CTA per k) and the panel phase (at
// most n/b - 1 CTAs per k) are latency-bound sequential loops:
//   diag:  b steps; the tile stays in registers, 8x8 per thread, and only
//          column t goes through shared memory at step t;
//   panel: X . L_kk^T = A_ik by forward substitution, one thread per row
//          of the tile (rows are independent), L_kk and the tile in
//          dynamic shared memory (2 b^2 floats, 128 KB at b = 128, above
//          the 48 KB static limit, hence cudaFuncSetAttribute).
// Every rounding step is an explicit intrinsic (no FMA contraction of
// a - b * c), the order of the JAX package's tile code.
//
// Limits: 8 <= b <= 128, b % 8 == 0 (the wrapper raises otherwise).
#include <mutex>

#include "phased.cuh"

namespace {

using namespace sfc;

// phase 0: cholesky.py::_chol_tile on the tile in place.  Step t:
// d = sqrt(a[t][t]); col = a[:, t] / d; a[r][c] -= col[r] col[c] for
// r, c > t; column t becomes (0 above, d on, col below the diagonal).
__global__ void __launch_bounds__(THREADS)
chol_diag_kernel(float* D, const int* sched, int sched_cols, int col_i, int row_begin, int n,
                 int b) {
  __shared__ __align__(16) float colt[TILE];
  const int2 t0 = cta_tile(sched, sched_cols, col_i, row_begin);
  float* T = tile_at(D, n, b, t0.x, t0.y);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float a[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = tile_row(ty, i), c = tile_col(tx, j);
      a[i][j] = (r < b && c < b) ? T[(size_t)r * n + c] : 0.f;
    }
  for (int t = 0; t < b; ++t) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (tile_col(tx, j) == t) {
#pragma unroll
        for (int i = 0; i < 8; ++i) colt[tile_row(ty, i)] = a[i][j];
      }
    __syncthreads();
    const float d = __fsqrt_rn(colt[t]);
    float cr[8], cc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) cr[i] = __fdiv_rn(colt[tile_row(ty, i)], d);
#pragma unroll
    for (int j = 0; j < 8; ++j) cc[j] = __fdiv_rn(colt[tile_col(tx, j)], d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = tile_row(ty, i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile_col(tx, j);
        if (r > t && c > t)
          a[i][j] = __fsub_rn(a[i][j], __fmul_rn(cr[i], cc[j]));
        else if (c == t)
          a[i][j] = r > t ? cr[i] : (r == t ? d : 0.f);
      }
    }
    __syncthreads();  // column t + 1 is staged next
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = tile_row(ty, i), c = tile_col(tx, j);
      if (r < b && c < b) T[(size_t)r * n + c] = a[i][j];
    }
}

// phase 1: cholesky.py::_solve_tile: X with X . L_kk^T = A_ik, in place.
// Thread r owns row r of the tile: x[r][t] = (a[r][t] - sum_{c<t}
// x[r][c] L[t][c]) / L[t][t], the sum taken in c order.
__global__ void __launch_bounds__(TILE)
chol_panel_kernel(float* D, const int* sched, int sched_cols, int col_i, int row_begin, int k,
                  int n, int b) {
  extern __shared__ float sh[];
  float* Ls = sh;          // L_kk, row-major, b x b
  float* Xs = sh + b * b;  // the tile, column-major with stride b + 1
  const int ldx = b + 1;
  const int2 t0 = cta_tile(sched, sched_cols, col_i, row_begin);
  const float* L = tile_at(D, n, b, k, k);
  float* T = tile_at(D, n, b, t0.x, t0.y);
  for (int idx = threadIdx.x; idx < b * b; idx += blockDim.x) {
    const int r = idx / b, c = idx % b;
    Ls[idx] = L[(size_t)r * n + c];
    Xs[c * ldx + r] = T[(size_t)r * n + c];
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < b) {
    for (int t = 0; t < b; ++t) {
      const float* lrow = Ls + t * b;
      float s = 0.f;
      for (int c = 0; c < t; ++c) s = __fmaf_rn(Xs[c * ldx + r], lrow[c], s);
      Xs[t * ldx + r] = __fdiv_rn(__fsub_rn(Xs[t * ldx + r], s), lrow[t]);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < b * b; idx += blockDim.x) {
    const int rr = idx / b, c = idx % b;
    T[(size_t)rr * n + c] = Xs[c * ldx + rr];
  }
}

// phase 2: A_ij <- A_ij - L_ik . L_jk^T for k < j <= i (tile_update,
// alpha = -1, the per-k form's sfc_tile_update call on the same values)
__global__ void __launch_bounds__(THREADS)
chol_trailing_kernel(float* D, const int* sched, int sched_cols, int col_i, int row_begin, int k,
                     int n, int b) {
  __shared__ __align__(16) float As[BK * TILE];
  __shared__ __align__(16) float Bs[BK * TILE];
  const int2 t0 = cta_tile(sched, sched_cols, col_i, row_begin);
  tile_update(tile_at(D, n, b, t0.x, t0.y), (size_t)n, tile_at(D, n, b, t0.x, k), (size_t)n,
              tile_at(D, n, b, t0.y, k), (size_t)n, b, b, b, -1.f, As, Bs);
}

// the panel kernel's dynamic shared memory at the largest block: L_kk and
// the tile, 2 TILE^2 + TILE floats (128.5 KB)
constexpr int PANEL_SMEM_MAX = (TILE * TILE + TILE * (TILE + 1)) * (int)sizeof(float);
constexpr int MAX_DEVICES = 64;

}  // namespace

// Every entry point: matrix d (n x n f32, in place), table sched (int32,
// sched_cols columns, (i, j) at col_i), CTAs = table rows row_begin ..
// row_begin + ctas - 1, k the k-block.
extern "C" int sfc_chol_diag(void* d, const void* sched, int sched_cols, int col_i, int row_begin,
                             int ctas, int k, int n, int b, void* stream) {
  (void)k;
  if (bad_block(b)) return (int)cudaErrorInvalidValue;
  chol_diag_kernel<<<ctas, THREADS, 0, (cudaStream_t)stream>>>(
      (float*)d, (const int*)sched, sched_cols, col_i, row_begin, n, b);
  return (int)cudaGetLastError();
}

extern "C" int sfc_chol_panel(void* d, const void* sched, int sched_cols, int col_i, int row_begin,
                              int ctas, int k, int n, int b, void* stream) {
  if (bad_block(b)) return (int)cudaErrorInvalidValue;
  // above the 48 KB static limit: raised once per device, at the largest
  // block, not on every launch
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t attr[MAX_DEVICES];
  std::call_once(once[dev], [dev] {
    attr[dev] = cudaFuncSetAttribute(chol_panel_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, PANEL_SMEM_MAX);
  });
  if (attr[dev] != cudaSuccess) return (int)attr[dev];
  const size_t smem = (size_t)(b * b + b * (b + 1)) * sizeof(float);
  chol_panel_kernel<<<ctas, TILE, smem, (cudaStream_t)stream>>>(
      (float*)d, (const int*)sched, sched_cols, col_i, row_begin, k, n, b);
  return (int)cudaGetLastError();
}

extern "C" int sfc_chol_trailing(void* d, const void* sched, int sched_cols, int col_i,
                                 int row_begin, int ctas, int k, int n, int b, void* stream) {
  if (bad_block(b)) return (int)cudaErrorInvalidValue;
  chol_trailing_kernel<<<ctas, THREADS, 0, (cudaStream_t)stream>>>(
      (float*)d, (const int*)sched, sched_cols, col_i, row_begin, k, n, b);
  return (int)cudaGetLastError();
}
