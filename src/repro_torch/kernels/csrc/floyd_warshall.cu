// Blocked Floyd-Warshall: one launch per barrier group of the phased table.
//
// Replaces: src/repro/kernels/floyd_warshall.py::_fused_fw_kernel (the
// fused TPU kernel, all k-blocks in one pallas_call) and its per-k
// oracle's _diag_kernel, _row_panel_kernel, _col_panel_kernel and
// _trailing_kernel.  The TPU kernel walks the phased (phase, k, i, j)
// table in grid order and carries the closed diagonal and the finished
// row / column panels of the current k in VMEM scratch.  A GPU grid runs
// its CTAs concurrently and the phases of one k depend on each other, so
// here every (k, phase) barrier group is its own launch, one CTA per
// table row: CTA x reads (i, j) at row `row_begin + x` (columns col_i and
// col_i + 1).  The fused and the per-k forms launch these same four
// kernels, with the phased table or with their own per-k tables, so they
// agree to the last bit.
//
// No n-sized workspace: trailing tiles (i, j != k) never write row k or
// column k, so they read D_ik and D_kj straight from the matrix.  The
// diagonal is the exception: the row phase's j = k CTA and the column
// phase's i = k CTA write D_kk while every other CTA of the launch reads
// the closed diagonal.  The diag kernel therefore writes the closed tile
// to D_kk AND to a (b, b) workspace, and the panels read the workspace,
// as the TPU kernel reads its diag_ref copy.
//
// Bound on the H100: (min, +) operations on the FP32 pipes, which have no
// tensor-core path: one add and one min per candidate, 2 n^3 lane
// instructions for the whole closure.  The trailing and panel phases run
// the SIMT 128x128 tile product of tile_gemm.cuh in the MinPlus semiring
// (loaders fill +inf past the tile edge: b need not be a multiple of 16).
// The diagonal closure is b sequential steps inside one CTA (latency
// bound); the tile stays in registers, 8x8 per thread, and only row t
// and column t go through shared memory at step t.
//
// Limits: 8 <= b <= 128, b % 8 == 0 (one tile per CTA; the wrapper
// raises for anything else).
#include "phased.cuh"

namespace {

using namespace sfc;

// O <- min(O, A (x) B) over one b x b tile, (x) the (min, +) product.
template <typename LA, typename LB>
__device__ __forceinline__ void minplus_update(float* O, int ldo, const LA& la, const LB& lb, int b,
                                               float* As, float* Bs) {
  float acc[8][8];
  // every global read of A and B (one of which may be O itself) ends
  // before tile_product's last barrier, so the writes below are safe
  tile_product<MinPlus>(acc, la, lb, b, As, Bs);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tile_row(ty, i);
    if (r >= b) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_col(tx, j);
      if (c >= b) continue;
      float* o = O + (size_t)r * ldo + c;
      *o = fminf(*o, acc[i][j]);
    }
  }
}

// phase 0: in-tile closure of D_kk (floyd_warshall.py::_fw_closure): at
// step t every element takes min(d, d[r][t] + d[t][c]) with row t and
// column t as they were before the step.
__global__ void __launch_bounds__(THREADS)
fw_diag_kernel(float* D, float* ws, const int* sched, int sched_cols, int col_i, int row_begin,
               int n, int b) {
  __shared__ __align__(16) float rowt[TILE];
  __shared__ __align__(16) float colt[TILE];
  const int2 t0 = cta_tile(sched, sched_cols, col_i, row_begin);
  float* T = tile_at(D, n, b, t0.x, t0.y);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float d[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = tile_row(ty, i), c = tile_col(tx, j);
      d[i][j] = (r < b && c < b) ? T[(size_t)r * n + c] : MinPlus::zero();
    }
  for (int t = 0; t < b; ++t) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (tile_row(ty, i) == t) {
#pragma unroll
        for (int j = 0; j < 8; ++j) rowt[tile_col(tx, j)] = d[i][j];
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (tile_col(tx, j) == t) {
#pragma unroll
        for (int i = 0; i < 8; ++i) colt[tile_row(ty, i)] = d[i][j];
      }
    __syncthreads();
    const float4 c0 = *reinterpret_cast<const float4*>(colt + ty * 4);
    const float4 c1 = *reinterpret_cast<const float4*>(colt + 64 + ty * 4);
    const float4 r0 = *reinterpret_cast<const float4*>(rowt + tx * 4);
    const float4 r1 = *reinterpret_cast<const float4*>(rowt + 64 + tx * 4);
    const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const float rv[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) d[i][j] = fminf(d[i][j], __fadd_rn(cv[i], rv[j]));
    __syncthreads();  // row t + 1 / column t + 1 are staged next
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = tile_row(ty, i), c = tile_col(tx, j);
      if (r < b && c < b) {
        T[(size_t)r * n + c] = d[i][j];
        ws[r * b + c] = d[i][j];
      }
    }
}

// phase 1: D_kj <- min(D_kj, W (x) D_kj), W the closed diagonal (workspace)
__global__ void __launch_bounds__(THREADS)
fw_row_kernel(float* D, const float* ws, const int* sched, int sched_cols, int col_i,
              int row_begin, int n, int b) {
  __shared__ __align__(16) float As[BK * TILE];
  __shared__ __align__(16) float Bs[BK * TILE];
  const int2 t = cta_tile(sched, sched_cols, col_i, row_begin);
  float* P = tile_at(D, n, b, t.x, t.y);
  RowLoader<float> la{ws, (size_t)b, b, b, MinPlus::zero()};
  KLoader<float> lb{P, (size_t)n, b, b, MinPlus::zero()};
  minplus_update(P, n, la, lb, b, As, Bs);
}

// phase 2: D_ik <- min(D_ik, D_ik (x) W)
__global__ void __launch_bounds__(THREADS)
fw_col_kernel(float* D, const float* ws, const int* sched, int sched_cols, int col_i,
              int row_begin, int n, int b) {
  __shared__ __align__(16) float As[BK * TILE];
  __shared__ __align__(16) float Bs[BK * TILE];
  const int2 t = cta_tile(sched, sched_cols, col_i, row_begin);
  float* P = tile_at(D, n, b, t.x, t.y);
  RowLoader<float> la{P, (size_t)n, b, b, MinPlus::zero()};
  KLoader<float> lb{ws, (size_t)b, b, b, MinPlus::zero()};
  minplus_update(P, n, la, lb, b, As, Bs);
}

// phase 3: D_ij <- min(D_ij, D_ik (x) D_kj), i != k and j != k
__global__ void __launch_bounds__(THREADS)
fw_trailing_kernel(float* D, const int* sched, int sched_cols, int col_i, int row_begin, int k,
                   int n, int b) {
  __shared__ __align__(16) float As[BK * TILE];
  __shared__ __align__(16) float Bs[BK * TILE];
  const int2 t = cta_tile(sched, sched_cols, col_i, row_begin);
  RowLoader<float> la{tile_at(D, n, b, t.x, k), (size_t)n, b, b, MinPlus::zero()};
  KLoader<float> lb{tile_at(D, n, b, k, t.y), (size_t)n, b, b, MinPlus::zero()};
  minplus_update(tile_at(D, n, b, t.x, t.y), n, la, lb, b, As, Bs);
}

}  // namespace

// Every entry point: matrix d (n x n f32, in place), workspace ws (b x b
// f32), table sched (int32, sched_cols columns, (i, j) at col_i), CTAs =
// table rows row_begin .. row_begin + ctas - 1, k the k-block.
extern "C" int sfc_fw_diag(void* d, void* ws, const void* sched, int sched_cols, int col_i,
                           int row_begin, int ctas, int k, int n, int b, void* stream) {
  (void)k;
  if (bad_block(b)) return (int)cudaErrorInvalidValue;
  fw_diag_kernel<<<ctas, THREADS, 0, (cudaStream_t)stream>>>(
      (float*)d, (float*)ws, (const int*)sched, sched_cols, col_i, row_begin, n, b);
  return (int)cudaGetLastError();
}

extern "C" int sfc_fw_row(void* d, void* ws, const void* sched, int sched_cols, int col_i,
                          int row_begin, int ctas, int k, int n, int b, void* stream) {
  (void)k;
  if (bad_block(b)) return (int)cudaErrorInvalidValue;
  fw_row_kernel<<<ctas, THREADS, 0, (cudaStream_t)stream>>>(
      (float*)d, (const float*)ws, (const int*)sched, sched_cols, col_i, row_begin, n, b);
  return (int)cudaGetLastError();
}

extern "C" int sfc_fw_col(void* d, void* ws, const void* sched, int sched_cols, int col_i,
                          int row_begin, int ctas, int k, int n, int b, void* stream) {
  (void)k;
  if (bad_block(b)) return (int)cudaErrorInvalidValue;
  fw_col_kernel<<<ctas, THREADS, 0, (cudaStream_t)stream>>>(
      (float*)d, (const float*)ws, (const int*)sched, sched_cols, col_i, row_begin, n, b);
  return (int)cudaGetLastError();
}

extern "C" int sfc_fw_trailing(void* d, void* ws, const void* sched, int sched_cols, int col_i,
                               int row_begin, int ctas, int k, int n, int b, void* stream) {
  (void)ws;
  if (bad_block(b)) return (int)cudaErrorInvalidValue;
  fw_trailing_kernel<<<ctas, THREADS, 0, (cudaStream_t)stream>>>(
      (float*)d, (const int*)sched, sched_cols, col_i, row_begin, k, n, b);
  return (int)cudaGetLastError();
}
