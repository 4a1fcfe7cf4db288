// One Lloyd iteration as two launches: sfc_kmeans_assign + sfc_kmeans_update.
//
// Replaces: src/repro/kernels/kmeans.py::_fused_lloyd_kernel (the TPU
// kernel of kmeans_lloyd_fused / kmeans_lloyd_program).  That kernel
// relies on its grid running in order twice: a running (min, argmin) per
// point tile read-modify-written across phase-0 steps, and one resident
// (Kp, D) accumulator shared by every phase-1 step.  CTAs of a GPU grid
// run concurrently, so:
//
// (a) assign: one CTA per point tile (a phase-1 row of the kmeans
//     schedule, so point tiles are taken in the curve's first-visit
//     order).  It loops over ALL centroids in 128-wide chunks, computes
//     m = |c|^2 - 2 x.c (kmeans.py::_assign_tile), masks centroids at or
//     past k_valid with FLT_MAX, and keeps the running (min, argmin) in
//     registers with the (value, index) tie rule, so the smallest index
//     wins among equal minima exactly as argmin does.  `arg` is written
//     once per point.
//     Bound on the H100: FP32 FLOP/s (2 N Kp D; TF32 is off).  Design:
//     the same SIMT 128x128 tile product as sfc_matmul (tile_gemm.cuh)
//     with an argmin epilogue, so the (N, Kp) metric matrix never
//     reaches device memory.
//
// (b) update: grid (point group g, 128-centroid range).  CTA (g, c)
//     scans the point tiles of group g in schedule order and adds every
//     valid point (row < n_valid, kmeans.py::_update_tile's row mask)
//     assigned to its centroid range into a (128, D) shared-memory
//     partial; warp w owns the centroids with (k % 8) == w, so no two
//     threads ever add into one address and no atomics are needed.  Each
//     partial is written once to psum[g] / pcnt[g]; the host folds them
//     with one torch sum over g.  Every sum is taken in a fixed order, so
//     the result is deterministic from run to run.
//     Bound on the H100: bytes (x read once: N D 4 bytes).  Design: the
//     whole (Kp, D) accumulator (512 KB at Kp=1024, D=128) cannot sit in
//     one CTA's shared memory, hence the split by centroid range.
#include <cfloat>
#include <climits>

#include "tile_gemm.cuh"

namespace {

using namespace sfc;

__global__ void __launch_bounds__(THREADS)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     const float* __restrict__ cn, const int* __restrict__ sched, int sched_cols,
                     int col_i, int bp, int Kp, int D, int k_valid, float* __restrict__ min_out,
                     int* __restrict__ arg_out) {
  __shared__ __align__(16) float As[BK * TILE];
  __shared__ __align__(16) float Bs[BK * TILE];
  const int ti = sched[(size_t)blockIdx.x * sched_cols + col_i];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  for (int sr = 0; sr < bp; sr += TILE) {
    const size_t row0 = (size_t)ti * bp + sr;
    const int rows = min(TILE, bp - sr);
    RowLoader<float> la{x + row0 * D, (size_t)D, rows, D};
    float best_v[8];
    int best_a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      best_v[i] = __int_as_float(0x7f800000);  // +inf: loses to every real metric
      best_a[i] = INT_MAX;
    }
    for (int c0 = 0; c0 < Kp; c0 += TILE) {
      RowLoader<float> lb{c + (size_t)c0 * D, (size_t)D, min(TILE, Kp - c0), D};
      float acc[8][8];
      tile_product<false>(acc, la, lb, D, As, Bs, nullptr);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v = __int_as_float(0x7f800000);
        int a = INT_MAX;
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // columns ascend with j
          const int col = c0 + tile_col(tx, j);
          if (col >= Kp) continue;
          float m = __fsub_rn(cn[col], __fmul_rn(2.f, acc[i][j]));
          if (col >= k_valid) m = FLT_MAX;
          if (m < v) {
            v = m;
            a = col;
          }
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {  // the 16 threads sharing a row
          const float ov = __shfl_xor_sync(0xffffffffu, v, off);
          const int oa = __shfl_xor_sync(0xffffffffu, a, off);
          if (ov < v || (ov == v && oa < a)) {
            v = ov;
            a = oa;
          }
        }
        if (v < best_v[i] || (v == best_v[i] && a < best_a[i])) {
          best_v[i] = v;
          best_a[i] = a;
        }
      }
    }
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = tile_row(ty, i);
        if (r < rows) {
          min_out[row0 + r] = best_v[i];
          arg_out[row0 + r] = best_a[i];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
kmeans_update_kernel(const float* __restrict__ x, const int* __restrict__ arg,
                     const int* __restrict__ sched, int sched_cols, int col_i, int pt,
                     int tiles_per_group, int bp, int n_valid, int Kp, int D,
                     float* __restrict__ psum, float* __restrict__ pcnt) {
  extern __shared__ float sh[];
  float* ssum = sh;                      // [TILE][D]
  int* scnt = reinterpret_cast<int*>(sh + (size_t)TILE * D);  // [TILE]
  const int g = blockIdx.x;
  const int k0 = blockIdx.y * TILE;
  const int kn = min(TILE, Kp - k0);
  for (int idx = threadIdx.x; idx < TILE * D; idx += THREADS) ssum[idx] = 0.f;
  if (threadIdx.x < TILE) scnt[threadIdx.x] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r_lo = g * tiles_per_group;
  const int r_hi = min(pt, r_lo + tiles_per_group);
  for (int r = r_lo; r < r_hi; ++r) {
    const size_t base = (size_t)sched[(size_t)r * sched_cols + col_i] * bp;
    for (int p0 = 0; p0 < bp; p0 += 32) {
      const int p = p0 + lane;
      const size_t row = base + p;
      const int a = (p < bp && row < (size_t)n_valid) ? arg[row] : -1;
      const int kl = a - k0;
      const bool mine = a >= 0 && kl >= 0 && kl < kn && (kl & 7) == warp;
      unsigned mask = __ballot_sync(0xffffffffu, mine);
      while (mask) {  // warp-uniform: every lane walks the same points
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const int k = __shfl_sync(0xffffffffu, kl, src);
        const float* xr = x + (base + p0 + src) * D;
        float* acc = ssum + (size_t)k * D;
        for (int d = lane; d < D; d += 32) acc[d] += xr[d];
        if (lane == 0) scnt[k] += 1;
      }
    }
  }
  __syncthreads();
  float* out = psum + ((size_t)g * Kp + k0) * D;
  for (int idx = threadIdx.x; idx < kn * D; idx += THREADS) out[idx] = ssum[idx];
  if (threadIdx.x < kn) pcnt[(size_t)g * Kp + k0 + threadIdx.x] = (float)scnt[threadIdx.x];
}

}  // namespace

extern "C" int sfc_kmeans_assign(const void* x, const void* c, const void* cn, const void* sched,
                                 int steps, int sched_cols, int col_i, int bp, int Kp, int D,
                                 int k_valid, void* min_out, void* arg_out, void* stream) {
  kmeans_assign_kernel<<<steps, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)c, (const float*)cn, (const int*)sched, sched_cols, col_i, bp,
      Kp, D, k_valid, (float*)min_out, (int*)arg_out);
  return (int)cudaGetLastError();
}

extern "C" int sfc_kmeans_update(const void* x, const void* arg, const void* sched, int sched_cols,
                                 int col_i, int pt, int groups, int ctiles, int tiles_per_group, int bp,
                                 int n_valid, int Kp, int D, void* psum, void* pcnt,
                                 void* stream) {
  const size_t smem = (size_t)TILE * D * sizeof(float) + TILE * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(kmeans_update_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(groups, ctiles);
  kmeans_update_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)arg, (const int*)sched, sched_cols, col_i, pt, tiles_per_group,
      bp, n_valid, Kp, D, (float*)psum, (float*)pcnt);
  return (int)cudaGetLastError();
}
