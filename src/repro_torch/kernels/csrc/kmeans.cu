// One Lloyd iteration as two launches: sfc_kmeans_assign + sfc_kmeans_update;
// the reference path's assignment as sfc_kmeans_assign_tiles; one sharded
// Lloyd step as sfc_kmeans_shard_assign + sfc_kmeans_shard_update, its
// exact fold as sfc_kmeans_fold.
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
// (b) update: grid (point group g, 128-centroid range, column chunk).
//     A group is a run of tiles_per_group consecutive point-tile ids; the
//     wrapper's group table lists each group's tiles in the schedule's
//     order, groups in the order the schedule first reaches them.
//     CTA (g, c, z) scans the point tiles of group g in table order
//     and adds columns [z dchunk, (z + 1) dchunk) of every valid point
//     (row < n_valid, kmeans.py::_update_tile's row mask) assigned to its
//     centroid range into a (128, dchunk) shared-memory partial; warp w
//     owns the centroids with (k % 8) == w, so no two threads ever add
//     into one address and no atomics are needed.  Each partial is
//     written once to psum[g] / pcnt[g] (the counts by the z = 0 CTA
//     only); the host folds them with one torch sum over g.  Every sum
//     is taken in a fixed order, so the result is deterministic from run
//     to run, and each output element is summed by one CTA over the same
//     points in the same order whatever the chunking.
//     Bound on the H100: bytes (x read once: N D 4 bytes).  Design: the
//     whole (Kp, D) accumulator (512 KB at Kp=1024, D=128) cannot sit in
//     one CTA's shared memory, hence the split by centroid range; a
//     128 x D partial fits the 227 KB a CTA may have only up to D = 453,
//     hence the split by columns (the wrapper sizes dchunk: D = 960,
//     GIST1M's width, runs as three 320-column chunks of 160 KB).
//
// Replaces also: src/repro/kernels/kmeans.py::_update_kernel (the TPU
// kernel of kmeans_update_swizzled, the reference path's update), which
// launches (b) over its own (point tile, first_visit) table.
//
// (c) assign_tiles: src/repro/kernels/kmeans.py::_assign_kernel (the TPU
//     kernel of kmeans_assign_swizzled: ops.kmeans_assign, the reference
//     Lloyd path and the streaming service's assign command).  One CTA
//     per row (i, j) of a 2-D (point tile, centroid tile) curve table;
//     it writes the (min, first argmin) of point tile i over centroid
//     tile j once, to its own (i, j) slot of the (pt, ct, bp) partials,
//     and a torch argmin over ct merges them.  It runs the same device
//     code as (a) over a centroid range, so every metric and every
//     tie-break is the same: the reference path equals the fused one to
//     the bit.
//     Bound on the H100: FP32 FLOP/s (2 N Kp D), as (a).  Design: the
//     (i, j) grid has pt ct CTAs where (a) has pt, so a streaming batch
//     of 4,096 probes fills 256 CTAs at K = 1024 where (a) fills 32 of
//     the 132 SMs.
//
// (d) shard step: src/repro/kernels/kmeans.py::_shard_lloyd_kernel (the
//     TPU kernel of kmeans_shard_program, one Lloyd step on one shard of
//     the curve-range-sharded k-means).  It is (a) and (b) again, as two
//     launches, with two differences the sharded fold needs:
//     - the ragged masks are device operands, lim = (n_valid_local,
//       k_valid), so one launch configuration serves every shard, as the
//       TPU kernel's dynamic operand does;
//     - the update writes one partial per group of its shard's group
//       table, through the same update_partial as (b).  The exact class
//       gives it the single-core groups (shards are whole groups wide),
//       so each group partial is the single-core one to the bit and one
//       torch sum over the gathered groups, in the single-core group
//       order, is the single-core sum; the tree and psum classes give it
//       one tile per group.  Every slot is written, zeros included: a
//       shard of pure padding (more shards than tiles) holds zeros, not
//       garbage.
//     sfc_kmeans_fold left-folds per-tile partials in the order of a
//     device table, one thread per (k, d) element, one fixed chain of f32
//     adds (the tree class's local fold; the JAX package's lax.scan).
//     Bound on the H100: FP32 FLOP/s for the assign (2 N Kp D), bytes
//     for the update (x read, groups Kp (D + 1) 4 bytes of partials
//     written) and the fold (the partials read once).  Before the group
//     partials the exact class wrote and folded one partial per tile
//     (4.1 GB at SIFT1M's 7,813 tiles and K = 1024): a 28 ms gather copy
//     and a 13.7 ms fold per call.  At SIFT1M's 62 tiles a group it
//     writes 127 partials.
#include <cfloat>
#include <climits>

#include "tile_gemm.cuh"

namespace {

using namespace sfc;

// Running (min, first argmin) of m = |c|^2 - 2 x.c for the rows [row0,
// row0 + rows) of x over centroids [c_lo, c_hi), in 128-wide chunks from
// c_lo; centroids at or past k_valid count as FLT_MAX.  Thread (tx, ty)
// returns the result of its rows tile_row(ty, i) in best_v / best_a (the
// 16 threads of a row agree).  Both assign kernels run exactly this.
__device__ __forceinline__ void assign_rows(const float* __restrict__ x, const float* __restrict__ c,
                                            const float* __restrict__ cn, size_t row0, int rows,
                                            int D, int c_lo, int c_hi, int k_valid, float (&best_v)[8],
                                            int (&best_a)[8], float* As, float* Bs) {
  const int tx = threadIdx.x & 15;
  RowLoader<float> la{x + row0 * D, (size_t)D, rows, D};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best_v[i] = __int_as_float(0x7f800000);  // +inf: loses to every real metric
    best_a[i] = INT_MAX;
  }
  for (int c0 = c_lo; c0 < c_hi; c0 += TILE) {
    RowLoader<float> lb{c + (size_t)c0 * D, (size_t)D, min(TILE, c_hi - c0), D};
    float acc[8][8];
    tile_product<false>(acc, la, lb, D, As, Bs, nullptr);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = __int_as_float(0x7f800000);
      int a = INT_MAX;
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // columns ascend with j
        const int col = c0 + tile_col(tx, j);
        if (col >= c_hi) continue;
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
}

// Point tile ti's (min, first argmin) over all Kp centroids, written once
// per point to min_out / arg_out.  Both one-CTA-per-point-tile assign
// kernels run exactly this.
__device__ __forceinline__ void assign_tile(const float* __restrict__ x, const float* __restrict__ c,
                                            const float* __restrict__ cn, int ti, int bp, int Kp,
                                            int D, int k_valid, float* __restrict__ min_out,
                                            int* __restrict__ arg_out, float* As, float* Bs) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  for (int sr = 0; sr < bp; sr += TILE) {
    const size_t row0 = (size_t)ti * bp + sr;
    const int rows = min(TILE, bp - sr);
    float best_v[8];
    int best_a[8];
    assign_rows(x, c, cn, row0, rows, D, 0, Kp, k_valid, best_v, best_a, As, Bs);
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
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     const float* __restrict__ cn, const int* __restrict__ sched, int sched_cols,
                     int col_i, int bp, int Kp, int D, int k_valid, float* __restrict__ min_out,
                     int* __restrict__ arg_out) {
  __shared__ __align__(16) float As[BK * TILE];
  __shared__ __align__(16) float Bs[BK * TILE];
  const int ti = sched[(size_t)blockIdx.x * sched_cols + col_i];
  assign_tile(x, c, cn, ti, bp, Kp, D, k_valid, min_out, arg_out, As, Bs);
}

// The shard step's assign: as kmeans_assign_kernel, with k_valid read from
// the device limits lim = (n_valid_local, k_valid), so one launch
// configuration serves every shard.
__global__ void __launch_bounds__(THREADS)
kmeans_shard_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                           const float* __restrict__ cn, const int* __restrict__ sched,
                           int sched_cols, int col_i, int bp, int Kp, int D,
                           const int* __restrict__ lim, float* __restrict__ min_out,
                           int* __restrict__ arg_out) {
  __shared__ __align__(16) float As[BK * TILE];
  __shared__ __align__(16) float Bs[BK * TILE];
  const int ti = sched[(size_t)blockIdx.x * sched_cols + col_i];
  assign_tile(x, c, cn, ti, bp, Kp, D, lim[1], min_out, arg_out, As, Bs);
}

// CTA s: point tile i = sched[s][0] against centroid tile j = sched[s][1];
// its partial lands at [(i ct + j) bp, +bp) of min_out / arg_out.
__global__ void __launch_bounds__(THREADS)
kmeans_assign_tiles_kernel(const float* __restrict__ x, const float* __restrict__ c,
                           const float* __restrict__ cn, const int* __restrict__ sched, int bp,
                           int bc, int ct, int Kp, int D, int k_valid, float* __restrict__ min_out,
                           int* __restrict__ arg_out) {
  __shared__ __align__(16) float As[BK * TILE];
  __shared__ __align__(16) float Bs[BK * TILE];
  const int ti = sched[2 * (size_t)blockIdx.x];
  const int tj = sched[2 * (size_t)blockIdx.x + 1];
  const int c_lo = tj * bc;
  const int c_hi = min(Kp, c_lo + bc);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t out0 = ((size_t)ti * ct + tj) * bp;
  for (int sr = 0; sr < bp; sr += TILE) {
    const size_t row0 = (size_t)ti * bp + sr;
    const int rows = min(TILE, bp - sr);
    float best_v[8];
    int best_a[8];
    assign_rows(x, c, cn, row0, rows, D, c_lo, c_hi, k_valid, best_v, best_a, As, Bs);
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = tile_row(ty, i);
        if (r < rows) {
          min_out[out0 + sr + r] = best_v[i];
          arg_out[out0 + sr + r] = best_a[i];
        }
      }
    }
  }
}

// The (128-centroid range blockIdx.y, column chunk blockIdx.z) block of
// the partial over the point tiles of schedule rows [r_lo, r_hi), written
// once to psum_g (Kp, D) / pcnt_g (Kp) (the counts by the z = 0 CTA).
// Rows at or past n_valid add nothing; a CTA with no row to add writes
// zeros.  Both update kernels run exactly this.
__device__ __forceinline__ void update_partial(const float* __restrict__ x,
                                               const int* __restrict__ arg,
                                               const int* __restrict__ sched, int sched_cols,
                                               int col_i, int r_lo, int r_hi, int bp, int n_valid,
                                               int Kp, int D, int dchunk, float* __restrict__ psum_g,
                                               float* __restrict__ pcnt_g) {
  extern __shared__ float sh[];
  float* ssum = sh;                      // [TILE][dchunk]
  int* scnt = reinterpret_cast<int*>(sh + (size_t)TILE * dchunk);  // [TILE]
  const int k0 = blockIdx.y * TILE;
  const int kn = min(TILE, Kp - k0);
  const int d0 = blockIdx.z * dchunk;
  const int dn = min(dchunk, D - d0);
  for (int idx = threadIdx.x; idx < TILE * dchunk; idx += THREADS) ssum[idx] = 0.f;
  if (threadIdx.x < TILE) scnt[threadIdx.x] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
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
        const float* xr = x + (base + p0 + src) * D + d0;
        float* acc = ssum + (size_t)k * dchunk;
        for (int d = lane; d < dn; d += 32) acc[d] += xr[d];
        if (lane == 0) scnt[k] += 1;
      }
    }
  }
  __syncthreads();
  float* out = psum_g + (size_t)k0 * D + d0;
  for (int idx = threadIdx.x; idx < kn * dn; idx += THREADS)
    out[(size_t)(idx / dn) * D + idx % dn] = ssum[(size_t)(idx / dn) * dchunk + idx % dn];
  if (blockIdx.z == 0 && threadIdx.x < kn) pcnt_g[k0 + threadIdx.x] = (float)scnt[threadIdx.x];
}

__global__ void __launch_bounds__(THREADS)
kmeans_update_kernel(const float* __restrict__ x, const int* __restrict__ arg,
                     const int* __restrict__ sched, int sched_cols, int col_i, int pt,
                     int tiles_per_group, int bp, int n_valid, int Kp, int D, int dchunk,
                     float* __restrict__ psum, float* __restrict__ pcnt) {
  const int g = blockIdx.x;
  const int r_lo = g * tiles_per_group;
  update_partial(x, arg, sched, sched_cols, col_i, r_lo, min(pt, r_lo + tiles_per_group), bp,
                 n_valid, Kp, D, dchunk, psum + (size_t)g * Kp * D, pcnt + (size_t)g * Kp);
}

// The shard step's update: CTA (g, c, z) folds the point tiles of table
// rows [g tpg, (g + 1) tpg) into group slot g, masked by the device
// n_valid_local = lim[0].  A shard of pure padding (n_valid_local = 0)
// writes zeros to every slot.
__global__ void __launch_bounds__(THREADS)
kmeans_shard_update_kernel(const float* __restrict__ x, const int* __restrict__ arg,
                           const int* __restrict__ sched, int sched_cols, int col_i,
                           int tiles_per_group, int bp, const int* __restrict__ lim, int Kp, int D,
                           int dchunk, float* __restrict__ psum, float* __restrict__ pcnt) {
  const size_t g = blockIdx.x;
  const int r_lo = (int)g * tiles_per_group;
  update_partial(x, arg, sched, sched_cols, col_i, r_lo, r_lo + tiles_per_group, bp, lim[0], Kp,
                 D, dchunk, psum + g * Kp * D, pcnt + g * Kp);
}

// out[e] = parts[order[0]][e] + parts[order[1]][e] + ..., a left fold in
// the order of the table, one thread per element of the (Kp, D) partial.
__global__ void __launch_bounds__(256)
kmeans_fold_kernel(const float* __restrict__ parts, const int* __restrict__ order, int n,
                   size_t elems, float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (e >= elems) return;
  float acc = n ? parts[(size_t)order[0] * elems + e] : 0.f;
  for (int t = 1; t < n; ++t) acc = __fadd_rn(acc, parts[(size_t)order[t] * elems + e]);
  out[e] = acc;
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
                                 int col_i, int pt, int groups, int ctiles, int dchunks,
                                 int tiles_per_group, int bp, int n_valid, int Kp, int D, int dchunk,
                                 void* psum, void* pcnt, void* stream) {
  const size_t smem = (size_t)TILE * dchunk * sizeof(float) + TILE * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(kmeans_update_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(groups, ctiles, dchunks);
  kmeans_update_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)arg, (const int*)sched, sched_cols, col_i, pt, tiles_per_group,
      bp, n_valid, Kp, D, dchunk, (float*)psum, (float*)pcnt);
  return (int)cudaGetLastError();
}

extern "C" int sfc_kmeans_assign_tiles(const void* x, const void* c, const void* cn,
                                       const void* sched, int steps, int bp, int bc, int ct, int Kp,
                                       int D, int k_valid, void* min_out, void* arg_out,
                                       void* stream) {
  kmeans_assign_tiles_kernel<<<steps, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)c, (const float*)cn, (const int*)sched, bp, bc, ct, Kp, D,
      k_valid, (float*)min_out, (int*)arg_out);
  return (int)cudaGetLastError();
}

extern "C" int sfc_kmeans_shard_assign(const void* x, const void* c, const void* cn,
                                       const void* sched, int steps, int sched_cols, int col_i,
                                       int bp, int Kp, int D, const void* lim, void* min_out,
                                       void* arg_out, void* stream) {
  kmeans_shard_assign_kernel<<<steps, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)c, (const float*)cn, (const int*)sched, sched_cols, col_i, bp,
      Kp, D, (const int*)lim, (float*)min_out, (int*)arg_out);
  return (int)cudaGetLastError();
}

extern "C" int sfc_kmeans_shard_update(const void* x, const void* arg, const void* sched,
                                       int sched_cols, int col_i, int groups, int ctiles,
                                       int dchunks, int tiles_per_group, int bp, const void* lim,
                                       int Kp, int D, int dchunk, void* psum, void* pcnt,
                                       void* stream) {
  const size_t smem = (size_t)TILE * dchunk * sizeof(float) + TILE * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(kmeans_shard_update_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(groups, ctiles, dchunks);
  kmeans_shard_update_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)arg, (const int*)sched, sched_cols, col_i, tiles_per_group, bp,
      (const int*)lim, Kp, D, dchunk, (float*)psum, (float*)pcnt);
  return (int)cudaGetLastError();
}

extern "C" int sfc_kmeans_fold(const void* parts, const void* order, int n, int Kp, int D, void* out,
                               void* stream) {
  const size_t elems = (size_t)Kp * D;
  const unsigned blocks = (unsigned)((elems + 255) / 256);
  kmeans_fold_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((const float*)parts,
                                                               (const int*)order, n, elems,
                                                               (float*)out);
  return (int)cudaGetLastError();
}
