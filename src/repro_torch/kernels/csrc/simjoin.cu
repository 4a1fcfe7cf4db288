// The e-similarity join's two passes: sfc_join_hits and sfc_join_emit; the
// sharded join's sfc_join_hits_rows and sfc_join_emit_halo.
//
// Replaces: src/repro/kernels/simjoin.py::_join_kernel (pass 1) and
// ::_emit_kernel (pass 2), both driven by the FGF-Hilbert lower-triangle
// tile schedule; ::_join_rows_kernel and ::_emit_halo_kernel, the two
// passes of the curve-range-sharded join (kernels/sharded.py).
//
// Both kernels call ONE device function, hit_tile(), in this one
// translation unit, so pass 1's per-tile totals and pass 2's emitted
// pairs come from the same bits: a tile can never write more pairs than
// its offset window holds.  hit_tile() computes
//     d2 = (|xi|^2 - 2 xi.xj) + |xj|^2
// in the order simjoin.py::_hit_tile uses, with every product and sum an
// explicit __fmaf_rn / __fmul_rn / __fsub_rn / __fadd_rn intrinsic summed
// in feature order, so FMA contraction cannot differ between the passes.
// The hit mask is d2 <= eps^2, strict i > j on diagonal tiles, and global
// point index < n_valid (ragged N).
//
// sfc_join_hits: one CTA per schedule row (i_tile, j_tile); it writes its
// own (1, bp) row-count and column-count rows, so CTAs are independent
// in any order.  Row counts reduce across the 16 threads sharing a row
// with shuffles; column counts through shared-memory integer adds (exact
// in any order).
//
// sfc_join_emit: one CTA per row of the (i, j, offset, total) table.  An
// in-CTA prefix sum over the row-major hit mask gives each hit its rank,
// and the pair (gi, gj) is written at offset + rank.  This replaces the
// TPU kernel's stable-argsort compaction and masked read-modify-write of
// a cap-row window: each CTA owns rows [offset, offset + total) and writes
// only those, in row-major in-tile order, exactly the JAX order.
//
// sfc_join_hits_rows: pass 1 of the sharded join, row counts only (the
// pair emission's prefix-sum input; no column counts and no shared-memory
// atomics).  Its table has 2 columns (i, j) when every shard holds the
// whole point set, or 4 (i_slot, j_slot, i, j) over a shard's resident +
// halo buffer: the slots say where the tiles lie in the buffer, the global
// ids decide the diagonal strictness and the n_valid mask.  hit_tile()
// takes the two pairs apart for that, and the single-core kernels pass
// the same pair twice.
//
// sfc_join_emit_halo: pass 2 over the resident + halo buffer, rows (i_slot,
// j_slot, i, j, offset, total) with the offset local to the shard's own
// (p_pad, 2) pair buffer.  The same emit_tile() as sfc_join_emit; a padding
// row (total = 0) returns at once.
//
// Bound on the H100: FP32 FLOP/s at D = 16 (about 2D + 3 operations per
// candidate pair; the outputs are small).  Design: the SIMT 128x128 tile
// product of tile_gemm.cuh with a threshold epilogue; bp <= 128, one
// 128x128 tile per CTA.
#include "tile_gemm.cuh"

namespace {

using namespace sfc;

// hit[i] bit j: pair (tile_row(ty, i), tile_col(tx, j)) of the tile pair
// whose points lie in tiles (li, lj) of x and whose global tile ids are
// (ti, tj): the diagonal strictness and the n_valid mask are defined on
// global point indices, so a halo buffer loads by slot and masks by id.
__device__ __forceinline__ void hit_tile(const float* __restrict__ x, int D, int li, int lj, int ti,
                                         int tj, int bp, float eps2, int n_valid, float* As,
                                         float* Bs, float* norms, unsigned char (&hit)[8]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  RowLoader<float> la{x + (size_t)li * bp * D, (size_t)D, bp, D};
  RowLoader<float> lb{x + (size_t)lj * bp * D, (size_t)D, bp, D};
  float acc[8][8];
  float nrm;
  tile_product<true>(acc, la, lb, D, As, Bs, &nrm);
  norms[threadIdx.x] = nrm;  // [0, 128): |xi|^2, [128, 256): |xj|^2
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tile_row(ty, i);
    const bool row_ok = r < bp && ti * bp + r < n_valid;
    unsigned char bits = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_col(tx, j);
      const float d2 = __fadd_rn(__fsub_rn(norms[r], __fmul_rn(2.f, acc[i][j])), norms[TILE + c]);
      const bool ok = row_ok && c < bp && tj * bp + c < n_valid && (ti != tj || r > c) &&
                      d2 <= eps2;
      bits |= (unsigned char)ok << j;
    }
    hit[i] = bits;
  }
}

__global__ void __launch_bounds__(THREADS)
join_hits_kernel(const float* __restrict__ x, int D, const int* __restrict__ sched, int bp,
                 float eps2, int n_valid, int* __restrict__ row_hits, int* __restrict__ col_hits) {
  __shared__ __align__(16) float As[BK * TILE];
  __shared__ __align__(16) float Bs[BK * TILE];
  __shared__ float norms[2 * TILE];
  __shared__ int colcnt[TILE];
  const int ti = sched[2 * (size_t)blockIdx.x];
  const int tj = sched[2 * (size_t)blockIdx.x + 1];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  if (threadIdx.x < TILE) colcnt[threadIdx.x] = 0;
  unsigned char hit[8];
  hit_tile(x, D, ti, tj, ti, tj, bp, eps2, n_valid, As, Bs, norms, hit);
  int* rows_out = row_hits + (size_t)blockIdx.x * bp;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int n = __popc(hit[i]);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) n += __shfl_xor_sync(0xffffffffu, n, off);
    const int r = tile_row(ty, i);
    if (tx == 0 && r < bp) rows_out[r] = n;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int n = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) n += (hit[i] >> j) & 1;
    if (n) atomicAdd(&colcnt[tile_col(tx, j)], n);
  }
  __syncthreads();
  if (threadIdx.x < bp) col_hits[(size_t)blockIdx.x * bp + threadIdx.x] = colcnt[threadIdx.x];
}

// The pairs of tile pair (li, lj) -> global (ti, tj), written at
// out[offset + rank] for rank < total, in row-major in-tile order.  Both
// emission kernels run exactly this.
__device__ __forceinline__ void emit_tile(const float* __restrict__ x, int D, int li, int lj, int ti,
                                          int tj, int offset, int total, int bp, float eps2,
                                          int n_valid, int* __restrict__ out) {
  __shared__ __align__(16) float As[BK * TILE];
  __shared__ __align__(16) float Bs[BK * TILE];
  __shared__ float norms[2 * TILE];
  __shared__ int row_total[TILE];
  __shared__ int row_start[TILE];
  if (total == 0) return;  // uniform across the CTA: nothing to write
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int lane16 = threadIdx.x & 15;
  unsigned char hit[8];
  hit_tile(x, D, li, lj, ti, tj, bp, eps2, n_valid, As, Bs, norms, hit);
  // Row r's columns in row-major order: first halves (cols 4tx..4tx+3) of
  // tx = 0..15, then second halves (64+4tx..64+4tx+3) of tx = 0..15.
  int pre_lo[8], pre_hi[8], tot_lo[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int lo = __popc(hit[i] & 0x0f);
    const int hi = __popc(hit[i] >> 4);
    int inc_lo = lo, inc_hi = hi;  // inclusive scans over the 16 threads of the row
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      const int a = __shfl_up_sync(0xffffffffu, inc_lo, off, 16);
      const int b = __shfl_up_sync(0xffffffffu, inc_hi, off, 16);
      if (lane16 >= off) {
        inc_lo += a;
        inc_hi += b;
      }
    }
    tot_lo[i] = __shfl_sync(0xffffffffu, inc_lo, 15, 16);
    const int tot_hi = __shfl_sync(0xffffffffu, inc_hi, 15, 16);
    pre_lo[i] = inc_lo - lo;
    pre_hi[i] = inc_hi - hi;
    if (tx == 0) row_total[tile_row(ty, i)] = tot_lo[i] + tot_hi;
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // exclusive scan of the 128 row totals, 4 per lane
    const int lane = threadIdx.x;
    int v[4], s = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = row_total[lane * 4 + q];
      s += v[q];
    }
    int inc = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int a = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += a;
    }
    int run = inc - s;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      row_start[lane * 4 + q] = run;
      run += v[q];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tile_row(ty, i);
    const int gi = ti * bp + r;
    int rank_lo = row_start[r] + pre_lo[i];
    int rank_hi = row_start[r] + tot_lo[i] + pre_hi[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!((hit[i] >> j) & 1)) continue;
      const int rank = j < 4 ? rank_lo++ : rank_hi++;
      if (rank < total) {  // never past this tile's window
        int* o = out + 2 * ((size_t)offset + rank);
        o[0] = gi;
        o[1] = tj * bp + tile_col(tx, j);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
join_emit_kernel(const float* __restrict__ x, int D, const int* __restrict__ table, int bp,
                 float eps2, int n_valid, int* __restrict__ out) {
  const int* row = table + 4 * (size_t)blockIdx.x;
  emit_tile(x, D, row[0], row[1], row[0], row[1], row[2], row[3], bp, eps2, n_valid, out);
}

// Row counts only, over a 2-column (i, j) table or a 4-column
// (i_slot, j_slot, i, j) one: tiles load by columns (0, 1) and mask by the
// global columns (cols - 2, cols - 1).
__global__ void __launch_bounds__(THREADS)
join_hits_rows_kernel(const float* __restrict__ x, int D, const int* __restrict__ sched, int cols,
                      int bp, float eps2, int n_valid, int* __restrict__ row_hits) {
  __shared__ __align__(16) float As[BK * TILE];
  __shared__ __align__(16) float Bs[BK * TILE];
  __shared__ float norms[2 * TILE];
  const int* row = sched + (size_t)cols * blockIdx.x;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  unsigned char hit[8];
  hit_tile(x, D, row[0], row[1], row[cols - 2], row[cols - 1], bp, eps2, n_valid, As, Bs, norms,
           hit);
  int* rows_out = row_hits + (size_t)blockIdx.x * bp;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int n = __popc(hit[i]);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) n += __shfl_xor_sync(0xffffffffu, n, off);
    const int r = tile_row(ty, i);
    if (tx == 0 && r < bp) rows_out[r] = n;
  }
}

// Emission over a shard's resident + halo buffer: 6-column rows
// (i_slot, j_slot, i, j, offset, total), the offset local to the shard's
// own pair buffer.
__global__ void __launch_bounds__(THREADS)
join_emit_halo_kernel(const float* __restrict__ x, int D, const int* __restrict__ table, int bp,
                      float eps2, int n_valid, int* __restrict__ out) {
  const int* row = table + 6 * (size_t)blockIdx.x;
  emit_tile(x, D, row[0], row[1], row[2], row[3], row[4], row[5], bp, eps2, n_valid, out);
}

}  // namespace

extern "C" int sfc_join_hits(const void* x, int D, const void* sched, int steps, int bp, float eps2,
                             int n_valid, void* row_hits, void* col_hits, void* stream) {
  join_hits_kernel<<<steps, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, D, (const int*)sched, bp, eps2, n_valid, (int*)row_hits, (int*)col_hits);
  return (int)cudaGetLastError();
}

extern "C" int sfc_join_emit(const void* x, int D, const void* table, int steps, int bp, float eps2,
                             int n_valid, void* out, void* stream) {
  join_emit_kernel<<<steps, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, D, (const int*)table, bp, eps2, n_valid, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int sfc_join_hits_rows(const void* x, int D, const void* sched, int cols, int steps,
                                  int bp, float eps2, int n_valid, void* row_hits, void* stream) {
  join_hits_rows_kernel<<<steps, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, D, (const int*)sched, cols, bp, eps2, n_valid, (int*)row_hits);
  return (int)cudaGetLastError();
}

extern "C" int sfc_join_emit_halo(const void* x, int D, const void* table, int steps, int bp,
                                  float eps2, int n_valid, void* out, void* stream) {
  join_emit_halo_kernel<<<steps, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, D, (const int*)table, bp, eps2, n_valid, (int*)out);
  return (int)cudaGetLastError();
}
