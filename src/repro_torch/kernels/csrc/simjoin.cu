// The e-similarity join's two passes: sfc_join_hits and sfc_join_emit; the
// sharded join's sfc_join_hits_rows and sfc_join_emit_halo.
//
// Replaces: src/repro/kernels/simjoin.py::_join_kernel (pass 1) and
// ::_emit_kernel (pass 2), both driven by the FGF-Hilbert lower-triangle
// tile schedule; ::_join_rows_kernel and ::_emit_halo_kernel, the two
// passes of the curve-range-sharded join (kernels/sharded.py).
//
// All four run ONE kernel, join_kernel<Pass>, in this one translation unit,
// and so one hit predicate (Threshold::hits): pass 1's per-tile totals and
// pass 2's emitted pairs come from the same bits, and a tile can never
// write more pairs than its offset window holds.  The predicate is
//     d2 = (|xi|^2 - 2 xi.xj) + |xj|^2 <= eps^2
// in simjoin.py::_hit_tile's order, each step an explicit __fmul_rn /
// __fsub_rn / __fadd_rn (an fma(-2, acc, |xi|^2) is another function once
// 2 acc overflows), strict i > j on diagonal tiles and global point index <
// n_valid (ragged N).  xi.xj is one __fmaf_rn chain from 0, k ascending,
// zero past D, and |x|^2 the same chain over x's values (join_norms_kernel,
// once a call), so every count and pair is the first design's to the bit.
//
// Bound on the H100: FP32 FLOP/s (about 2D + 3 operations per candidate
// pair; at the paper's D = 16 a 128 x 128 tile pair is 262,144 FMAs and
// its outputs are small).  The first design (tile_gemm.cuh's product, one
// CTA a tile) ran at 0.30 (pass 1) and 0.20 (pass 2) of it: at D = 16 its
// K loop was one 16-deep chunk, so each of the 2,098,176 CTAs loaded its
// two tiles by 4-byte loads, stored them transposed, passed two barriers
// and only then multiplied, with only the SM's other CTA to hide the
// loads; and its epilogue evaluated five predicates for each of a
// thread's 64 outputs on every tile.  This design (PERF.md, rows 8-11):
// - The walk.  A grid of resident CTAs (min(table rows, CTAs an SM x SMs),
//   the residency asked once per device) walks table rows b, b + grid, ...
//   through simt_gemm.cuh's gemm<KN, DP, KM>: stages of DP = 16 k (the
//   first design's chunk, so the FMA work is not padded to 32) or 8 where
//   D <= 8 (the same bits at half the FMAs), the next simt::STAGES - 1 = 2
//   tiles' operands in flight while a tile is multiplied and its epilogue
//   runs (3 to 6 stages timed within 1 % of each other).  Pass 2 walks
//   only the rows with pairs (kernels/simjoin.py::emission_table compacts
//   its table).
// - The operands.  x goes in once a call as a D x (slots * bpad) K x N
//   panel (kernels/simjoin.py::join_panel: x^T, each tile padded to bpad, a
//   multiple of 4 columns; the padding is skipped), read by 16-byte
//   cp.async as both A and B (A copied from x by 4-byte transposing
//   copies ran 3-7 % slower).  Norms by panel column, |x|^2 of slot s's
//   row r at s bpad + r (computed from the panel, so a padding column's
//   is 0), asked into L1 while the tile is multiplied.
// - The epilogues (Threshold<Pass>) on simt's fragments: a thread's rows
//   fr + p 16 + (0..3), columns fc + q 32 + (0..3), warp tiles of 32 x 64.
//   A tile-uniform flag takes the interior case (ti != tj, both tiles
//   whole and below n_valid) with no per-element mask.  A thread's 64
//   hits are two words (byte ii of word p: row fr + p 16 + ii, bit q 4 +
//   jj: column fc + q 32 + jj), and a warp with none skips its scans.
//   Pass 1: row counts by per-byte popcounts summed over the 8 lanes that
//   share a row (shfl_xor) and the 2 warp columns (shared memory); column
//   counts over a thread's 8 rows, the 4 lanes that share a column and the
//   4 warp rows; each tile's (1, bp) rows and columns written once, with
//   no atomics.  Pass 2: a hit's rank in the tile's row-major order is its
//   row's start (an exclusive scan of the 128 row totals), the hits of
//   warp column 0 (when wc = 1), of q = 0 (when q = 1), an exclusive scan
//   over the 8 lanes, and the bits below it in its nibble; the pair goes
//   out as one 8-byte store at offset + rank, never at or past total.  The
//   epilogue's shared words are rewritten only after the next stage's CTA
//   barrier.  Deferring pass 1's sums to the next tile's epilogue (one
//   CTA barrier a tile fewer) ran 2-6 % slower and spilled.
// At 262,144 x 16 (H100 80GB HBM3, 700 W) pass 1 runs at 0.46 of its
// bound and pass 2 at 0.43, where the matmuls' 32-deep walk on the same
// core reaches 0.67: the difference is the per-tile epilogue (~6
// instructions an output beside 16 FMAs) and barriers, not measured apart.
//
// Tables (int32, row-major): sfc_join_hits (i, j); sfc_join_hits_rows
// (i, j), or (i_slot, j_slot, i, j) over a shard's resident + halo buffer;
// sfc_join_emit (i, j, offset, total); sfc_join_emit_halo (i_slot, j_slot,
// i, j, offset, total), offsets local to the shard's pair buffer.  Tiles
// load by the first two columns and mask by the global ids.
#include <cstdint>

#include "kernel_info.cuh"
#include "simt_gemm.cuh"

namespace {

using namespace sfc;
using simt::THREADS;
using simt::TILE;
using simt::TM;
using simt::TN;
using simt::WARPS_N;

constexpr int DEPTH = 16;  // a stage's depth; 8 where D <= 8
template <int DP>
constexpr int smem_bytes() {
  return simt::STAGES * simt::Stage<simt::BPanel::KN, DP>::FLOATS * 4;
}
constexpr unsigned FULL = 0xffffffffu;

// the passes, in the order sfc_simjoin_info numbers their kernels
enum class Pass { HITS, ROWS, EMIT };

__host__ __device__ constexpr int padded(int bp) { return (bp + 3) / 4 * 4; }

// per-byte popcounts of a word whose bytes hold 8 bits each (<= 8 a byte)
__device__ __forceinline__ uint32_t byte_popc(uint32_t v) {
  v = v - ((v >> 1) & 0x55555555u);
  v = (v & 0x33333333u) + ((v >> 2) & 0x33333333u);
  return (v + (v >> 4)) & 0x0f0f0f0fu;
}

__device__ __forceinline__ int byte_of(uint32_t v, int b) { return (int)((v >> (8 * b)) & 0xffu); }

// simt_gemm.cuh's epilogue for the join: a tile pair's hits, then its
// pass's counts or pairs.  The table row trow holds the load slots (li, lj)
// in columns 0, 1, the global tile ids (ti, tj) in gcol, gcol + 1 and, for
// EMIT, (offset, total) in gcol + 2, gcol + 3.
template <Pass P>
struct Threshold {
  const int* __restrict__ table;
  int cols, gcol;
  const float* __restrict__ norms;
  int bp, bpad, n_valid;
  float eps2;
  int* __restrict__ rows_out;  // HITS, ROWS: (table rows, bp)
  int* __restrict__ cols_out;  // HITS
  int2* __restrict__ pairs;    // EMIT: (p_pad, 2)

  static constexpr bool PREFETCH = true;
  // the tile pair's norms, two 512-byte runs, into L1 while it is multiplied
  __device__ __forceinline__ void prefetch(int, int, int, int, int trow) const {
    const int t = threadIdx.x;
    if (t < 8 && (t % 4) * 32 < bpad) {
      const int slot = table[(size_t)trow * cols + t / 4];
      asm volatile("prefetch.global.L1 [%0];" ::"l"(norms + (size_t)slot * bpad + (t % 4) * 32));
    }
  }

  // the thread's 64 hits: byte ii of w[p] is row fr + p 16 + ii, its bit
  // q 4 + jj column fc + q 32 + jj
  __device__ __forceinline__ void hits(const float (&acc)[TM][TN], int li, int lj, int ti, int tj,
                                       int fr, int fc, uint32_t (&w)[2]) const {
    float nr[TM], nc[TN];
#pragma unroll
    for (int p = 0; p < 2; ++p) {  // a float4 lies wholly below bpad or past it
      const int r = fr + p * 16, c = fc + p * 32;
      const float4 a = r < bpad ? __ldg(reinterpret_cast<const float4*>(norms + (size_t)li * bpad + r))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 b = c < bpad ? __ldg(reinterpret_cast<const float4*>(norms + (size_t)lj * bpad + c))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      nr[p * 4] = a.x, nr[p * 4 + 1] = a.y, nr[p * 4 + 2] = a.z, nr[p * 4 + 3] = a.w;
      nc[p * 4] = b.x, nc[p * 4 + 1] = b.y, nc[p * 4 + 2] = b.z, nc[p * 4 + 3] = b.w;
    }
    w[0] = w[1] = 0u;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float d2 = __fadd_rn(__fsub_rn(nr[i], __fmul_rn(2.f, acc[i][j])), nc[j]);
        w[i / 4] |= (uint32_t)(d2 <= eps2) << ((i % 4) * 8 + j);
      }
    const bool interior = bp == TILE && ti != tj && (ti + 1) * TILE <= n_valid &&
                          (tj + 1) * TILE <= n_valid;
    if (interior) return;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = fr + (i / 4) * 16 + i % 4;
      const bool row_ok = r < bp && ti * bp + r < n_valid;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = fc + (j / 4) * 32 + j % 4;
        const bool ok = row_ok && c < bp && tj * bp + c < n_valid && (ti != tj || r > c);
        if (!ok) w[i / 4] &= ~(1u << ((i % 4) * 8 + j));
      }
    }
  }

  __device__ __forceinline__ void store(const float (&acc)[TM][TN], int, int, int, int, int fr,
                                        int fc, int trow) const {
    // per warp column, the row counts of 4 rows a word (a byte each); HITS:
    // per warp row, the column counts of 4 columns a word
    __shared__ uint32_t row_pk[WARPS_N][TILE / 4];
    __shared__ uint32_t col_pk[TILE / 32][TILE / 4];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wr = warp / WARPS_N, wc = warp % WARPS_N;
    const int* row = table + (size_t)trow * cols;
    const int ti = row[gcol], tj = row[gcol + 1];
    uint32_t w[2];
    hits(acc, row[0], row[1], ti, tj, fr, fc, w);
    const bool any = __any_sync(FULL, (w[0] | w[1]) != 0u);  // warp-uniform

    if (P != Pass::EMIT) {
      if (any) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {  // a row's count over the 8 lanes that share it
          uint32_t n = byte_popc(w[p]);
          n += __shfl_xor_sync(FULL, n, 1);
          n += __shfl_xor_sync(FULL, n, 2);
          n += __shfl_xor_sync(FULL, n, 4);
          if (lane % 8 == 0) row_pk[wc][(fr + p * 16) / 4] = n;
        }
        if (P == Pass::HITS) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {  // a column's count over 8 rows, then 4 lanes
            const uint32_t u = ((w[0] >> (4 * q)) & 0x0f0f0f0fu) |
                               (((w[1] >> (4 * q)) & 0x0f0f0f0fu) << 4);  // a nibble a row
            uint32_t n = 0;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) n |= (uint32_t)__popc(u & (0x11111111u << jj)) << (8 * jj);
            n += __shfl_xor_sync(FULL, n, 8);
            n += __shfl_xor_sync(FULL, n, 16);
            if (lane < 8) col_pk[wr][(fc + q * 32) / 4] = n;
          }
        }
      } else {
        if (lane < 8) row_pk[wc][wr * 8 + lane] = 0u;
        if (P == Pass::HITS && lane < 16) col_pk[wr][wc * 16 + lane] = 0u;
      }
      __syncthreads();
      const int t = threadIdx.x;
      if (t < TILE) {
        if (t < bp) rows_out[(size_t)trow * bp + t] = byte_of(row_pk[0][t / 4] + row_pk[1][t / 4], t % 4);
      } else if (P == Pass::HITS) {
        const int c = t - TILE;
        if (c < bp) {
          uint32_t n = 0;
#pragma unroll
          for (int k = 0; k < TILE / 32; ++k) n += col_pk[k][c / 4];
          cols_out[(size_t)trow * bp + c] = byte_of(n, c % 4);
        }
      }
      return;
    }

    // EMIT: per row, the hits in columns q = 0 (lo) and q = 1 (hi) of the
    // thread, scanned over the 8 lanes that share the row
    uint32_t lo_ex[2], hi_ex[2], lo_tot[2];
    if (any) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint32_t lo = byte_popc(w[p] & 0x0f0f0f0fu);
        const uint32_t hi = byte_popc((w[p] >> 4) & 0x0f0f0f0fu);
        uint32_t a = lo, b = hi;  // inclusive scans, a byte a row
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) {
          const uint32_t ua = __shfl_up_sync(FULL, a, off, 8);
          const uint32_t ub = __shfl_up_sync(FULL, b, off, 8);
          if (lane % 8 >= off) a += ua, b += ub;
        }
        lo_tot[p] = __shfl_sync(FULL, a, 7, 8);
        const uint32_t hi_tot = __shfl_sync(FULL, b, 7, 8);
        lo_ex[p] = a - lo;
        hi_ex[p] = b - hi;
        if (lane % 8 == 0) row_pk[wc][(fr + p * 16) / 4] = lo_tot[p] + hi_tot;
      }
    } else if (lane < 8) {
      row_pk[wc][wr * 8 + lane] = 0u;
    }
    __syncthreads();
    if (!any) return;
    const int offset = row[gcol + 2], total = row[gcol + 3];
    // the exclusive scan of the 128 row totals: lane l holds rows 4 l .. 4 l + 3
    const uint32_t tot = row_pk[0][lane] + row_pk[1][lane];
    const uint32_t t2 = (tot & 0x00ff00ffu) + ((tot >> 8) & 0x00ff00ffu);
    const int s = (int)((t2 & 0xffffu) + (t2 >> 16));
    int inc = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(FULL, inc, off);
      if (lane >= off) inc += u;
    }
    const int ex = inc - s;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int g = (fr + p * 16) / 4;  // this thread's 4 rows
      const int g_start = __shfl_sync(FULL, ex, g);
      const uint32_t g_tot = __shfl_sync(FULL, tot, g);
      const uint32_t left = wc ? row_pk[0][g] : 0u;  // warp column 0's hits of the rows
      for (uint32_t m = w[p]; m; m &= m - 1) {
        const int b = __ffs(m) - 1;
        const int ii = b / 8, q = (b % 8) / 4, jj = b % 4;
        int rank = g_start + byte_of(left, ii) + byte_of(q ? hi_ex[p] : lo_ex[p], ii) +
                   (q ? byte_of(lo_tot[p], ii) : 0) + __popc((w[p] >> (b - jj)) & ((1u << jj) - 1u));
        for (int k = 0; k < ii; ++k) rank += byte_of(g_tot, k);
        if (rank < total)
          pairs[(size_t)offset + rank] =
              make_int2(ti * bp + fr + p * 16 + ii, tj * bp + fc + q * 32 + jj);
      }
    }
  }
};

// |x|^2 by panel column: norms[c] over the D x ldp panel's column c (row
// s bp + r of x at c = s bpad + r), one __fmaf_rn chain from 0, k
// ascending, a warp reading 32 consecutive columns of a panel row; a
// padding column is zero, so its norm is 0
__global__ void join_norms_kernel(const float* __restrict__ panel, int D, int ldp,
                                  float* __restrict__ norms) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ldp) return;
  float acc = 0.f;
  for (int k = 0; k < D; ++k) {
    const float v = panel[(size_t)k * ldp + c];
    acc = __fmaf_rn(v, v, acc);
  }
  norms[c] = acc;
}

// CTA b walks table rows b, b + grid, ... in stages of DP k
template <Pass P, int DP>
__global__ void __launch_bounds__(THREADS, 2)
join_kernel(const float* __restrict__ panel, int D, int ldp, const float* __restrict__ norms,
            const int* __restrict__ table, int cols, int steps, int bp, float eps2, int n_valid,
            int* __restrict__ rows_out, int* __restrict__ cols_out, int* __restrict__ pairs) {
  const int bpad = padded(bp);
  const int tiles = (steps - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const simt::Walk w{table, (int)blockIdx.x, (int)gridDim.x, tiles, bpad, bpad, ldp, ldp,
                     nullptr, 1, D, cols, 0, 1};
  const Threshold<P> epi{table, cols, P == Pass::EMIT ? cols - 4 : cols - 2, norms, bp, bpad,
                         n_valid, eps2, rows_out, cols_out, reinterpret_cast<int2*>(pairs)};
  simt::gemm<simt::BPanel::KN, DP, simt::APanel::KM>(panel, ldp, panel, ldp, w, epi);
}

// the walk of pass P in stages of DP k on a persistent grid of min(steps,
// resident CTAs); launched = (grid, the kernel's sfc_simjoin_info number)
template <Pass P, int DP>
int run(const float* panel, int D, int ldp, const float* norms, const int* table, int cols,
        int steps, int bp, float eps2, int n_valid, int* rows_out, int* cols_out, int* pairs,
        int* launched, cudaStream_t stream) {
  int resident = 0;
  const cudaError_t err = resident_ctas<join_kernel<P, DP>>(THREADS, smem_bytes<DP>(), &resident);
  if (err != cudaSuccess) return (int)err;
  const int grid = steps < resident ? steps : resident;
  join_kernel<P, DP><<<grid, THREADS, smem_bytes<DP>(), stream>>>(
      panel, D, ldp, norms, table, cols, steps, bp, eps2, n_valid, rows_out, cols_out, pairs);
  launched[0] = grid;
  launched[1] = (int)P + (DP == DEPTH ? 0 : 3);
  return (int)cudaGetLastError();
}

// One pass: the norms, then the walk, in stages of 8 k where D <= 8 (the
// zero-filled steps of a 16-deep stage add nothing: the same bits at half
// the FMAs), else 16.  panel: x's D x ldp transpose in tiles of bpad
// columns (ldp = slots bpad), 16-byte aligned; norms: ldp floats of
// scratch, 16-byte aligned; launched: a host int[2], set to the grid and
// the kernel launched (untouched when steps = 0: no launch).  Refused: bp
// past TILE, an unaligned panel.
template <Pass P>
int launch_join(int D, const void* panel, int ldp, void* norms, const void* table, int cols,
                int steps, int bp, float eps2, int n_valid, void* rows_out, void* cols_out,
                void* pairs, void* launched, void* stream) {
  if (steps == 0) return 0;
  const int bpad = padded(bp);
  if (steps < 0 || bp < 1 || bp > TILE || D < 0 || ldp % bpad || (uintptr_t)panel % 16 ||
      (uintptr_t)norms % 16 || launched == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (ldp) join_norms_kernel<<<(ldp + 255) / 256, 256, 0, st>>>((const float*)panel, D, ldp,
                                                                (float*)norms);
  auto go = D <= 8 ? run<P, 8> : run<P, DEPTH>;
  return go((const float*)panel, D, ldp, (const float*)norms, (const int*)table, cols, steps, bp,
            eps2, n_valid, (int*)rows_out, (int*)cols_out, (int*)pairs, (int*)launched, st);
}

}  // namespace

extern "C" int sfc_join_hits(int D, const void* panel, int ldp, void* norms, const void* table,
                             int steps, int bp, float eps2, int n_valid, void* row_hits,
                             void* col_hits, void* launched, void* stream) {
  return launch_join<Pass::HITS>(D, panel, ldp, norms, table, 2, steps, bp, eps2, n_valid, row_hits,
                                 col_hits, nullptr, launched, stream);
}

extern "C" int sfc_join_emit(int D, const void* panel, int ldp, void* norms, const void* table,
                             int steps, int bp, float eps2, int n_valid, void* out, void* launched,
                             void* stream) {
  return launch_join<Pass::EMIT>(D, panel, ldp, norms, table, 4, steps, bp, eps2, n_valid, nullptr,
                                 nullptr, out, launched, stream);
}

extern "C" int sfc_join_hits_rows(int D, const void* panel, int ldp, void* norms, const void* table,
                                  int cols, int steps, int bp, float eps2, int n_valid,
                                  void* row_hits, void* launched, void* stream) {
  if (cols != 2 && cols != 4) return (int)cudaErrorInvalidValue;
  return launch_join<Pass::ROWS>(D, panel, ldp, norms, table, cols, steps, bp, eps2, n_valid,
                                 row_hits, nullptr, nullptr, launched, stream);
}

extern "C" int sfc_join_emit_halo(int D, const void* panel, int ldp, void* norms,
                                  const void* table, int steps, int bp, float eps2, int n_valid,
                                  void* out, void* launched, void* stream) {
  return launch_join<Pass::EMIT>(D, panel, ldp, norms, table, 6, steps, bp, eps2, n_valid, nullptr,
                                 nullptr, out, launched, stream);
}

// The build and residency of the join kernel of each pass (kernel_info.cuh;
// launches nothing): which = 0 pass 1 (sfc_join_hits), 1 its row-count form
// (sfc_join_hits_rows), 2 pass 2 (sfc_join_emit, sfc_join_emit_halo); 3-5
// the same in stages of 8 k (D <= 8); with simt_gemm.cuh's thread-tile
// columns, the stage depth and the stages (TN, depth, STAGES).
extern "C" int sfc_simjoin_info(int which, int* out) {
  const void* fns[6] = {(const void*)join_kernel<Pass::HITS, DEPTH>,
                        (const void*)join_kernel<Pass::ROWS, DEPTH>,
                        (const void*)join_kernel<Pass::EMIT, DEPTH>,
                        (const void*)join_kernel<Pass::HITS, 8>,
                        (const void*)join_kernel<Pass::ROWS, 8>,
                        (const void*)join_kernel<Pass::EMIT, 8>};
  if (which < 0 || which >= 6) return (int)cudaErrorInvalidValue;
  const int dp = which < 3 ? DEPTH : 8;
  return sfc::kernel_info(fns[which], THREADS, which < 3 ? smem_bytes<DEPTH>() : smem_bytes<8>(),
                          {TN, dp, simt::STAGES}, out);
}
