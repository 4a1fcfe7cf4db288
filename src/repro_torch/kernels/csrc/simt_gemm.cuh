// SIMT f32 GEMM core for Hopper's FP32 pipes, fed by a cp.async ring:
// the f32 path of sfc_matmul and sfc_matmul3d and the whole of
// sfc_tile_update (matmul.cu), the k-means assign kernels' x . c^T
// (kmeans.cu, with an argmin epilogue) and the e-join's x . x^T tile
// pairs (simjoin.cu, with threshold epilogues).
//
// Bound: 2 M N K FMAs' worth of FP32 FLOP/s (67 TFLOP/s on an H100 SXM;
// TF32 stays off, so no tensor core may take an f32 product).  The core
// keeps the FP32 pipes fed:
//
// - A CTA of THREADS threads owns a TILE x TILE output sub-tile; thread
//   tiles of TM x TN outputs sit in warp tiles of 32 rows x 8 TN columns
//   (lanes 4 x 8), so each fragment read is a conflict-free LDS.128 (the
//   8 lanes of a quarter-warp read one A address, broadcast, and 8
//   consecutive float4s of B).  The fragments of step kk + 1 are read
//   while step kk's TM x TN FMAs issue.
// - Operands stream through a ring of STAGES = 3 stages of DEPTH k in
//   shared memory (DEPTH is gemm's template parameter: BK = 32 for the
//   matmuls, the tile update and the assign; 16, or 8 where D <= 8, for
//   the join, whose D = 16 a 32-deep stage would half zero-fill),
//   filled by cp.async with no register staging.  A is either M x K
//   row-major (APanel::MK), copied as [k][row + pad] by 4-byte copies,
//   which transpose it on the way in (a warp's copy covers 8 consecutive
//   k of 4 rows: one 32-byte sector a row in device memory, 32 distinct
//   banks in shared memory with the row stride TILE + 4), or a K x M
//   panel (APanel::KM, the join's x^T), copied as [k][row + pad] rows by
//   16-byte copies.  B is either K x N row-major (BPanel::KN, the matmuls,
//   the assign's centroids, the join's x^T), copied as [k][col] rows by
//   16-byte copies, or an N x K row panel (BPanel::NK, the tile update's
//   B_j), transposed by 4-byte copies exactly as an M x K A is.  Past the
//   M, N and K edges the copies write zeros, the neutral element of the
//   sum.  One CTA barrier a stage.
// - The ring runs on across the CTA's walk: its sub-tiles, its table rows
//   (a persistent CTA walks rows first, first + step, ...) and, in the
//   3-D matmul, its k list.  The stage sequence is one walk, and only the
//   epilogue sits between two sub-tiles.  The epilogue is the caller's
//   (Store: float4 or 4 x bf16 stores of C; Update: O + alpha acc, the O
//   sub-tile prefetched into L2 while the sub-tile's last stages are
//   multiplied; kmeans.cu's Argmin: a running (min, argmin) a row;
//   simjoin.cu's Threshold: hit counts or pairs).  Epi::prefetch and
//   Epi::store take the sub-tile's table row as their last argument (the
//   join reads its global tile ids, offset and total there; the others
//   ignore it).
//
// Numerics: every output element is one __fmaf_rn chain from 0 over its
// stage sequence, k ascending inside a stage, so the walk decides the
// summation order and nothing else does (no split of k, no tensor core).
// A zero-filled depth adds fma(0, 0, acc) = acc, so the stage depth
// changes no bit.
//
// The shape, 256 threads of 8 x 8 outputs and a ring of 3 stages of 32
// deep (2 CTAs an SM, 128 registers), was chosen by timing rows 1 and 2
// at 8192^3 against 4 stages of 16, 3 of 16 and 128 threads of 8 x 16
// (PERF.md, rows 1-2: 24.3 ms for sfc_matmul against 25.5, 25.5 and
// 24.5 on an H100 80GB HBM3 at 700 W; torch.matmul 21.4, bound 16.41).
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace sfc {
namespace simt {

constexpr int TILE = 128;  // the CTA's sub-tile: TILE x TILE outputs
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int BK = 32;     // a stage's depth (the default; the join's is 16)
constexpr int STAGES = 3;  // stages in the ring
constexpr int THREADS = TILE * TILE / (TM * TN);
constexpr int WARPS = THREADS / 32;
constexpr int WARP_COLS = 8 * TN;  // a warp: 32 rows x WARP_COLS columns
constexpr int WARPS_N = TILE / WARP_COLS;
constexpr int LDA = TILE + 4;  // a transposed stage's row stride, [k][row]

// B's layout in device memory: K x N row-major, or an N x K row panel
enum class BPanel { KN, NK };
// A's: M x K row-major, or a K x M panel (the join's x^T, which is also its B)
enum class APanel { MK, KM };

// a ring stage of DEPTH k: A's [k][row + pad], then B's [k][col] (KN) or
// [k][col + pad] (NK); DEPTH a multiple of 8, at least WARPS
template <BPanel BP, int DEPTH = BK>
struct Stage {
  static_assert(DEPTH % 8 == 0 && DEPTH >= WARPS, "a stage is whole 8-deep copy units");
  static constexpr int LDB = BP == BPanel::KN ? TILE : LDA;
  static constexpr int A_FLOATS = DEPTH * LDA;
  static constexpr int FLOATS = A_FLOATS + DEPTH * LDB;
  // copies a thread issues a stage: an M x K (N x K) operand in units of
  // 8 k x 4 rows a warp, unit i at rows + i * ROW_STEP; a K x M (K x N)
  // panel in rows of TILE columns a warp
  static constexpr int UNITS = DEPTH / 8 * (TILE / 4) / WARPS;
  static constexpr int ROW_STEP = 4 * WARPS / (DEPTH / 8);
  static constexpr int K_ROWS = DEPTH / WARPS;
};
// the matmuls' ring
constexpr int SMEM_BYTES = STAGES * Stage<BPanel::KN>::FLOATS * 4;
// two CTAs an SM where their rings fit in its 228 KB (1 KB a CTA reserved)
constexpr int MIN_CTAS = 2 * (SMEM_BYTES + 1024) <= 228 * 1024 ? 2 : 1;
// the tile update's ring, and its CTAs an SM (two)
constexpr int UPDATE_SMEM_BYTES = STAGES * Stage<BPanel::NK>::FLOATS * 4;
constexpr int UPDATE_MIN_CTAS = 2 * (UPDATE_SMEM_BYTES + 1024) <= 228 * 1024 ? 2 : 1;

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// A CTA's walk: the (bm, bn) output tiles (i, j) of its table rows r =
// first, first + step, ... (tiles of them), each as sub-tiles of at most
// TILE x TILE, row-major, each summed over nq depth ranges of span k
// (range q starts at kr[q] * span, or at 0 when kr is null), each range
// in ceil(span / DEPTH) stages (at least one).  Row r of the int32 table is
// sched[r * cols ..], i in its column col_i and j in col_j (j = 0 when
// col_j < 0: one column tile).  Rows 1 and 2 walk one tile of an (i, j)
// table, row 1 one range of span K, row 2 its k list, span bk; row 3 walks
// its table rows x, x + grid, ... over one range of span Kp; the k-means
// assign walks one tile over span D (kmeans.cu), of a 4-column table with
// j = 0 or of an (i, j) table; the e-join's passes walk rows b, b + grid,
// ... of their 2-, 4- or 6-column tables over span D (simjoin.cu).
struct Walk {
  const int* sched;
  int first, step, tiles;
  int bm, bn, M, N;
  const int* kr;
  int nq, span;
  int cols = 2, col_i = 0, col_j = 1;
};

// The matmuls' epilogue: C (M x N, ldc = N) written once, float4 or 4 x bf16.
template <typename TO>
struct Store {
  TO* C;
  int N;
  static constexpr bool PREFETCH = false;
  __device__ void prefetch(int, int, int, int, int) const {}
  __device__ __forceinline__ void store(const float (&acc)[TM][TN], int row0, int rows,
                                        int col0, int cols, int fr, int fc, int) const {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = fr + (i / 4) * 16 + i % 4;
      TO* crow = C + (size_t)(row0 + r) * N + col0;
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const int c = fc + q * 32;
        if (r < rows && c < cols) {
          const float v[4] = {acc[i][q * 4], acc[i][q * 4 + 1], acc[i][q * 4 + 2], acc[i][q * 4 + 3]};
          store4(crow + c, v);
        }
      }
    }
  }
};

// The tile update's epilogue: O(r, c) <- O(r, c) + alpha acc(r, c),
// rounded apart (__fadd_rn(o, __fmul_rn(alpha, acc))), the order of the
// JAX package's `o + alpha * dot(a, b^T)`.  prefetch asks L2 for the O
// sub-tile's lines (128 bytes each) while the sub-tile's last stages are
// multiplied, and the epilogue reads O from there; vec: 16-byte rows (N
// and bn multiples of 4, O 16-byte aligned), else a float at a time.
struct Update {
  float* O;
  int N;
  float alpha;
  bool vec;
  static constexpr bool PREFETCH = true;
  __device__ __forceinline__ void prefetch(int row0, int rows, int col0, int cols, int) const {
    const float* src = O + (size_t)row0 * N + col0;
    for (int i = threadIdx.x; i < TILE * 4; i += THREADS) {
      const int r = i / 4, c = (i % 4) * 32;
      if (r < rows && c < cols) asm volatile("prefetch.global.L2 [%0];" ::"l"(src + (size_t)r * N + c));
    }
  }
  __device__ __forceinline__ void store(const float (&acc)[TM][TN], int row0, int rows, int col0,
                                        int cols, int fr, int fc, int) const {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = fr + (i / 4) * 16 + i % 4;
      if (r >= rows) continue;
      float* orow = O + (size_t)(row0 + r) * N + col0;
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const int c = fc + q * 32;
        if (c >= cols) continue;
        float v[4];
        if (vec) {
          const float4 o4 = *reinterpret_cast<const float4*>(orow + c);
          v[0] = o4.x, v[1] = o4.y, v[2] = o4.z, v[3] = o4.w;
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) v[jj] = c + jj < cols ? orow[c + jj] : 0.f;
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) v[jj] = __fadd_rn(v[jj], __fmul_rn(alpha, acc[i][q * 4 + jj]));
        if (vec) {
          store4(orow + c, v);
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (c + jj < cols) orow[c + jj] = v[jj];
        }
      }
    }
  }
};

// The CTA's walk through the ring, each sub-tile handed to epi with its
// table row (epi.prefetch and epi.store's last argument).  A (MK): M x lda,
// row-major; (KM): a K x lda panel, lda % 4 == 0, 16-byte aligned, bm %
// 4 == 0 or bm == M, M % 4 == 0.  B (KN): rows of ldb floats, ldb % 4 ==
// 0, 16-byte aligned, bn % 4 == 0 or bn == N, N % 4 == 0; (NK): N x ldb,
// row-major, any alignment.  Store's C 16-byte aligned (8 for bf16
// outputs).  The ring: STAGES stages of DEPTH k.
template <BPanel BP, int DEPTH = BK, APanel AP = APanel::MK, typename Epi>
__device__ __forceinline__ void gemm(const float* __restrict__ A, int lda,
                                     const float* __restrict__ B, int ldb, const Walk& w,
                                     const Epi& epi) {
  using St = Stage<BP, DEPTH>;
  constexpr int STAGE_FLOATS = St::FLOATS;
  constexpr int LDB = St::LDB;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // fragment coordinates inside the sub-tile: rows fr + p * 16 + (0..3),
  // columns fc + q * 32 + (0..3)
  const int fr = (warp / WARPS_N) * 32 + (lane / 8) * 4;
  const int fc = (warp % WARPS_N) * WARP_COLS + (lane % 8) * 4;
  // copy coordinates: an M x K unit i is depth ak of row ar + i *
  // St::ROW_STEP (of an N x K panel: depth ak of column ar + i *
  // St::ROW_STEP); row i of a K x M or K x N panel is k = warp + i * WARPS,
  // columns lane * 4 .. + 3
  const int ak = (warp % (DEPTH / 8)) * 8 + lane % 8;
  const int ar = (warp / (DEPTH / 8)) * 4 + lane / 8;

  const int subs_c = (w.bn + TILE - 1) / TILE;
  const int subs = ((w.bm + TILE - 1) / TILE) * subs_c;  // sub-tiles a tile
  const int n_subs = w.tiles * subs;
  const int spt = max(1, (w.span + DEPTH - 1) / DEPTH);  // stages a depth range
  const int per = w.nq * spt;                            // stages a sub-tile
  const int n = n_subs * per;
  // sub-tile u's place, and its table row (returned)
  auto sub = [&](int u, int& row0, int& rows, int& col0, int& cols) {
    const int t = u / subs, v = u - t * subs;
    const int trow = w.first + t * w.step;
    const int* row = w.sched + (size_t)trow * w.cols;
    const int sr = (v / subs_c) * TILE, sc = (v % subs_c) * TILE;
    row0 = row[w.col_i] * w.bm + sr;
    rows = min(min(TILE, w.bm - sr), w.M - row0);
    col0 = (w.col_j < 0 ? 0 : row[w.col_j]) * w.bn + sc;
    cols = min(min(TILE, w.bn - sc), w.N - col0);
    return trow;
  };

  // the issue cursor: sub-tile iu (rows, columns), range iq, stage ss;
  // per sub-tile, this thread's first A source (MK: row ar, depth ak; KM:
  // row warp, columns lane * 4 ..) and B source (KN: row warp, columns
  // lane * 4 ..; NK: row ar, depth ak), and whether the sub-tile is whole
  // (no row or column past an edge)
  int iu = 0, iq = 0, ss = 0;
  int i_row0, i_rows, i_col0, i_cols;
  const float* a_src;
  const float* b_src;
  bool whole;
  auto start = [&](int u) {
    sub(u, i_row0, i_rows, i_col0, i_cols);
    a_src = AP == APanel::MK ? A + (size_t)(i_row0 + ar) * lda + ak
                             : A + (size_t)warp * lda + i_row0 + lane * 4;
    b_src = BP == BPanel::KN ? B + (size_t)warp * ldb + i_col0 + lane * 4
                             : B + (size_t)(i_col0 + ar) * ldb + ak;
    whole = i_rows == TILE && i_cols == TILE;
  };
  start(0);
  int kq = w.kr ? w.kr[0] * w.span : 0;
  const int a_step = AP == APanel::MK ? St::ROW_STEP * lda : WARPS * lda;
  const int b_step = BP == BPanel::KN ? WARPS * ldb : St::ROW_STEP * ldb;
  auto issue = [&](int slot) {
    float* da = smem + slot * STAGE_FLOATS +
                (AP == APanel::MK ? ak * LDA + ar : warp * LDA + lane * 4);
    float* db = smem + slot * STAGE_FLOATS + St::A_FLOATS +
                (BP == BPanel::KN ? warp * TILE + lane * 4 : ak * LDB + ar);
    const int k0 = kq + ss * DEPTH, kv = w.span - ss * DEPTH;  // first k, valid depth
    const float* pa = AP == APanel::MK ? a_src + k0 : a_src + (size_t)k0 * lda;
    const float* pb = BP == BPanel::KN ? b_src + (size_t)k0 * ldb : b_src + k0;
    if (whole && kv >= DEPTH) {  // every copy in range: no predicate
      if (AP == APanel::MK) {
#pragma unroll
        for (int i = 0; i < St::UNITS; ++i) cp_async4(da + i * St::ROW_STEP, pa + i * a_step);
      } else {
#pragma unroll
        for (int i = 0; i < St::K_ROWS; ++i) cp_async16(da + i * WARPS * LDA, pa + i * a_step);
      }
      if (BP == BPanel::KN) {
#pragma unroll
        for (int i = 0; i < St::K_ROWS; ++i) cp_async16(db + i * WARPS * TILE, pb + i * b_step);
      } else {
#pragma unroll
        for (int i = 0; i < St::UNITS; ++i) cp_async4(db + i * St::ROW_STEP, pb + i * b_step);
      }
    } else {  // zeros past the edges (a copy of 0 bytes reads nothing)
      const bool k_ok = ak < kv;
      if (AP == APanel::MK) {
#pragma unroll
        for (int i = 0; i < St::UNITS; ++i)
          cp_async4(da + i * St::ROW_STEP, pa + i * a_step,
                    !(k_ok && ar + i * St::ROW_STEP < i_rows));
      } else {
        const bool r_ok = lane * 4 < i_rows;
#pragma unroll
        for (int i = 0; i < St::K_ROWS; ++i)
          cp_async16(da + i * WARPS * LDA, pa + i * a_step, !(r_ok && warp + i * WARPS < kv));
      }
      if (BP == BPanel::KN) {
        const bool c_ok = lane * 4 < i_cols;
#pragma unroll
        for (int i = 0; i < St::K_ROWS; ++i)
          cp_async16(db + i * WARPS * TILE, pb + i * b_step, !(c_ok && warp + i * WARPS < kv));
      } else {
#pragma unroll
        for (int i = 0; i < St::UNITS; ++i)
          cp_async4(db + i * St::ROW_STEP, pb + i * b_step,
                    !(k_ok && ar + i * St::ROW_STEP < i_cols));
      }
    }
    if (++ss == spt) {  // the next depth range, or the next sub-tile
      ss = 0;
      if (++iq == w.nq) {
        iq = 0;
        if (++iu < n_subs) start(iu);
      }
      if (w.kr && iu < n_subs) kq = w.kr[iq] * w.span;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n) issue(j);
    cp_async_commit();
  }
  // the epilogue's prefetch (Update's O sub-tile) is asked for while the
  // sub-tile's last STAGES stages are multiplied (all of them, in a
  // shorter sub-tile)
  const int o_stage = max(0, per - STAGES);
  int cu = 0, cs = 0;  // the compute cursor: sub-tile cu, stage cs of it
  for (int j = 0; j < n; ++j) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage j have landed
    __syncthreads();               // everyone's; slot (j - 1) % STAGES is free
    if (Epi::PREFETCH && cs == o_stage) {
      int row0, rows, col0, cols;
      const int trow = sub(cu, row0, rows, col0, cols);
      epi.prefetch(row0, rows, col0, cols, trow);
    }
    if (j + STAGES - 1 < n) issue((j + STAGES - 1) % STAGES);
    cp_async_commit();

    const float* as = smem + (j % STAGES) * STAGE_FLOATS;
    const float* bs = as + St::A_FLOATS;
    auto fragments = [&](int kk, float (&fa)[TM], float (&fb)[TN]) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float4 v = *reinterpret_cast<const float4*>(as + kk * LDA + fr + p * 16);
        fa[p * 4 + 0] = v.x, fa[p * 4 + 1] = v.y, fa[p * 4 + 2] = v.z, fa[p * 4 + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(bs + kk * LDB + fc + q * 32);
        fb[q * 4 + 0] = v.x, fb[q * 4 + 1] = v.y, fb[q * 4 + 2] = v.z, fb[q * 4 + 3] = v.w;
      }
    };
    float a[2][TM], b[2][TN];
    fragments(0, a[0], b[0]);
#pragma unroll
    for (int kk = 0; kk < DEPTH; ++kk) {
      if (kk + 1 < DEPTH) fragments(kk + 1, a[(kk + 1) & 1], b[(kk + 1) & 1]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj)
          acc[i][jj] = __fmaf_rn(a[kk & 1][i], b[kk & 1][jj], acc[i][jj]);
    }

    if (++cs == per) {  // the sub-tile's last stage: write it, start the next
      cs = 0;
      int row0, rows, col0, cols;
      const int trow = sub(cu++, row0, rows, col0, cols);
      epi.store(acc, row0, rows, col0, cols, fr, fc, trow);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) acc[i][jj] = 0.f;
    }
  }
  cp_async_wait<0>();
}

}  // namespace simt
}  // namespace sfc
