// Blocked right-looking Cholesky: one launch per barrier group of the
// phased table.
//
// Replaces: src/repro/kernels/cholesky.py::_fused_chol_kernel (the fused
// TPU kernel, all k-blocks in one pallas_call) and its per-k oracle's
// _diag_kernel (_chol_tile) and _panel_kernel (_solve_tile).  The TPU
// kernel walks the phased (phase, k, i, j) table in grid order and keeps
// L_kk and the finished L_*k panel in VMEM scratch.  A GPU grid runs its
// CTAs concurrently and the phases of one k depend on each other, so here
// every (k, phase) barrier group is its own launch over its table rows:
// diag and panel CTA x read (i, j) at row `row_begin + x` (columns col_i
// and col_i + 1), a persistent trailing CTA the rows x, x + grid, ....
// The per-k form launches the diag and panel kernels with its own per-k
// tables and its trailing update through sfc_tile_update (matmul.cu, on
// simt_gemm.cuh's loop with its Update epilogue); the fused trailing
// kernel here computes each element by the same chain of rounded
// operations, so both forms agree to the bit.
//
// No workspace: the panel phase writes only column k below the diagonal
// and reads L_kk, which no CTA of that launch writes; trailing tiles
// (k < j <= i) never write column k, so they read L_ik and L_jk straight
// from the matrix.
//
// Bound on the H100: FP32 FMAs with TF32 off (n^3/3 flops in all, nearly
// all of them in the trailing phase, 2.671 ms of the 2.735 at n = 8192).
// The trailing phase first ran sfc_tile_update's first kernel (the 8 x 8
// loop of tile_gemm.cuh), one CTA a tile: 16-deep chunks loaded 4 bytes
// a thread and stored transposed, two CTA barriers a chunk, O read and
// written a scalar at a time after the product; at depth b = 128 its 63 launches took 10.87 ms (0.25 of
// the bound), against 0.47 for the same core at depth 8192 (row 1).
// Now (chol_trailing_kernel below) a persistent CTA an SM keeps every
// load in flight a tile ahead through 16-byte cp.async and reads 4 k a
// time: 7.41-7.58 ms (sfc_tile_update on the same tiles 10.87-11.04 and
// 63 addmm_ of the full trailing square 10.98-11.07 in the same runs;
// NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py).  A 128-thread CTA of
// 8 x 16 thread tiles ran no faster, so what bounds it is the FMA loop
// itself (0.36 of the bound), not its loads.  The diag phase (one CTA per
// k) and the panel phase (at most (n/b - 1) b/32 CTAs per k) are
// latency-bound sequential loops:
//   diag:  b dependent sqrt + divide steps on one SM.  The first design
//          held the tile in registers, 8x8 per thread, and ran b
//          steps of two CTA barriers and 16 IEEE divisions per thread
//          each (4,096 divisions a step where b - t - 1 are needed):
//          248-270 us a tile at b = 128, 17.31 ms for the 64 tiles of
//          n = 8192 (H100 80GB HBM3, 700 W).  This design keeps the tile
//          in dynamic shared memory (b x (b + 1) floats, 66 KB at
//          b = 128) and factors it in panels of 32 columns.  Inside a
//          panel no CTA barrier is taken: warp 0 factors the 32-row
//          diagonal block in registers (one row a lane, the pivot and
//          multipliers by __shfl_sync, each element below the diagonal
//          divided once) and publishes each finished column through
//          shared memory and a release/acquire flag; warps 1-3 follow a
//          step behind on the rows below, reading the column back.  The
//          step loop stays rolled, so the body is small: it runs once per
//          launch, from a cold instruction cache.  The whole CTA
//          then applies the panel's 32 rank-1 updates, in ascending t, to
//          the lower triangle right of the panel (4x4 register blocks
//          reading the panel from shared memory).  Two CTA barriers a
//          panel: 8 at b = 128.  The b sequential steps of pivot, square
//          root and division on one warp remain its bound.
//   panel: X . L_kk^T = A_ik by forward substitution; the rows of the
//          tile are independent, the dependency runs along the columns.
//          The first design took one thread per row of the tile, whose
//          step t summed t products from shared memory in one chain: 128
//          threads a CTA, at most n/b - 1 = 63 CTAs on 132 SMs, so every
//          launch took one tile's latency, and the 63 launches of n = 8192
//          took 8.70 ms (H100 80GB HBM3, 700 W; batched solve_triangular
//          1.30 ms).  This design is right-looking and takes no CTA
//          barrier inside a solve: a warp owns 4 rows, lane l holds
//          columns l, l + 32, l + 64, l + 96 of each in registers, and at
//          step t the pivot column's value is broadcast by __shfl_sync
//          from lane t % 32, divided by L[t][t], and every lane subtracts
//          x L[c][t] from its columns c > t with one fmaf each.  The
//          quotient is the correctly rounded one, from the pivot's
//          correctly rounded reciprocal and one FMA correction
//          (Markstein), so __fdiv_rn's slow path (for subnormal or huge
//          operands) is never taken.  L_kk^T
//          sits in shared memory (row t holds L[c][t] for c > t, zeros
//          elsewhere), so the 32 lanes' reads of L[c][t] are one
//          conflict-free row, and each step's operands are read while the
//          step before runs.  A CTA is 8 warps, a strip of 32 rows of one
//          tile, so a tile is b / 32 CTAs (252 at k = 0 where there were
//          63), and each CTA reads L_kk (64 KB at b = 128) from L2: 16 MB
//          per launch at k = 0.  That read is a launch's fixed cost, so it
//          is straight-line code: a warp loads 128 contiguous bytes of a
//          row of L_kk a time, all of a thread's 64 loads in flight before
//          any is stored, no division or branch in the index arithmetic,
//          each store to its own bank; the tile rows' loads are issued
//          before it: the 63 launches of n = 8192, repeated in place,
//          take 1.006-1.044 ms, 1.388 with a first load loop of 16-byte
//          loads, an integer division and a branch a load (batched
//          solve_triangular 1.26-1.32 in the same runs; H100 80GB HBM3,
//          700 W; chip_smoke.py).  What bounds a launch now is one
//          warp's 128 dependent shuffle-divide-FMA steps, not the card's
//          width.
// Every rounding step is an explicit intrinsic (no FMA contraction of
// a - b * c), the order of the JAX package's tile code: each element of
// the diagonal tile sees a[r][c] = a[r][c] - L[r][t] L[c][t] (product,
// then difference, each rounded) for t = 0, 1, ... in turn, then one
// division by its column's pivot, as in _chol_tile, so the diag kernel
// equals the plain version to the bit.
//
// Limits: 8 <= b <= 128, b % 8 == 0 (the wrapper raises otherwise).
#include <mutex>

#include "cp_async.cuh"
#include "phased.cuh"

namespace {

using namespace sfc;

// phase 0: cholesky.py::_chol_tile on the tile in place.  Step t:
// d = sqrt(a[t][t]); col = a[:, t] / d; a[r][c] -= col[r] col[c] for
// r, c > t; column t becomes (0 above, d on, col below the diagonal).
constexpr int DIAG_THREADS = 256;
constexpr int PANEL = 32;  // columns a panel
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void flag_release(unsigned* f, unsigned v) {
  asm volatile("st.release.cta.shared::cta.u32 [%0], %1;" ::"r"(smem_addr(f)), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned flag_acquire(const unsigned* f) {
  unsigned v;
  asm volatile("ld.acquire.cta.shared::cta.u32 %0, [%1];" : "=r"(v) : "r"(smem_addr(f)) : "memory");
  return v;
}

// The panel (columns c0 .. c0 + pw - 1) is factored by four warps that
// take no CTA barrier.  Warp 0 leads: it factors the 32x32 diagonal block
// in registers, one column a step, writes each finished column to S and
// then raises `flag` to the number of columns done.  Slot jj of a lane's
// registers holds element (row, c0 + j + jj) at step j: the update of
// column j + jj lands in slot jj - 1, so the next column is always slot 0
// and the loop over j stays rolled (a small body).  Slots of the upper
// triangle and past the panel are updated too and never read.
__device__ __forceinline__ void factor_block(float* S, int ld, int c0, int pw, int b, int lane,
                                             unsigned* flag) {
  const int rd = c0 + lane;
  float dg[PANEL];
#pragma unroll
  for (int j = 0; j < PANEL; ++j) dg[j] = (rd < b && j < pw) ? S[rd * ld + c0 + j] : 0.f;
  float pv = __shfl_sync(FULL, dg[0], 0);  // the next pivot, a[c0 + j][c0 + j]
  for (int j = 0; j < pw; ++j) {
    const float d = __fsqrt_rn(pv);
    const float cd = lane > j ? __fdiv_rn(dg[0], d) : d;  // lane j: the pivot
    if (lane >= j && rd < b) S[rd * ld + c0 + j] = cd;
    __syncwarp();
    if (lane == 0) flag_release(flag, c0 + j + 1);
    // the chain first: lane j + 1's slot 1 after this step is the next
    // pivot (its multiplier is its own cd), the rest of the step after it
    pv = __shfl_sync(FULL, __fsub_rn(dg[1], __fmul_rn(cd, cd)), (j + 1) & 31);
    float lc[PANEL];  // lc[jj] = L[c0 + j + jj][c0 + j], all fetched before any is used
#pragma unroll
    for (int jj = 1; jj < PANEL; ++jj) lc[jj] = __shfl_sync(FULL, cd, (j + jj) & 31);
#pragma unroll
    for (int jj = 1; jj < PANEL; ++jj) dg[jj - 1] = __fsub_rn(dg[jj], __fmul_rn(cd, lc[jj]));
  }
}

// Warp w >= 1 follows: row ro = c0 + 32 w + lane below the block, column
// c0 + j as soon as the leader has published it (its pivot and
// multipliers read back from S), so the rows trail the block by a step or
// so instead of recomputing it.
__device__ __forceinline__ void factor_rows(float* S, int ld, int c0, int pw, int b, int ro,
                                            const unsigned* flag) {
  float own[PANEL];
#pragma unroll
  for (int j = 0; j < PANEL; ++j) own[j] = (ro < b && j < pw) ? S[ro * ld + c0 + j] : 0.f;
  for (int j = 0; j < pw; ++j) {
    while (flag_acquire(flag) <= (unsigned)(c0 + j)) {
    }
    const float* col = S + c0 + j;
    const float d = col[(c0 + j) * ld];
    float lc[PANEL];
#pragma unroll
    for (int jj = 1; jj < PANEL; ++jj) lc[jj] = j + jj < pw ? col[(c0 + j + jj) * ld] : 0.f;
    const float co = __fdiv_rn(own[0], d);
    if (ro < b) S[ro * ld + c0 + j] = co;
#pragma unroll
    for (int jj = 1; jj < PANEL; ++jj) own[jj - 1] = __fsub_rn(own[jj], __fmul_rn(co, lc[jj]));
  }
}

// The lower triangle right of the panel, rows and columns [base, b):
// a[r][c] -= L[r][t] L[c][t] for t = c0 .. base - 1 in turn, 4x4 blocks
// per thread (b - base is a multiple of 8).  The blocks on the diagonal
// update their upper elements too, with the same values as their mirror
// images (never read: the tile's upper triangle is written as zeros).
__device__ __forceinline__ void trailing_panel(float* S, int ld, int c0, int base, int b) {
  const int nb = (b - base) >> 2;
  const int nblk = nb * (nb + 1) / 2;
  for (int q = threadIdx.x; q < nblk; q += DIAG_THREADS) {
    int R = (int)((sqrtf(8.f * q + 1.f) - 1.f) * 0.5f);
    while (R * (R + 1) / 2 > q) --R;
    while ((R + 1) * (R + 2) / 2 <= q) ++R;
    const int C = q - R * (R + 1) / 2;
    const int r0 = base + 4 * R, q0 = base + 4 * C;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = S[(r0 + i) * ld + q0 + j];
    for (int t = c0; t < base; ++t) {
      float lr[4], lc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lr[i] = S[(r0 + i) * ld + t];
        lc[i] = S[(q0 + i) * ld + t];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fsub_rn(acc[i][j], __fmul_rn(lr[i], lc[j]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) S[(r0 + i) * ld + q0 + j] = acc[i][j];
  }
}

__global__ void __launch_bounds__(DIAG_THREADS)
chol_diag_kernel(float* D, const int* sched, int sched_cols, int col_i, int row_begin, int n,
                 int b) {
  extern __shared__ float S[];  // the tile, row-major with stride b + 1, then the flag
  const int ld = b + 1;
  unsigned* flag = reinterpret_cast<unsigned*>(S + b * ld);
  if (threadIdx.x == 0) *flag = 0;
  const int2 t0 = cta_tile(sched, sched_cols, col_i, row_begin);
  float* T = tile_at(D, n, b, t0.x, t0.y);
  // 16-byte loads, all of a thread's in flight at once (b % 8 == 0 and
  // the tile starts at a multiple of 8 floats)
  const int q4 = b / 4;
#pragma unroll 16
  for (int idx = threadIdx.x; idx < b * q4; idx += DIAG_THREADS) {
    const int r = idx / q4, c = 4 * (idx % q4);
    const float4 v = *reinterpret_cast<const float4*>(T + (size_t)r * n + c);
    float* row = S + r * ld + c;
    row[0] = v.x;
    row[1] = v.y;
    row[2] = v.z;
    row[3] = v.w;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < b; c0 += PANEL) {
    const int pw = min(PANEL, b - c0);
    if (warp == 0)
      factor_block(S, ld, c0, pw, b, lane, flag);
    else if (warp < 4 && c0 + 32 * warp < b)
      factor_rows(S, ld, c0, pw, b, c0 + 32 * warp + lane, flag);
    __syncthreads();
    if (c0 + pw < b) {
      trailing_panel(S, ld, c0, c0 + pw, b);
      __syncthreads();
    }
  }
#pragma unroll 16
  for (int idx = threadIdx.x; idx < b * q4; idx += DIAG_THREADS) {
    const int r = idx / q4, c = 4 * (idx % q4);
    const float* row = S + r * ld + c;
    *reinterpret_cast<float4*>(T + (size_t)r * n + c) =
        make_float4(r >= c ? row[0] : 0.f, r >= c + 1 ? row[1] : 0.f, r >= c + 2 ? row[2] : 0.f,
                    r >= c + 3 ? row[3] : 0.f);
  }
}

// phase 1: cholesky.py::_solve_tile: X with X . L_kk^T = A_ik, in place.
// CTA (x, y) solves rows 32 y .. 32 y + 31 of table row x's tile; warp w
// of it rows 32 y + 4 w .. + 3, lane l columns l + 32 j (j < NC, those
// below b; one instantiation takes every b up to 128).  Step t:
// x[r][t] = a[r][t] / L[t][t], then a[r][c] = fmaf(-x[r][t], L[c][t],
// a[r][c]) for c > t: the running value of column c takes one rounded
// FMA a step, in t order.
constexpr int PANEL_ROWS = 4;                         // rows a warp
constexpr int PANEL_WARPS = 8;
constexpr int PANEL_STRIP = PANEL_ROWS * PANEL_WARPS;  // rows a CTA
constexpr int PANEL_THREADS = 32 * PANEL_WARPS;
constexpr int NC = TILE / 32;  // column slots a lane
constexpr int LD = TILE + 1;   // LT's padded stride

__global__ void __launch_bounds__(PANEL_THREADS)
chol_panel_kernel(float* D, const int* sched, int sched_cols, int col_i, int row_begin, int k,
                  int n, int b) {
  extern __shared__ float sh[];
  float* LT = sh;          // LT[t][c] = L_kk[c][t] for t < c < b, else 0: b rows of LD
  float* dg = sh + b * LD;  // L_kk[t][t]
  float* rc = dg + b;       // RN(1 / L_kk[t][t])
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this warp's rows first (b % 8 == 0: they are all in the tile or all
  // past it), so that their loads overlap L_kk's
  const int row0 = blockIdx.y * PANEL_STRIP + warp * PANEL_ROWS;
  const bool rows = row0 < b;
  const int2 t0 = cta_tile(sched, sched_cols, col_i, row_begin);
  float* T = tile_at(D, n, b, t0.x, t0.y) + (size_t)row0 * n;
  float a[PANEL_ROWS][NC];
#pragma unroll
  for (int r = 0; r < PANEL_ROWS; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      a[r][j] = rows && c < b ? T[(size_t)r * n + c] : 0.f;
    }
  const float* L = tile_at(D, n, b, k, k);
  // L_kk transposed into LT: warp w reads rows c = w + 8 u, lane l the
  // columns t = l + 32 v (128 contiguous bytes a warp load, all of a
  // thread's loads in flight before any is stored), and stores LT[t][c]
  // to 32 banks; rows past b read nothing and store zeros, columns past
  // b read and store nothing
  constexpr int CU = TILE / PANEL_WARPS;  // rows a warp
  float v[CU][NC];
#pragma unroll
  for (int u = 0; u < CU; ++u)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = warp + PANEL_WARPS * u, t = lane + 32 * j;
      v[u][j] = c < b && t < b ? L[(size_t)c * n + t] : 0.f;
    }
  if (threadIdx.x < b) {
    const float d = L[(size_t)threadIdx.x * (n + 1)];
    dg[threadIdx.x] = d;
    rc[threadIdx.x] = __frcp_rn(d);
  }
#pragma unroll
  for (int u = 0; u < CU; ++u)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = warp + PANEL_WARPS * u, t = lane + 32 * j;
      if (t < b) LT[t * LD + c] = c > t ? v[u][j] : 0.f;
    }
  __syncthreads();
  if (!rows) return;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    if (32 * j >= b) break;
    const int steps = min(32, b - 32 * j);
    int t = 32 * j;
    float d = dg[t], r1 = rc[t], lc[NC];
#pragma unroll
    for (int jj = j; jj < NC; ++jj) lc[jj] = LT[t * LD + lane + 32 * jj];
#pragma unroll 2
    for (int tt = 0; tt < steps; ++tt, ++t) {
      // the next step's operands, read while this step runs
      const int tn = min(t + 1, b - 1);
      const float dn = dg[tn], rn = rc[tn];
      float ln[NC];
#pragma unroll
      for (int jj = j; jj < NC; ++jj) ln[jj] = LT[tn * LD + lane + 32 * jj];
#pragma unroll
      for (int r = 0; r < PANEL_ROWS; ++r) {
        // x = RN(y / d): the quotient from the correctly rounded
        // reciprocal with one FMA correction (Markstein), no slow path
        const float y = __shfl_sync(0xffffffffu, a[r][j], tt);
        const float q = __fmul_rn(y, r1);
        const float x = fmaf(fmaf(-q, d, y), r1, q);
        a[r][j] = lane == tt ? x : fmaf(-x, lc[j], a[r][j]);  // lanes below tt: lc = 0
#pragma unroll
        for (int jj = j + 1; jj < NC; ++jj) a[r][jj] = fmaf(-x, lc[jj], a[r][jj]);
      }
      d = dn;
      r1 = rn;
#pragma unroll
      for (int jj = j; jj < NC; ++jj) lc[jj] = ln[jj];
    }
  }
#pragma unroll
  for (int r = 0; r < PANEL_ROWS; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      if (c < b) T[(size_t)r * n + c] = a[r][j];
    }
}

// phase 2: A_ij <- A_ij - L_ik . L_jk^T for k < j <= i, each element the
// chain of the per-k form's sfc_tile_update on the same values
// (simt_gemm.cuh, Update): acc = __fmaf_rn(L_ik[r][t], L_jk[c][t], acc)
// for t = 0, 1, ... up to b rounded up to 16 (zeros past b add nothing),
// from 0, then a = __fadd_rn(a, __fmul_rn(-1, acc)).
//
// A persistent CTA of 256 threads on each SM walks the launch's tiles
// (table rows x, x + grid, ...), with the thread tile of tile_gemm.cuh
// (8 x 8: rows 4 ty + i and 64 + 4 ty + i, columns 4 tx + j and
// 64 + 4 tx + j).  A tile's depth b <= 128 is four stages of 32 k; each
// stage of L_ik and L_jk sits in one slot of a four-slot ring (a
// diagonal tile loads its single operand once), one 128-byte row segment
// a row, its 16-byte chunk c stored in slot position c ^ ((row >> 2) & 7)
// so the 8 lanes of a 16-byte read phase (rows 4 tx + j, tx = 0 .. 7) hit
// 8 distinct bank groups.  Every copy is a 16-byte cp.async: a slot is
// refilled with the same stage of the CTA's next tile as soon as it is
// consumed, and the O tile (row-major, 64 KB) of the next tile as soon
// as this tile's epilogue has read it, so loads run a tile ahead of the
// product.  A thread reads 4 k at a time as one float4 per row and
// column (16 loads for 256 FMAs, tile_gemm's ratio); the epilogue reads O
// from shared memory and stores 16 bytes at a time.
constexpr int TR_STAGE = 32;                        // k columns of a stage
constexpr int TR_STAGES = TILE / TR_STAGE;          // 4: depth b <= 128, one ring slot each
constexpr int TR_SLOT = 2 * TILE * TR_STAGE;        // floats of a slot: L_ik's and L_jk's stage
constexpr int TR_SMEM = (TR_STAGES * TR_SLOT + TILE * TILE) * (int)sizeof(float);  // 192 KB

// float offset of (row, 16-byte chunk c) in a stage
__device__ __forceinline__ int tr_at(int row, int c) {
  return row * TR_STAGE + ((c ^ ((row >> 2) & 7)) << 2);
}

__device__ __forceinline__ float lane4(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

struct Trailing {
  float* D;
  const int* sched;
  int sched_cols, col_i, row_begin, ctas, k, n, b, kp;

  __device__ int2 tile(int x) const {
    const int* s = sched + (size_t)(row_begin + x) * sched_cols + col_i;
    return make_int2(s[0], s[1]);
  }
  // 16-byte chunks of stage s (zeros from b to kp)
  __device__ int chunks(int s) const { return max(0, min(TR_STAGE, kp - s * TR_STAGE)) / 4; }
  // stage s of tile x into ring slot s, one copy group (empty past the
  // launch's tiles or the depth)
  __device__ void issue_stage(float* ring, int x, int s) const {
    const int nc = chunks(s);
    if (x < ctas && nc > 0) {
      const int2 t = tile(x);
      const float* A = tile_at(D, n, b, t.x, k) + s * TR_STAGE;
      const float* B = tile_at(D, n, b, t.y, k) + s * TR_STAGE;
      float* As = ring + s * TR_SLOT;
      float* Bs = As + TILE * TR_STAGE;
      for (int i = threadIdx.x; i < b * nc; i += THREADS) {
        const int row = i / nc, c = i - row * nc;
        const bool fill = s * TR_STAGE + 4 * c >= b;
        const size_t at = (size_t)row * n + (fill ? 0 : 4 * c);
        cp_async16(As + tr_at(row, c), A + at, fill);
        if (t.x != t.y) cp_async16(Bs + tr_at(row, c), B + at, fill);
      }
    }
    cp_async_commit();
  }
  // the O tile of tile x, one copy group
  __device__ void issue_o(float* Os, int x) const {
    if (x < ctas) {
      const int2 t = tile(x);
      const float* O = tile_at(D, n, b, t.x, t.y);
      const int row4 = b / 4;
      for (int i = threadIdx.x; i < b * row4; i += THREADS) {
        const int row = i / row4, c = i - row * row4;
        cp_async16(Os + row * TILE + 4 * c, O + (size_t)row * n + 4 * c);
      }
    }
    cp_async_commit();
  }
};

__global__ void __launch_bounds__(THREADS, 1)
chol_trailing_kernel(float* D, const int* sched, int sched_cols, int col_i, int row_begin, int ctas,
                     int k, int n, int b) {
  extern __shared__ __align__(16) float tr[];
  float* ring = tr;
  float* Os = tr + TR_STAGES * TR_SLOT;
  const Trailing w{D, sched, sched_cols, col_i, row_begin, ctas, k, n, b, (b + BK - 1) / BK * BK};
  const int step = gridDim.x;
  // in flight from the start: the four stages and O of the first tile
  for (int s = 0; s < TR_STAGES; ++s) w.issue_stage(ring, blockIdx.x, s);
  w.issue_o(Os, blockIdx.x);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int x = blockIdx.x; x < ctas; x += step) {
    const int2 t = w.tile(x);
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int s = 0; s < TR_STAGES; ++s) {
      // one group is committed after each of the 5 a tile uses, so 4
      // younger groups may be in flight once stage s has landed
      cp_async_wait<TR_STAGES>();
      __syncthreads();
      const float* As = ring + s * TR_SLOT;
      const float* Bs = t.x == t.y ? As : As + TILE * TR_STAGE;
      const int nc = w.chunks(s);
      for (int c = 0; c < nc; ++c) {
        float4 a4[8], b4[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a4[i] = *reinterpret_cast<const float4*>(As + tr_at(tile_row(ty, i), c));
#pragma unroll
        for (int j = 0; j < 8; ++j) b4[j] = *reinterpret_cast<const float4*>(Bs + tr_at(tile_col(tx, j), c));
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(lane4(a4[i], q), lane4(b4[j], q), acc[i][j]);
      }
      __syncthreads();  // slot s is consumed: refill it with the next tile's stage s
      w.issue_stage(ring, x + step, s);
    }
    cp_async_wait<TR_STAGES>();  // this tile's O has landed
    __syncthreads();
    float* O = tile_at(D, n, b, t.x, t.y);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = tile_row(ty, i);
      if (r >= b) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = 64 * hh + 4 * tx;
        if (c >= b) continue;
        float4 o = *reinterpret_cast<const float4*>(Os + r * TILE + c);
        o.x = __fadd_rn(o.x, __fmul_rn(-1.f, acc[i][4 * hh]));
        o.y = __fadd_rn(o.y, __fmul_rn(-1.f, acc[i][4 * hh + 1]));
        o.z = __fadd_rn(o.z, __fmul_rn(-1.f, acc[i][4 * hh + 2]));
        o.w = __fadd_rn(o.w, __fmul_rn(-1.f, acc[i][4 * hh + 3]));
        *reinterpret_cast<float4*>(O + (size_t)r * n + c) = o;
      }
    }
    __syncthreads();  // O is read: load the next tile's
    w.issue_o(Os, x + step);
  }
  cp_async_wait<0>();
}

// the panel kernel's dynamic shared memory: L_kk^T with a padded stride,
// its diagonal and their reciprocals, b (LD + 2) floats (65 KB at
// b = 128); the diag
// kernel's: the tile with a padded stride, TILE (TILE + 1) floats (64.5 KB)
constexpr int panel_smem(int b) { return b * (LD + 2) * (int)sizeof(float); }
constexpr int DIAG_SMEM_MAX = (TILE * (TILE + 1) + 1) * (int)sizeof(float);
constexpr int MAX_DEVICES = 64;

// Raise `kernel`'s dynamic shared-memory limit to `bytes` once per device
// (above the 48 KB static limit), not on every launch.
template <int Slot>
cudaError_t opt_in_smem(const void* kernel, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t attr[MAX_DEVICES];
  std::call_once(once[dev], [dev, kernel, bytes] {
    attr[dev] = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  });
  return attr[dev];
}

}  // namespace

// Every entry point: matrix d (n x n f32, in place), table sched (int32,
// sched_cols columns, (i, j) at col_i), CTAs = table rows row_begin ..
// row_begin + ctas - 1, k the k-block.
extern "C" int sfc_chol_diag(void* d, const void* sched, int sched_cols, int col_i, int row_begin,
                             int ctas, int k, int n, int b, void* stream) {
  (void)k;
  if (bad_block(b) || (uintptr_t)d % 16) return (int)cudaErrorInvalidValue;  // 16-byte rows
  const cudaError_t attr = opt_in_smem<0>((const void*)chol_diag_kernel, DIAG_SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = (size_t)(b * (b + 1) + 1) * sizeof(float);
  chol_diag_kernel<<<ctas, DIAG_THREADS, smem, (cudaStream_t)stream>>>(
      (float*)d, (const int*)sched, sched_cols, col_i, row_begin, n, b);
  return (int)cudaGetLastError();
}

extern "C" int sfc_chol_panel(void* d, const void* sched, int sched_cols, int col_i, int row_begin,
                              int ctas, int k, int n, int b, void* stream) {
  if (bad_block(b) || (uintptr_t)d % 16) return (int)cudaErrorInvalidValue;  // 16-byte rows
  if (ctas == 0) return 0;
  const cudaError_t attr = opt_in_smem<1>((const void*)chol_panel_kernel, panel_smem(TILE));
  if (attr != cudaSuccess) return (int)attr;
  // (ctas, b / 32 strips) CTAs
  const dim3 grid(ctas, (b + PANEL_STRIP - 1) / PANEL_STRIP);
  chol_panel_kernel<<<grid, PANEL_THREADS, panel_smem(b), (cudaStream_t)stream>>>(
      (float*)d, (const int*)sched, sched_cols, col_i, row_begin, k, n, b);
  return (int)cudaGetLastError();
}

extern "C" int sfc_chol_trailing(void* d, const void* sched, int sched_cols, int col_i,
                                 int row_begin, int ctas, int k, int n, int b, void* stream) {
  if (bad_block(b) || (uintptr_t)d % 16) return (int)cudaErrorInvalidValue;  // 16-byte rows
  if (ctas == 0) return 0;
  const cudaError_t attr = opt_in_smem<2>((const void*)chol_trailing_kernel, TR_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // one persistent CTA an SM (192 KB of shared memory each), none idle
  chol_trailing_kernel<<<min(ctas, sms), THREADS, TR_SMEM, (cudaStream_t)stream>>>(
      (float*)d, (const int*)sched, sched_cols, col_i, row_begin, ctas, k, n, b);
  return (int)cudaGetLastError();
}
