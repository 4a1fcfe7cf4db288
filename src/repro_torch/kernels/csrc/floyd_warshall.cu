// Blocked Floyd-Warshall: one launch per barrier group of the phased table.
//
// Replaces: src/repro/kernels/floyd_warshall.py::_fused_fw_kernel (the
// fused TPU kernel, all k-blocks in one pallas_call) and its per-k
// oracle's _diag_kernel, _row_panel_kernel, _col_panel_kernel and
// _trailing_kernel.  The TPU kernel walks the phased (phase, k, i, j)
// table in grid order and carries the closed diagonal and the finished
// row / column panels of the current k in VMEM scratch.  A GPU grid runs
// its CTAs concurrently and the phases of one k depend on each other, so
// here every (k, phase) barrier group is its own launch over table rows:
// CTA x reads (i, j) at row `row_begin + x` (columns col_i and col_i + 1).
// The fused and the per-k forms launch these same four kernels, with the
// phased table or with their own per-k tables, so they agree to the last
// bit.
//
// No n-sized workspace: trailing tiles (i, j != k) never write row k or
// column k, so they read D_ik and D_kj straight from the matrix.  The
// diagonal is the exception: the row phase's j = k CTAs and the column
// phase's i = k CTAs write D_kk while every other CTA of the launch reads
// the closed diagonal.  The diag kernel therefore writes the closed tile
// to D_kk AND to a (b, b) workspace, and the panels read the workspace,
// as the TPU kernel reads its diag_ref copy.
//
// Every candidate is one rounded add (__fadd_rn) and fminf does not
// round, so an output depends only on the candidates it sees, never on
// their order.  Bound on the H100: (min, +) operations on the FP32 pipes,
// which have no tensor-core path: one add and one min per candidate.
//
// - Diagonal (sfc_fw_diag): JAX's sequence of b steps, step t taking
//   min(d, d[:, t] + d[t, :]) with row t and column t as they were before
//   it.  The chain is serial, so one CTA of 256 threads holds the tile in
//   registers, 8 x 8 a thread, and the bound is one SM's issue rate: 2 b^2
//   lane instructions a step.  One barrier a step: the pivot row and
//   column are double-buffered in shared memory, and the threads that own
//   row and column t + 1 compute them first in step t and store them into
//   the other buffer before the rest of their tile.  Steps are unrolled by
//   the thread tile's row pattern (t = 64 h + 4 q + s lives in register
//   row and column 4 h + s of the threads with ty == q, tx == q), so the
//   owner test is one compare and every register index is a constant.
// - Row and column panels (sfc_fw_row, sfc_fw_col): one kernel,
//   fw_panel_kernel<Side>, whose CTAs are (table row, strip): a strip is
//   STRIP columns of a row-panel tile, or STRIP rows of a column-panel
//   tile (the last one ragged).  Output (r, c) of min(P, W (x) P) needs
//   only column c of P (of min(P, P (x) W) only row r), so a CTA reads
//   only the part of P it writes and the in-place update is free of
//   hazards; the depth is never split.  W and the strip of P go into
//   shared memory by 16-byte cp.async in depth chunks of 32, one commit
//   group each, so the products start on chunk 0 while the rest land.
//   256 threads of 8 x 4 outputs; rows padded to b + 4 (or STRIP + 4)
//   floats, so a warp's float4 fragment reads hit distinct banks.  Every
//   CTA copies all of W (64 KB at b = 128) from L2, so the strip is 64
//   wide: 128 CTAs a launch at b = 128, one an SM.  Strips of 32 (256
//   CTAs, two an SM) moved twice W's bytes and ran 9-11 % slower.
// - Trailing (sfc_fw_trailing): one CTA a tile on the SIMT 128x128 tile
//   product of tile_gemm.cuh in the MinPlus semiring (loaders fill +inf
//   past the tile edge: b need not be a multiple of 16).
//
// Limits: 8 <= b <= 128, b % 8 == 0 (one tile per CTA; the wrapper
// raises for anything else), the matrix and the workspace 16-byte aligned.
#include <cstdint>

#include "cp_async.cuh"
#include "kernel_info.cuh"
#include "phased.cuh"

namespace {

using namespace sfc;

// ---------------------------------------------------------------------------
// phase 0: the closure of D_kk
// ---------------------------------------------------------------------------

// Thread (tx, ty) = (tid % 16, tid / 16) of 256 holds the 8 x 8 outputs at
// rows tile_row(ty, i), columns tile_col(tx, j) (tile_gemm.cuh's layout).
constexpr int DIAG_SMEM = 4 * TILE * (int)sizeof(float);  // two pivot rows, two columns

__device__ __forceinline__ float4 f4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

using Tile = float[8][8];

// register row I of the tile into a pivot-row buffer
template <int I>
__device__ __forceinline__ void store_row(const Tile& d, float* buf, int tx) {
  st4(buf + tx * 4, d[I][0], d[I][1], d[I][2], d[I][3]);
  st4(buf + 64 + tx * 4, d[I][4], d[I][5], d[I][6], d[I][7]);
}

// register column J into a pivot-column buffer
template <int J>
__device__ __forceinline__ void store_col(const Tile& d, float* buf, int ty) {
  st4(buf + ty * 4, d[0][J], d[1][J], d[2][J], d[3][J]);
  st4(buf + 64 + ty * 4, d[4][J], d[5][J], d[6][J], d[7][J]);
}

// One step: d <- min(d, col + row) from this step's pivot buffers (row t
// and column t as they were before the step).  Register rows and columns
// N1 and N2 (-1: none) hold the next step's pivot, so they go first, and a
// thread that owns the next pivot row (r1, r2) or column (c1, c2) writes it
// into the other buffers before it updates the rest of its tile.
template <int N1, int N2>
__device__ __forceinline__ void closure_step(Tile& d, const float* rowt, const float* colt,
                                             float* rown, float* coln, int tx, int ty, bool r1,
                                             bool c1, bool r2, bool c2) {
  const float4 c0 = f4(colt + ty * 4), c4 = f4(colt + 64 + ty * 4);
  const float4 r0 = f4(rowt + tx * 4), r4 = f4(rowt + 64 + tx * 4);
  const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c4.x, c4.y, c4.z, c4.w};
  const float rv[8] = {r0.x, r0.y, r0.z, r0.w, r4.x, r4.y, r4.z, r4.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (i == N1 || j == N1 || i == N2 || j == N2) d[i][j] = fminf(d[i][j], __fadd_rn(cv[i], rv[j]));
  if constexpr (N1 >= 0) {
    if (r1) store_row<N1>(d, rown, tx);
    if (c1) store_col<N1>(d, coln, ty);
  }
  if constexpr (N2 >= 0) {
    if (r2) store_row<N2>(d, rown, tx);
    if (c2) store_col<N2>(d, coln, ty);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (!(i == N1 || j == N1 || i == N2 || j == N2)) d[i][j] = fminf(d[i][j], __fadd_rn(cv[i], rv[j]));
  __syncthreads();  // the next pivot is in place; this step's buffers are free
}

// Steps 64 H .. min(b, 64 H + 64) - 1.  Step 64 H + 4 q + s reads buffers
// s & 1, and its pivot is register row / column 4 H + s of the threads
// with ty == q / tx == q.
template <int H>
__device__ __forceinline__ void closure_half(Tile& d, float (*rowb)[TILE], float (*colb)[TILE],
                                             int tx, int ty, int b) {
  constexpr int R = 4 * H;
  const int qn = min(16, (b - 64 * H) / 4);
  for (int q = 0; q < qn; ++q) {
    const bool rq = ty == q, cq = tx == q;
    closure_step<R + 1, -1>(d, rowb[0], colb[0], rowb[1], colb[1], tx, ty, rq, cq, false, false);
    closure_step<R + 2, -1>(d, rowb[1], colb[1], rowb[0], colb[0], tx, ty, rq, cq, false, false);
    closure_step<R + 3, -1>(d, rowb[0], colb[0], rowb[1], colb[1], tx, ty, rq, cq, false, false);
    // the next pivot: register 4 H of the threads q + 1 of this half, or
    // after the last q of the first half, register 4 of the threads 0
    const bool same = q + 1 < qn;
    const bool next_r = same && ty == q + 1, next_c = same && tx == q + 1;
    if constexpr (H == 0) {
      const bool cross = !same && b > 64;
      closure_step<0, 4>(d, rowb[1], colb[1], rowb[0], colb[0], tx, ty, next_r, next_c,
                         cross && ty == 0, cross && tx == 0);
    } else {
      closure_step<4, -1>(d, rowb[1], colb[1], rowb[0], colb[0], tx, ty, next_r, next_c, false, false);
    }
  }
}

// the thread's outputs of a b x b tile with row stride ld, +inf outside b
// (b % 4 == 0: a float4 is all inside or all outside)
__device__ __forceinline__ void load_tile(Tile& d, const float* T, size_t ld, int b, int tx,
                                          int ty) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tile_row(ty, i), c = h * 64 + tx * 4;
      const float4 v = (r < b && c < b) ? f4(T + (size_t)r * ld + c)
                                        : make_float4(MinPlus::zero(), MinPlus::zero(),
                                                      MinPlus::zero(), MinPlus::zero());
      d[i][4 * h] = v.x, d[i][4 * h + 1] = v.y, d[i][4 * h + 2] = v.z, d[i][4 * h + 3] = v.w;
    }
}

__device__ __forceinline__ void store_tile(const Tile& d, float* T, size_t ld, int b, int tx,
                                           int ty) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tile_row(ty, i), c = h * 64 + tx * 4;
      if (r < b && c < b)
        st4(T + (size_t)r * ld + c, d[i][4 * h], d[i][4 * h + 1], d[i][4 * h + 2], d[i][4 * h + 3]);
    }
}

__global__ void __launch_bounds__(THREADS)
fw_diag_kernel(float* D, float* ws, const int* sched, int sched_cols, int col_i, int row_begin,
               int n, int b) {
  extern __shared__ __align__(16) float diag_smem[];
  float (*rowb)[TILE] = reinterpret_cast<float (*)[TILE]>(diag_smem);
  float (*colb)[TILE] = reinterpret_cast<float (*)[TILE]>(diag_smem + 2 * TILE);
  const int2 t0 = cta_tile(sched, sched_cols, col_i, row_begin);
  float* T = tile_at(D, n, b, t0.x, t0.y);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  Tile d;
  load_tile(d, T, n, b, tx, ty);
  // step 0's pivot: register row / column 0 of the threads ty == 0 / tx == 0
  if (ty == 0) store_row<0>(d, rowb[0], tx);
  if (tx == 0) store_col<0>(d, colb[0], ty);
  __syncthreads();
  closure_half<0>(d, rowb, colb, tx, ty, b);
  if (b > 64) closure_half<1>(d, rowb, colb, tx, ty, b);
  store_tile(d, T, n, b, tx, ty);
  store_tile(d, ws, b, b, tx, ty);
}

// ---------------------------------------------------------------------------
// phases 1 and 2: the row and column panels
// ---------------------------------------------------------------------------

enum class Side { ROW, COL };

constexpr int STRIP = 64;        // a CTA's columns (row panel) or rows (column panel)
constexpr int TM = 8;            // output rows a thread
constexpr int TN = 4;            // output columns a thread
constexpr int PANEL_THREADS = TILE * STRIP / (TM * TN);
constexpr int PAD = 4;           // row strides b + 4 / STRIP + 4: 4 mod 8 floats
constexpr int CHUNK = 32;        // depth of one cp.async group
constexpr int CHUNKS = TILE / CHUNK;
static_assert(CHUNKS == 4, "fw_panel_kernel waits for its chunks' groups one by one");

// out(r, c) = min(P(r, c), min_m A(r, m) + B(m, c)) over the CTA's M x N
// outputs.  ROW: A = W (b x b), B = the strip of P (b x w), M = b, N = w.
// COL: A = the strip of P (w x b), B = W (b x b), M = w, N = b.
template <Side S>
struct PanelShape {
  static constexpr int NCG = S == Side::ROW ? STRIP / TN : TILE / TN;  // column groups
  static constexpr int NRG = PANEL_THREADS / NCG;                      // row groups
  static_assert(NRG * TM == (S == Side::ROW ? TILE : STRIP), "a CTA's threads cover its outputs");
  // floats of A and B in shared memory at block b
  static __host__ __device__ constexpr int a_rows(int b) { return S == Side::ROW ? b : STRIP; }
  static __host__ __device__ constexpr int sb(int b) { return S == Side::ROW ? STRIP + PAD : b + PAD; }
  static __host__ __device__ constexpr int smem_bytes(int b) {
    return (int)sizeof(float) * (a_rows(b) * (b + PAD) + b * sb(b));
  }
};

// issue the cp.async copies of rows [r0, r1) and columns [c0, c1) of an
// operand whose (r, c) is src[r * lds + c] into dst[r * ldd + c], in
// 16-byte units (c0, c1 multiples of 4), U units a row at most: thread x
// copies unit x % U of rows r0 + x / U, r0 + x / U + PANEL_THREADS / U, ...
template <int U>
__device__ __forceinline__ void copy_block(float* dst, int ldd, const float* src, size_t lds, int r0,
                                           int r1, int c0, int c1) {
  const int c = c0 + 4 * (threadIdx.x % U);
  if (c >= c1) return;
  for (int r = r0 + threadIdx.x / U; r < r1; r += PANEL_THREADS / U)
    cp_async16(dst + r * ldd + c, src + (size_t)r * lds + c);
}

template <Side S>
__global__ void __launch_bounds__(PANEL_THREADS, 2)
fw_panel_kernel(float* D, const float* ws, const int* sched, int sched_cols, int col_i,
                int row_begin, int n, int b) {
  using Shape = PanelShape<S>;
  extern __shared__ __align__(16) float panel_smem[];
  const int2 t = cta_tile(sched, sched_cols, col_i, row_begin);
  const int s0 = blockIdx.y * STRIP;
  const int w = min(STRIP, b - s0);
  const int M = S == Side::ROW ? b : w, N = S == Side::ROW ? w : b;
  const int sa = b + PAD, sb = Shape::sb(b);
  float* As = panel_smem;
  float* Bs = panel_smem + Shape::a_rows(b) * sa;
  // the strip's first element: ROW its column s0 of P, COL its row s0
  float* P = tile_at(D, n, b, t.x, t.y) + (S == Side::ROW ? s0 : (size_t)s0 * n);
  const float* A = S == Side::ROW ? ws : P;
  const float* B = S == Side::ROW ? P : ws;
  const size_t lda = S == Side::ROW ? b : n, ldb = S == Side::ROW ? n : b;

  // every chunk's copies in flight at once, one commit group a chunk
  // (empty groups past b complete at once)
#pragma unroll
  for (int ch = 0; ch < CHUNKS; ++ch) {
    const int m0 = min(b, ch * CHUNK), m1 = min(b, m0 + CHUNK);
    copy_block<CHUNK / 4>(As, sa, A, lda, 0, M, m0, m1);
    copy_block<Shape::NCG>(Bs, sb, B, ldb, m0, m1, 0, N);
    cp_async_commit();
  }

  const int cg = threadIdx.x % Shape::NCG, rg = threadIdx.x / Shape::NCG;
  // rows rg + NRG i and columns 4 cg .. 4 cg + 3; reads past M or N are
  // clamped inside the operands and their outputs are not written
  const int col = min(TN * cg, N - TN);
  const float* arow[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) arow[i] = As + min(rg + Shape::NRG * i, M - 1) * sa;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = MinPlus::zero();

#pragma unroll
  for (int ch = 0; ch < CHUNKS; ++ch) {
    if (ch == 0) cp_async_wait<CHUNKS - 1>();
    else if (ch == 1) cp_async_wait<CHUNKS - 2>();
    else if (ch == 2) cp_async_wait<CHUNKS - 3>();
    else cp_async_wait<0>();
    __syncthreads();  // chunk ch of every thread's copies has landed
    const int m1 = min(b, (ch + 1) * CHUNK);
    for (int m = ch * CHUNK; m < m1; m += 4) {
      float4 a[TM], bv[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = f4(arow[i] + m);
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) bv[mm] = f4(Bs + (m + mm) * sb + col);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          const float bb[4] = {bv[mm].x, bv[mm].y, bv[mm].z, bv[mm].w};
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fminf(acc[i][j], __fadd_rn(av[mm], bb[j]));
        }
      }
    }
  }

  // min with P, read from the operand that holds the strip, written once
  if (TN * cg >= N) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = rg + Shape::NRG * i;
    if (r >= M) continue;
    const float4 p = f4(S == Side::ROW ? Bs + r * sb + col : As + r * sa + col);
    st4(P + (size_t)r * n + col, fminf(p.x, acc[i][0]), fminf(p.y, acc[i][1]),
        fminf(p.z, acc[i][2]), fminf(p.w, acc[i][3]));
  }
}

// ---------------------------------------------------------------------------
// phase 3: the trailing tiles
// ---------------------------------------------------------------------------

// O <- min(O, A (x) B) over one b x b tile, (x) the (min, +) product.
template <typename LA, typename LB>
__device__ __forceinline__ void minplus_update(float* O, int ldo, const LA& la, const LB& lb, int b,
                                               float* As, float* Bs) {
  float acc[8][8];
  // every global read of A and B ends before tile_product's last barrier,
  // so the writes below are safe
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

// D_ij <- min(D_ij, D_ik (x) D_kj), i != k and j != k
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

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

template <Side S>
int launch_panel(void* d, void* ws, const void* sched, int sched_cols, int col_i, int row_begin,
                 int ctas, int strips, int n, int b, void* stream) {
  if (bad_block(b) || strips != (b + STRIP - 1) / STRIP) return (int)cudaErrorInvalidValue;
  if (misaligned(d) || misaligned(ws)) return (int)cudaErrorMisalignedAddress;
  const cudaError_t err = raise_smem_limit<fw_panel_kernel<S>>(PanelShape<S>::smem_bytes(TILE));
  if (err != cudaSuccess) return (int)err;
  fw_panel_kernel<S><<<dim3(ctas, strips), PANEL_THREADS, PanelShape<S>::smem_bytes(b),
                       (cudaStream_t)stream>>>((float*)d, (const float*)ws, (const int*)sched,
                                               sched_cols, col_i, row_begin, n, b);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point: matrix d (n x n f32, in place), workspace ws (b x b
// f32), table sched (int32, sched_cols columns, (i, j) at col_i), table
// rows row_begin .. row_begin + ctas - 1, k the k-block.  The panels also
// take their strips a tile, ceil(b / STRIP) (the wrapper's panel_strips):
// their grid is ctas x strips.
extern "C" int sfc_fw_diag(void* d, void* ws, const void* sched, int sched_cols, int col_i,
                           int row_begin, int ctas, int k, int n, int b, void* stream) {
  (void)k;
  if (bad_block(b)) return (int)cudaErrorInvalidValue;
  if (misaligned(d) || misaligned(ws)) return (int)cudaErrorMisalignedAddress;
  fw_diag_kernel<<<ctas, THREADS, DIAG_SMEM, (cudaStream_t)stream>>>(
      (float*)d, (float*)ws, (const int*)sched, sched_cols, col_i, row_begin, n, b);
  return (int)cudaGetLastError();
}

extern "C" int sfc_fw_row(void* d, void* ws, const void* sched, int sched_cols, int col_i,
                          int row_begin, int ctas, int strips, int k, int n, int b, void* stream) {
  (void)k;
  return launch_panel<Side::ROW>(d, ws, sched, sched_cols, col_i, row_begin, ctas, strips, n, b,
                                 stream);
}

extern "C" int sfc_fw_col(void* d, void* ws, const void* sched, int sched_cols, int col_i,
                          int row_begin, int ctas, int strips, int k, int n, int b, void* stream) {
  (void)k;
  return launch_panel<Side::COL>(d, ws, sched, sched_cols, col_i, row_begin, ctas, strips, n, b,
                                 stream);
}

extern "C" int sfc_fw_trailing(void* d, void* ws, const void* sched, int sched_cols, int col_i,
                               int row_begin, int ctas, int k, int n, int b, void* stream) {
  (void)ws;
  if (bad_block(b)) return (int)cudaErrorInvalidValue;
  fw_trailing_kernel<<<ctas, THREADS, 0, (cudaStream_t)stream>>>(
      (float*)d, (const int*)sched, sched_cols, col_i, row_begin, k, n, b);
  return (int)cudaGetLastError();
}

// The build and residency of the kernels this file redesigned
// (kernel_info.cuh; launches nothing): which = 0 the diagonal closure,
// 1 the row panel, 2 the column panel, each at b = 128; with the columns
// of the tile (diagonal) or of a strip a CTA, and the outputs a thread in
// rows and columns.
extern "C" int sfc_fw_info(int which, int* out) {
  switch (which) {
    case 0:
      return sfc::kernel_info((const void*)fw_diag_kernel, THREADS, DIAG_SMEM,
                              {TILE, 8, 8}, out);
    case 1:
      return sfc::kernel_info((const void*)fw_panel_kernel<Side::ROW>, PANEL_THREADS,
                              PanelShape<Side::ROW>::smem_bytes(TILE), {STRIP, TM, TN}, out);
    case 2:
      return sfc::kernel_info((const void*)fw_panel_kernel<Side::COL>, PANEL_THREADS,
                              PanelShape<Side::COL>::smem_bytes(TILE), {STRIP, TM, TN}, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
