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
//     order).  A point tile is a bp x Kp tile of m = |c|^2 - 2 x.c
//     (kmeans.py::_assign_tile), walked as 128 x 128 sub-tiles, row-major,
//     on simt_gemm.cuh's ring: x as its M x D panel (4-byte copies that
//     transpose it), the centroids as a D x Kp panel the wrapper transposes
//     (kmeans.py::centroid_panel; 16-byte copies).  Centroids at or past
//     k_valid count as FLT_MAX, and each row keeps its running (min, first
//     argmin) under the (value, index) order, so the smallest index wins
//     among equal minima exactly as argmin does.  `arg` is written once
//     per point.
//     Bound on the H100: FP32 FLOP/s (2 N Kp D; TF32 is off).  The first
//     design ran tile_gemm.cuh's tile_product (16-deep chunks staged
//     through registers by 4-byte loads, two barriers a chunk) afresh for
//     each 128-centroid tile: at D = 128 a product is 8 chunks, and its
//     pipeline filled and drained 8 times a point tile with the argmin
//     merge between (11.3 ms at 1M x 1024 x 128, 0.35 of the bound, on an
//     H100 80GB HBM3 at 700 W; PERF.md, row 5a).  On the ring the stage
//     sequence runs on across a tile's sub-tiles, and only the epilogue
//     sits between two of them.  Every metric is still one __fmaf_rn chain
//     from 0, k ascending (a zero-filled depth adds nothing), so every
//     minimum and argmin is the first design's to the bit.  In the A/B
//     that chose the design (PERF.md, section 6), the centroids as an N x K
//     panel (BPanel::NK, 4-byte copies that transpose them) ran 5-11 %
//     slower, and persistent CTAs walking rows b, b + grid, ... 1-7 %
//     slower than one CTA a tile.
//     The epilogue (Argmin), after each sub-tile: a thread reduces its 8
//     columns for each of its 8 rows in ascending column order (strict <),
//     the 8 lanes that share rows merge by __shfl_xor_sync, and one of
//     them merges the result into the running pair of its (row, column
//     half), kept in 2 KB of shared memory outside the ring: held in
//     registers, 16 more values would stay live across the loop beside
//     the 64 accumulators, past the 128 registers two CTAs an SM allow.
//     After a row block's last sub-tile, the two warps that share its rows
//     meet at a named barrier of their 64 threads, and one of them merges
//     the halves and writes each row once.  The (value, index) minimum is
//     associative and commutative, so the merge order changes no bit.
//
// (b) update: grid (point group g, 128-centroid range, column chunk).
//     A group is a run of tiles_per_group consecutive point-tile ids; the
//     wrapper's group table lists each group's tiles in the schedule's
//     order, groups in the order the schedule first reaches them.
//     CTA (g, c, z) walks the points of group g's tiles in table order
//     and adds columns [z dchunk, (z + 1) dchunk) of every valid point
//     (row < n_valid, kmeans.py::_update_tile's row mask) assigned to its
//     centroid range into a (128, dchunk) shared-memory partial; warp w
//     owns the centroids with (k % 8) == w, so no two threads ever add
//     into one address and no atomics are needed.  Each partial is
//     written once to psum[g] / pcnt[g] (the counts by the z = 0 CTA
//     only); the host folds them with one torch sum over g.  Every sum
//     is taken in a fixed order, so the result is deterministic from run
//     to run, and each output element is summed by one CTA over the same
//     points in the same order whatever the chunking: element (k, d) of
//     a group partial is 0.f plus x[row][d] for each of k's rows, in
//     table then point order, one f32 add each.
//     Bound on the H100: bytes (x read once: N D 4 bytes).  What held it
//     back was latency, not bytes: a warp owns 1/64 of a group's points
//     (1/8 of the centroid ranges, 1/8 of a range), and walked them one
//     at a time, each row's loads issued after the last row's adds and
//     each ballot after a load of the assignments, so an SM had one or
//     two rows a warp in flight (0.17 of the bound at D = 960, 1 CTA an
//     SM).  Design: each warp scans its stream 7 blocks of 32 points at
//     a time (every table and assignment load of a scan issued before the
//     first ballot) into a queue of its own rows in shared memory, and
//     keeps RING = 8 rows in flight in registers, adding each in queue
//     order as it lands and issuing the row 8 places behind it; scans run
//     ahead of the adds, so a warp's row loads never wait for a ballot.
//     A lane holds V = 4 or 16 columns of a row (dchunk <= 32 V).  The
//     whole (Kp, D) accumulator (512 KB at Kp=1024, D=128) cannot sit in
//     one CTA's shared memory, hence the split by centroid range; a 128 x
//     D partial beside the 8 KB of queues fits the 227 KB a CTA may have
//     only up to D = 437, hence the split by columns (the wrapper sizes
//     dchunk: D = 960, GIST1M's width, runs as three 320-column chunks of
//     168.5 KB, one CTA an SM; D = 128 as one chunk of 72.5 KB, three CTAs
//     an SM at 80 registers).  The A/B that chose these constants
//     (PERF.md, section 6) ran 4, 7, 8, 12 and 15 blocks a scan, 4, 8 and 16
//     rows in flight, 2 or 3 CTAs an SM at D = 128, and assignments
//     loaded a scan ahead in registers (slower).
//     The shared-memory limit is raised once per device to 227 KB, and a
//     launch that asks for more is refused.
//
// Replaces also: src/repro/kernels/kmeans.py::_update_kernel (the TPU
// kernel of kmeans_update_swizzled, the reference path's update), which
// launches (b) over its own (point tile, first_visit) table.
//
// (c) assign_tiles: src/repro/kernels/kmeans.py::_assign_kernel (the TPU
//     kernel of kmeans_assign_swizzled: ops.kmeans_assign, the reference
//     Lloyd path and the streaming service's assign command).  One CTA per
//     row (i, j) of a 2-D (point tile, centroid tile) curve table: (a)'s
//     kernel on the bp x bc tile, which writes the (min, first argmin) of
//     point tile i over centroid tile j once, to its own (i, j) slot of the
//     (pt, ct, bp) partials; a torch argmin over ct merges them.  Every
//     metric and every tie-break is (a)'s, so the reference path equals
//     the fused one to the bit.  Each centroid tile is zero-padded to a
//     multiple of 4 columns in the kernel's operand, which the epilogue
//     skips.
//     Bound on the H100: FP32 FLOP/s (2 N Kp D), as (a).  The (i, j) grid
//     has pt ct CTAs where (a) has pt, so a streaming batch of 4,096 probes
//     fills 256 CTAs at K = 1024 where (a) fills 32 of the 132 SMs.
//
// (d) shard step: src/repro/kernels/kmeans.py::_shard_lloyd_kernel (the
//     TPU kernel of kmeans_shard_program, one Lloyd step on one shard of
//     the curve-range-sharded k-means).  It is (a) and (b) again, as two
//     launches (the assign (a)'s kernel itself), with two differences the
//     sharded fold needs:
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
//     device table (the tree class's local fold; the JAX package's
//     lax.scan): out[e] = ((parts[o0][e] + parts[o1][e]) + parts[o2][e])
//     + ..., one f32 add chain per element, n = 0 giving zeros.
//     Bound on the H100: FP32 FLOP/s for the assign (2 N Kp D), bytes
//     for the update (x read, groups Kp (D + 1) 4 bytes of partials
//     written) and the fold (the partials read once).  Before the group
//     partials the exact class wrote and folded one partial per tile
//     (4.1 GB at SIFT1M's 7,813 tiles and K = 1024): a 28 ms gather copy
//     and a 13.7 ms fold per call.  At SIFT1M's 62 tiles a group it
//     writes 127 partials.  The fold's chain is serial in the tiles, so
//     its design is the bytes' path alone: a float4 of adjacent elements
//     a thread (four clamped floats when Kp D % 4 != 0 or a pointer is
//     not 16-byte aligned), 128-thread CTAs
//     (256 at SIFT1M's 131,072 floats: every SM), the order table staged
//     in shared memory 1,024 entries at a time, and the tiles loaded in
//     batches of 8 into two register sets, one batch added in table order
//     while the next is in flight, with streaming (evict-first) loads,
//     each partial being read once.  The whole batches' loads sit under no
//     branch: under one, ptxas gave every load of the ring one scoreboard
//     and each add waited for all of them, one tile in flight a thread
//     (3.5 ms against 1.3 at SIFT1M's 7,813 tiles; PERF.md, section 6).
//     A plain elementwise reduction like this one could be Triton; it
//     stays CUDA C++ beside the kernels whose partials it folds, in their
//     build.
#include <cfloat>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "kernel_info.cuh"
#include "simt_gemm.cuh"

namespace {

using namespace sfc;
using simt::THREADS;
using simt::TILE;

// ---------------------------------------------------------------------------
// (a), (c), (d) the assign
// ---------------------------------------------------------------------------

// (v, a) <- (ov, oa) if (ov, oa) comes first in the (value, index) order
__device__ __forceinline__ void take_min(float& v, int& a, float ov, int oa) {
  if (ov < v || (ov == v && oa < a)) {
    v = ov;
    a = oa;
  }
}

// simt_gemm.cuh's epilogue for the assign: per row of a (bm, bn) tile,
// the (min, first argmin) of m = |c|^2 - 2 x.c over the tile's columns
// (FLT_MAX at or past k_valid), written once to slot ((i ct + j) bm + row)
// of min_out / arg_out: i, j the tile's, ct = 1 when the tile spans every
// centroid.  Column l of tile j is centroid j bw + l, for l < bw; the bn -
// bw columns that pad a tile to a multiple of 4 are skipped.
struct Argmin {
  const float* __restrict__ cn;
  int k_valid, bm, bn, bw, ct;
  float* __restrict__ min_out;
  int* __restrict__ arg_out;
  static constexpr bool PREFETCH = false;
  __device__ void prefetch(int, int, int, int, int) const {}
  __device__ __forceinline__ void store(const float (&acc)[simt::TM][simt::TN], int row0, int rows,
                                        int col0, int /* cols: l < bw covers them */, int fr,
                                        int fc, int) const {
    using namespace simt;
    // the running pair of each (row, column half) of a sub-tile's rows
    __shared__ float run_v[WARPS_N * TILE];
    __shared__ int run_a[WARPS_N * TILE];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int half = warp % WARPS_N;
    const int tj = col0 / bn, sc = col0 - tj * bn;  // the tile, and the sub-tile's first column in it
    int col[TN];  // this thread's centroids, ascending in j; -1 past the tile's edge
    float cv[TN];  // and their |c|^2
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int l = sc + fc + (j / 4) * 32 + j % 4;
      col[j] = l < bw ? tj * bw + l : -1;
      cv[j] = l < bw ? __ldg(cn + tj * bw + l) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float v = __int_as_float(0x7f800000);  // +inf: loses to every real metric
      int a = INT_MAX;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if (col[j] < 0) continue;
        float m = __fsub_rn(cv[j], __fmul_rn(2.f, acc[i][j]));
        if (col[j] >= k_valid) m = FLT_MAX;
        if (m < v) {
          v = m;
          a = col[j];
        }
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)  // the 8 lanes that share these rows
        take_min(v, a, __shfl_xor_sync(0xffffffffu, v, off), __shfl_xor_sync(0xffffffffu, a, off));
      if (lane % 8 == 0) {  // one owner a (row, half): no barrier between sub-tiles
        const int r = half * TILE + fr + (i / 4) * 16 + i % 4;
        if (sc) take_min(v, a, run_v[r], run_a[r]);
        run_v[r] = v;
        run_a[r] = a;
      }
    }
    if (sc + TILE < bn) return;  // the row block has more sub-tiles
    // its last: the WARPS_N warps of these 32 rows meet, the first merges
    // the halves and writes each row once.  The next sub-tile's owners
    // write run_* only after the CTA barrier of its first stage.
    const int g = warp / WARPS_N;
    asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "r"(32 * WARPS_N) : "memory");
    if (half) return;
    const int r = g * 32 + lane;
    float v = run_v[r];
    int a = run_a[r];
#pragma unroll
    for (int h = 1; h < WARPS_N; ++h) take_min(v, a, run_v[h * TILE + r], run_a[h * TILE + r]);
    if (r < rows) {
      const int ti = row0 / bm;
      const size_t o = ((size_t)ti * ct + tj) * bm + (row0 - (size_t)ti * bm) + r;
      min_out[o] = v;
      arg_out[o] = a;
    }
  }
};

// The centroid tile's width in the kernel's operand: bw padded to a
// multiple of 4 (kernels/matmul.py::simt_layout)
__host__ __device__ constexpr int padded(int bw) { return (bw + 3) / 4 * 4; }

// The assign: CTA r walks the tile (i, j) of table row r (at sched[r cols
// ..], i in column col_i, j in col_j, j = 0 when col_j < 0), a (bp, bw)
// tile of x (M x D) . c^T, with Argmin's epilogue; k_valid, or lim[1] when
// lim is set (the shard step's device limits).  ck: the ct bw centroids as
// a D x (ct padded(bw)) K x N panel, each tile of bw zero-padded to
// padded(bw) columns, 16-byte aligned (kernels/kmeans.py::centroid_panel).
// All three assign entries run it.
__global__ void __launch_bounds__(THREADS, simt::MIN_CTAS)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ ck,
                     const float* __restrict__ cn, const int* __restrict__ sched, int cols,
                     int col_i, int col_j, int bp, int bw, int ct, int M, int D, int k_valid,
                     const int* __restrict__ lim, float* __restrict__ min_out,
                     int* __restrict__ arg_out) {
  const int bn = padded(bw);
  const simt::Walk w{sched, (int)blockIdx.x, 1, 1, bp, bn, M, ct * bn, nullptr, 1, D, cols, col_i,
                     col_j};
  const Argmin epi{cn, lim ? lim[1] : k_valid, bp, bn, bw, ct, min_out, arg_out};
  simt::gemm<simt::BPanel::KN>(x, D, ck, ct * bn, w, epi);
}

// one assign launch, a CTA a table row, refused unless ck is 16-byte
// aligned (the ring's 16-byte copies); the ring's shared memory limit is
// raised once per device
int launch_assign(const void* x, const void* ck, const void* cn, const void* sched, int steps,
                  int cols, int col_i, int col_j, int bp, int bw, int ct, int M, int D, int k_valid,
                  const void* lim, void* min_out, void* arg_out, void* stream) {
  if (steps == 0) return 0;
  if (steps < 0 || bp < 1 || bw < 1 || ct < 1 || D < 0 || (uintptr_t)ck % 16)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = raise_smem_limit<kmeans_assign_kernel>(simt::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kmeans_assign_kernel<<<steps, THREADS, simt::SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)ck, (const float*)cn, (const int*)sched, cols, col_i, col_j,
      bp, bw, ct, M, D, k_valid, (const int*)lim, (float*)min_out, (int*)arg_out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// (b), (d) the update
// ---------------------------------------------------------------------------

namespace upd {

constexpr int WARPS = THREADS / 32;  // warp w adds the rows of the centroids k with k % 8 == w
constexpr int SCAN = 7;              // 32-point blocks a warp scans at once
constexpr int RING = 8;              // rows a warp has in flight
constexpr int QCAP = 256;            // row ids a warp's queue holds: >= RING + 32 SCAN, a power of 2
constexpr int SMEM_MAX = 232448;     // the 227 KB a CTA may have: the most a launch asks for


// a CTA's dynamic shared memory: the (TILE, dchunk) f32 partial, TILE
// int32 counts and the warps' queues (kernels/kmeans.py::update_smem_bytes)
constexpr size_t smem_bytes(int dchunk) {
  return ((size_t)TILE * dchunk + TILE + (size_t)WARPS * QCAP) * sizeof(float);
}

// A CTA's point stream: point s is point s % bp of the tile in table row
// r_lo + s / bp; rows at or past n_valid are not points.
struct Stream {
  const int* sched;
  const int* arg;
  int cols, col_i, r_lo, bp, n_valid, k0, kn;
  unsigned ntiles, npts;
};

// Queue, in stream order, the rows of the next 32 SCAN points that this
// warp adds (assigned to a centroid k0 + kl with kl < kn, kl % 8 == warp).
// Every table and assignment load of the scan is issued before its first
// ballot; a point past the stream or at or past n_valid loads nothing.
__device__ __forceinline__ void scan(const Stream& st, int warp, int lane, int* queue,
                                     unsigned& scanned, unsigned& tail) {
  int row[SCAN];
  unsigned t = (scanned + lane) / st.bp;
  unsigned p = scanned + lane - t * st.bp;
#pragma unroll
  for (int b = 0; b < SCAN; ++b) {
    row[b] = -1;
    if (t < st.ntiles) {
      const long long r =
          (long long)__ldg(st.sched + (size_t)(st.r_lo + t) * st.cols + st.col_i) * st.bp + p;
      if (r < st.n_valid) row[b] = (int)r;
    }
    for (p += 32; p >= (unsigned)st.bp; p -= st.bp) ++t;
  }
  int a[SCAN];
#pragma unroll
  for (int b = 0; b < SCAN; ++b) a[b] = row[b] >= 0 ? __ldg(st.arg + row[b]) : -1;
  __syncwarp();  // every lane is done reading the queue slots reused below
#pragma unroll
  for (int b = 0; b < SCAN; ++b) {
    const int kl = a[b] - st.k0;
    const bool mine = a[b] >= 0 && kl >= 0 && kl < st.kn && (kl & (WARPS - 1)) == warp;
    const unsigned m = __ballot_sync(0xffffffffu, mine);
    if (mine) queue[(tail + __popc(m & ((1u << lane) - 1))) & (QCAP - 1)] = row[b];
    tail += __popc(m);
  }
  scanned += 32 * SCAN;
}

// issue the loads of a queued row: its assignment and its dn columns
// from d0, lane + 32 j in v[j]
template <int V>
__device__ __forceinline__ void fetch(const float* __restrict__ x, const int* __restrict__ arg,
                                      int row, int D, int d0, int dn, int lane, float (&v)[V],
                                      int& a) {
  a = __ldg(arg + row);
  const float* xr = x + (size_t)row * D + d0 + lane;
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (lane + 32 * j < dn) v[j] = __ldcs(xr + 32 * j);
}

}  // namespace upd

// The (128-centroid range blockIdx.y, column chunk blockIdx.z) block of
// the partial over the point tiles of table rows [r_lo, r_hi), written
// once to psum_g (Kp, D) / pcnt_g (Kp) (the counts by the z = 0 CTA).
// Rows at or past n_valid add nothing; a CTA with no row to add writes
// zeros.  Each warp scans the stream into its queue a scan ahead and
// keeps RING rows in flight in registers, adding them in queue order:
// element (k, d) of the partial is 0.f plus each of k's rows, in stream
// order, one f32 add each.  Both update kernels run exactly this; V = the
// columns of a chunk a lane holds (dchunk <= 32 V).
template <int V>
__device__ __forceinline__ void update_partial(const float* __restrict__ x,
                                               const int* __restrict__ arg,
                                               const int* __restrict__ sched, int sched_cols,
                                               int col_i, int r_lo, int r_hi, int bp, int n_valid,
                                               int Kp, int D, int dchunk, float* __restrict__ psum_g,
                                               float* __restrict__ pcnt_g) {
  using namespace upd;
  extern __shared__ float sh[];
  float* ssum = sh;                                                // [TILE][dchunk]
  int* scnt = reinterpret_cast<int*>(sh + (size_t)TILE * dchunk);  // [TILE]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* queue = scnt + TILE + warp * QCAP;                          // [WARPS][QCAP]
  const int k0 = blockIdx.y * TILE;
  const int kn = min(TILE, Kp - k0);
  const int d0 = blockIdx.z * dchunk;
  const int dn = min(dchunk, D - d0);
  for (int idx = threadIdx.x; idx < TILE * dchunk; idx += THREADS) ssum[idx] = 0.f;
  if (threadIdx.x < TILE) scnt[threadIdx.x] = 0;
  __syncthreads();
  const unsigned ntiles = (unsigned)(r_hi - r_lo);
  const Stream st{sched, arg, sched_cols, col_i, r_lo, bp, n_valid, k0, kn, ntiles,
                  ntiles * (unsigned)bp};
  unsigned scanned = 0;  // points of the stream scanned
  unsigned tail = 0;     // rows queued: entry i at queue[i % QCAP], in slot i % RING once issued
  float xv[RING][V];
  int av[RING];
  while (scanned < st.npts && tail < RING) scan(st, warp, lane, queue, scanned, tail);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < RING; ++j)
    if (j < tail) fetch<V>(x, arg, queue[j], D, d0, dn, lane, xv[j], av[j]);
  for (unsigned i0 = 0;; i0 += RING) {
    // entries i0 .. i0 + RING - 1 are in flight; queue those whose loads
    // this pass issues
    while (scanned < st.npts && tail < i0 + 2 * RING)
      scan(st, warp, lane, queue, scanned, tail);
    __syncwarp();
    if (i0 >= tail) break;
#pragma unroll
    for (int j = 0; j < RING; ++j) {
      const unsigned i = i0 + j;
      if (i < tail) {
        const int k = av[j] - k0;
        float* acc = ssum + (size_t)k * dchunk + lane;
#pragma unroll
        for (int c = 0; c < V; ++c)
          if (lane + 32 * c < dn) acc[32 * c] = __fadd_rn(acc[32 * c], xv[j][c]);
        if (lane == 0) scnt[k] += 1;
        if (i + RING < tail)
          fetch<V>(x, arg, queue[(i + RING) & (QCAP - 1)], D, d0, dn, lane, xv[j], av[j]);
      }
    }
  }
  __syncthreads();
  float* out = psum_g + (size_t)k0 * D + d0;
  for (int idx = threadIdx.x; idx < kn * dn; idx += THREADS)
    out[(size_t)(idx / dn) * D + idx % dn] = ssum[(size_t)(idx / dn) * dchunk + idx % dn];
  if (blockIdx.z == 0 && threadIdx.x < kn) pcnt_g[k0 + threadIdx.x] = (float)scnt[threadIdx.x];
}

template <int V>
__global__ void __launch_bounds__(THREADS, V <= 4 ? 3 : 1)
kmeans_update_kernel(const float* __restrict__ x, const int* __restrict__ arg,
                     const int* __restrict__ sched, int sched_cols, int col_i, int steps,
                     int tiles_per_group, int bp, int n_valid, int Kp, int D, int dchunk,
                     float* __restrict__ psum, float* __restrict__ pcnt) {
  const int g = blockIdx.x;
  const int r_lo = g * tiles_per_group;
  update_partial<V>(x, arg, sched, sched_cols, col_i, r_lo, min(steps, r_lo + tiles_per_group),
                    bp, n_valid, Kp, D, dchunk, psum + (size_t)g * Kp * D, pcnt + (size_t)g * Kp);
}

// The shard step's update: CTA (g, c, z) folds the point tiles of table
// rows [g tpg, (g + 1) tpg) into group slot g, masked by the device
// n_valid_local = lim[0].  A shard of pure padding (n_valid_local = 0)
// writes zeros to every slot.
template <int V>
__global__ void __launch_bounds__(THREADS, V <= 4 ? 3 : 1)
kmeans_shard_update_kernel(const float* __restrict__ x, const int* __restrict__ arg,
                           const int* __restrict__ sched, int sched_cols, int col_i,
                           int tiles_per_group, int bp, const int* __restrict__ lim, int Kp, int D,
                           int dchunk, float* __restrict__ psum, float* __restrict__ pcnt) {
  const size_t g = blockIdx.x;
  const int r_lo = (int)g * tiles_per_group;
  update_partial<V>(x, arg, sched, sched_cols, col_i, r_lo, r_lo + tiles_per_group, bp, lim[0],
                    Kp, D, dchunk, psum + g * Kp * D, pcnt + g * Kp);
}

// one update launch of kernel Kern with dchunk columns a CTA: refused if
// its shared memory passes the limit raised once per device
template <auto Kern, typename... Args>
int launch_update(dim3 grid, int dchunk, void* stream, Args... args) {
  const size_t smem = upd::smem_bytes(dchunk);
  if (smem > (size_t)upd::SMEM_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t err = raise_smem_limit<Kern>(upd::SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  Kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// f(V) for the V of a chunk of dchunk columns: 4 columns a lane up to
// dchunk = 128 (D = 128), else 16 (D = 960's chunks of 320)
template <typename F>
int by_columns(int dchunk, F&& f) {
  if (dchunk <= 128) return f(std::integral_constant<int, 4>{});
  return f(std::integral_constant<int, 16>{});
}

// ---------------------------------------------------------------------------
// (d) the tree class's fold
// ---------------------------------------------------------------------------

constexpr int FOLD_THREADS = 128;  // 256 CTAs at SIFT1M's 131,072 floats: every SM has one or two
constexpr int FOLD_VEC = 4;        // adjacent elements a thread
constexpr int FOLD_BATCH = 8;      // tiles a batch of loads: 8 to 16 tiles in flight a thread
constexpr int FOLD_CHUNK = 1024;   // order entries a CTA stages at once, a multiple of 2 FOLD_BATCH

// FOLD_VEC floats of tile o from element e: one 16-byte streaming load
// (evict-first: each partial is read once) when the tiles are whole
// float4s, else four 4-byte ones, each index clamped to the tile
template <bool VEC>
__device__ __forceinline__ float4 fold_load(const float* __restrict__ parts, int o, size_t elems,
                                            size_t e) {
  const float* p = parts + (size_t)o * elems;
  if (VEC) return __ldcs(reinterpret_cast<const float4*>(p + e));
  return make_float4(__ldcs(p + min(e, elems - 1)), __ldcs(p + min(e + 1, elems - 1)),
                     __ldcs(p + min(e + 2, elems - 1)), __ldcs(p + min(e + 3, elems - 1)));
}

// issue the loads of the staged table's tiles [t0, t0 + FOLD_BATCH) into
// r; with ALL unset, only of those below lim
template <bool VEC, bool ALL>
__device__ __forceinline__ void fold_batch(float4 (&r)[FOLD_BATCH], const float* __restrict__ parts,
                                           const int* staged, int t0, int lim, size_t elems,
                                           size_t e) {
#pragma unroll
  for (int j = 0; j < FOLD_BATCH; ++j)
    if (ALL || t0 + j < lim) r[j] = fold_load<VEC>(parts, staged[t0 + j], elems, e);
}

// acc += r[0], r[1], ... in order, one f32 add an element each; with ALL
// unset, only those of tiles t0 + j below lim
template <bool ALL>
__device__ __forceinline__ void fold_adds(float4& acc, const float4 (&r)[FOLD_BATCH], int t0,
                                          int lim) {
#pragma unroll
  for (int j = 0; j < FOLD_BATCH; ++j) {
    if (ALL || t0 + j < lim) {
      acc.x = __fadd_rn(acc.x, r[j].x);
      acc.y = __fadd_rn(acc.y, r[j].y);
      acc.z = __fadd_rn(acc.z, r[j].z);
      acc.w = __fadd_rn(acc.w, r[j].w);
    }
  }
}

// out[e] = parts[order[0]][e] + parts[order[1]][e] + ..., a left fold in
// the order of the table, `elems` floats a tile, FOLD_VEC adjacent
// elements a thread (VEC: elems % 4 == 0 and aligned pointers, so each
// tile's are one float4).  The CTA stages the table FOLD_CHUNK entries at
// a time (and the FOLD_BATCH after them) in shared memory with coalesced
// loads.  A thread loads the tiles in batches of FOLD_BATCH into two
// register sets, ring[0] holding the batches that start at even multiples
// of FOLD_BATCH, and adds one batch in table order while the next one's
// loads are in flight.  The batches that are whole issue their loads
// under no branch: ptxas gives loads under branches one scoreboard, and
// an add waiting on it waits for every load in flight (PERF.md: 3.5 ms
// against 1.3).  The chain starts at -0.f, which x + -0.f leaves as x to
// the bit, so element e is the plain fold's chain; n = 0 writes zeros.  A
// thread past the end loads element 0's floats and stores nothing.
template <bool VEC>
__global__ void __launch_bounds__(FOLD_THREADS)
kmeans_fold_kernel(const float* __restrict__ parts, const int* __restrict__ order, int n,
                   size_t elems, float* __restrict__ out) {
  constexpr int B = FOLD_BATCH;
  __shared__ int staged[FOLD_CHUNK + B];
  const size_t e = ((size_t)blockIdx.x * FOLD_THREADS + threadIdx.x) * FOLD_VEC;
  const size_t el = e < elems ? e : 0;
  float4 acc = make_float4(-0.f, -0.f, -0.f, -0.f);
  float4 ring[2][B];
  for (int c0 = 0; c0 < n; c0 += FOLD_CHUNK) {
    const int staged_n = min(FOLD_CHUNK + B, n - c0);  // tiles [c0, c0 + staged_n)
    __syncthreads();  // every thread is done with the last chunk's entries
    for (int i = threadIdx.x; i < staged_n; i += FOLD_THREADS) staged[i] = __ldg(order + c0 + i);
    __syncthreads();
    if (c0 == 0) fold_batch<VEC, false>(ring[0], parts, staged, 0, staged_n, elems, el);
    const int end = min(FOLD_CHUNK, n - c0);
    int t = 0;
    for (; t + 3 * B <= staged_n; t += 2 * B) {
      fold_batch<VEC, true>(ring[1], parts, staged, t + B, 0, elems, el);
      fold_adds<true>(acc, ring[0], t, 0);
      fold_batch<VEC, true>(ring[0], parts, staged, t + 2 * B, 0, elems, el);
      fold_adds<true>(acc, ring[1], t + B, 0);
    }
    for (; t < end; t += 2 * B) {  // the table's last tiles
      fold_batch<VEC, false>(ring[1], parts, staged, t + B, staged_n, elems, el);
      fold_adds<false>(acc, ring[0], t, end);
      fold_batch<VEC, false>(ring[0], parts, staged, t + 2 * B, staged_n, elems, el);
      fold_adds<false>(acc, ring[1], t + B, end);
    }
  }
  if (e >= elems) return;
  const float4 r = n ? acc : make_float4(0.f, 0.f, 0.f, 0.f);
  if (VEC) {
    *reinterpret_cast<float4*>(out + e) = r;
  } else {
    const float v[FOLD_VEC] = {r.x, r.y, r.z, r.w};
    for (int i = 0; i < FOLD_VEC && e + i < elems; ++i) out[e + i] = v[i];
  }
}

}  // namespace

// (a): steps point tiles, the i of table row r at sched[r sched_cols +
// col_i], each over all Kp centroids (ck: one tile of Kp); x is steps bp
// rows.
extern "C" int sfc_kmeans_assign(const void* x, const void* ck, const void* cn, const void* sched,
                                 int steps, int sched_cols, int col_i, int bp, int Kp, int D,
                                 int k_valid, void* min_out, void* arg_out, void* stream) {
  return launch_assign(x, ck, cn, sched, steps, sched_cols, col_i, -1, bp, Kp, 1, steps * bp, D,
                       k_valid, nullptr, min_out, arg_out, stream);
}

extern "C" int sfc_kmeans_update(const void* x, const void* arg, const void* sched, int sched_cols,
                                 int col_i, int steps, int groups, int ctiles, int dchunks,
                                 int tiles_per_group, int bp, int n_valid, int Kp, int D, int dchunk,
                                 void* psum, void* pcnt, void* stream) {
  return by_columns(dchunk, [&](auto v) {
    return launch_update<kmeans_update_kernel<decltype(v)::value>>(
        dim3(groups, ctiles, dchunks), dchunk, stream, (const float*)x, (const int*)arg,
        (const int*)sched, sched_cols, col_i, steps, tiles_per_group, bp, n_valid, Kp, D, dchunk,
        (float*)psum, (float*)pcnt);
  });
}

// (c): steps = pt ct (point tile i, centroid tile j) rows, i and j in
// columns col_i, col_j of sched_cols; ck: ct tiles of bc; x is pt bp rows,
// tile (i, j)'s partial at [(i ct + j) bp, + bp) of min_out / arg_out.
extern "C" int sfc_kmeans_assign_tiles(const void* x, const void* ck, const void* cn,
                                       const void* sched, int steps, int sched_cols, int col_i,
                                       int col_j, int bp, int bc, int ct, int D, int k_valid,
                                       void* min_out, void* arg_out, void* stream) {
  if (ct < 1 || steps % ct) return (int)cudaErrorInvalidValue;
  return launch_assign(x, ck, cn, sched, steps, sched_cols, col_i, col_j, bp, bc, ct,
                       steps / ct * bp, D, k_valid, nullptr, min_out, arg_out, stream);
}

// (d): as sfc_kmeans_assign, k_valid read from the device limits lim =
// (n_valid_local, k_valid), so one launch configuration serves every shard.
extern "C" int sfc_kmeans_shard_assign(const void* x, const void* ck, const void* cn,
                                       const void* sched, int steps, int sched_cols, int col_i,
                                       int bp, int Kp, int D, const void* lim, void* min_out,
                                       void* arg_out, void* stream) {
  return launch_assign(x, ck, cn, sched, steps, sched_cols, col_i, -1, bp, Kp, 1, steps * bp, D, 0,
                       lim, min_out, arg_out, stream);
}

extern "C" int sfc_kmeans_shard_update(const void* x, const void* arg, const void* sched,
                                       int sched_cols, int col_i, int groups, int ctiles,
                                       int dchunks, int tiles_per_group, int bp, const void* lim,
                                       int Kp, int D, int dchunk, void* psum, void* pcnt,
                                       void* stream) {
  return by_columns(dchunk, [&](auto v) {
    return launch_update<kmeans_shard_update_kernel<decltype(v)::value>>(
        dim3(groups, ctiles, dchunks), dchunk, stream, (const float*)x, (const int*)arg,
        (const int*)sched, sched_cols, col_i, tiles_per_group, bp, (const int*)lim, Kp, D, dchunk,
        (float*)psum, (float*)pcnt);
  });
}

extern "C" int sfc_kmeans_fold(const void* parts, const void* order, int n, int Kp, int D, void* out,
                               void* stream) {
  const size_t elems = (size_t)Kp * D;
  const size_t per_cta = (size_t)FOLD_THREADS * FOLD_VEC;
  const unsigned blocks = (unsigned)((elems + per_cta - 1) / per_cta);
  if (!blocks) return 0;
  const bool vec = elems % FOLD_VEC == 0 && (uintptr_t)parts % 16 == 0 && (uintptr_t)out % 16 == 0;
  auto kern = vec ? kmeans_fold_kernel<true> : kmeans_fold_kernel<false>;
  kern<<<blocks, FOLD_THREADS, 0, (cudaStream_t)stream>>>((const float*)parts, (const int*)order, n,
                                                          elems, (float*)out);
  return (int)cudaGetLastError();
}

// The build and residency of the k-means kernels (kernel_info.cuh;
// launches nothing): which = 0 the update at the main path's D = 128 (V =
// 4, dchunk 128), 1 at GIST1M's D = 960 (V = 16, dchunk 320), 2 the shard
// update at D = 128, with (V, RING, SCAN); 3 the fold, with (FOLD_VEC,
// 2 FOLD_BATCH, FOLD_CHUNK): floats a thread, the most tiles in flight a
// thread, order entries staged at once; 4 the assign, with simt_gemm.cuh's
// (TN, BK, STAGES).
extern "C" int sfc_kmeans_info(int which, int* out) {
  if (which == 4)
    return sfc::kernel_info((const void*)kmeans_assign_kernel, THREADS, simt::SMEM_BYTES,
                            {simt::TN, simt::BK, simt::STAGES}, out);
  if (which == 3)
    return sfc::kernel_info((const void*)kmeans_fold_kernel<true>, FOLD_THREADS, 0,
                            {FOLD_VEC, 2 * FOLD_BATCH, FOLD_CHUNK}, out);
  const int dchunk = which == 1 ? 320 : 128;
  const int v = which == 1 ? 16 : 4;
  const void* fn = which == 0   ? (const void*)kmeans_update_kernel<4>
                   : which == 1 ? (const void*)kmeans_update_kernel<16>
                                : (const void*)kmeans_shard_update_kernel<4>;
  return sfc::kernel_info(fn, THREADS, (int)upd::smem_bytes(dchunk), {v, upd::RING, upd::SCAN},
                          out);
}
