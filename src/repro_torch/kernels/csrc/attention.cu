// Flash attention over curve- and page-scheduled runs: three entry points;
// the full-sequence and prefill kernels share one SIMT online-softmax
// routine (flash_rows) and, in bf16, one tensor-core consumer; decode is
// split-KV.
//
// sfc_flash_attention replaces src/repro/kernels/attention.py::
// flash_attention_swizzled (_flash_kernel): attention over (BH, S, D) with
// a jump-over (q_tile, kv_tile, first, last) table; causal attention lists
// only the lower-triangular tiles, each q tile's kv tiles in serpentine
// order.  One CTA per (run, bh): a run is one q tile's kv walk.
//
// sfc_flash_decode replaces flash_attention_decode (_flash_decode_kernel):
// one decode step of (B, Hkv, g, Dk) grouped queries against (P, ps, Hkv,
// D) page pools read through page_table[slot, lp].  A slot's walk stops at
// its last live page (lp <= pos // ps): a later page is masked by position
// and adds exactly zero to a finite state.  A slot with pos < 0 walks all
// its pages, every entry masked: the mean of every V row visited.
//
// sfc_flash_prefill replaces flash_attention_prefill (_flash_prefill_kernel):
// a cohort's (B, Tq, Hkv, g, Dk) new tokens, causal over each slot's paged
// prefix.  One CTA per (run, kv head); a run is one (slot, q tile of ps
// tokens) and its rows are the ps * g (token, head) pairs of the tile, or
// on the tensor-core and register-tiled cores T = 128 / g consecutive
// tokens of one slot walking the pages of its last new token (below).
// Rows that no run covers stay unwritten, as on the TPU.  The wrapper
// launches the runs longest first (kernels/attention.py::longest_first):
// a lane's runs grow with its q tiles, and in table order the launch's
// last wave held the last lane's longest runs.
//
// The TPU grids run (heads, steps) in order and carry the online-softmax
// state in VMEM from one table row to the next; here each run is a loop
// inside one CTA, the host hands every CTA its run (first row, rows), and
// no state crosses CTAs.  Scores are f32 from f32 or bf16 inputs, masked
// with the finite -0.7 * FLT_MAX of the JAX package (a fully masked row
// stays finite), exponentials by expf, and the output is written in the
// input dtype.
//
// Bound on the H100: bytes.  Decode reads each live K/V page once for g
// query rows (2 flops per byte in bf16 at g = 8); prefill and the
// full-sequence kernel do 2 * rows flops per K/V element read, well under
// the ridge of the bf16 tensor cores.  The SIMT f32 core (flash_rows) runs
// every sfc_flash_attention and sfc_flash_prefill that neither the
// tensor-core core nor the register-tiled f32 core (below) takes: a CTA of 8
// warps stages 64 kv rows of K and V at a time in shared memory as f32
// (the page-table or tile-table lookup done once per row by one thread),
// each warp owns RW query rows held in shared memory, a lane owns one kv
// row of each 32-row chunk for the scores and 4 of the 128 output columns
// for P.V, and each row's (m, l, acc) lives in registers.  Query blocks of
// more than 64 rows (prefill's 16 x 8, bq = 128) are walked in passes of
// 64.
//
// Decode ran on that core too, one CTA per (slot, kv head): at the serving
// shape (8 slots x 128 pages of 16, Hkv 4, g 8, D 64, bf16) 32 CTAs on 132
// SMs, 0.385-0.440 ms for ~7.6 MB of live K/V.  It is now split-KV (dec::,
// below), one design for f32 and bf16: a split CTA per (slot run, split of
// 128 // ps consecutive pages (at least one), kv head, group of 8 query
// heads), the grid fixed by the shapes alone (pos stays on the card; a CTA
// whose split starts past its slot's last live page exits at once), then
// a merge CTA per (slot run, kv head), both launched by the one entry.  A
// split CTA has up to 4 warps; a warp walks chunks of 32 kv rows, lane j
// looking up row j's page (the first chunk's while pos is in flight) and
// the warp copying the chunk with 16-byte cp.async (8 lanes a 128-byte
// bf16 row) into shared memory as stored, K and V as two groups, so the
// scores and the softmax run while V lands; a warp with more than one
// chunk (pages over 128 rows) keeps the next one in flight in a second
// ring slot.  Lane j scores row j against the 8 query rows (f32 in shared
// memory), bf16 converted in registers, the online softmax in f32, P.V
// with a lane owning output columns; the warps' states merge in shared
// memory and the split's (acc, m, l) go to an f32 workspace (runs,
// splits, Hkv, g, Dv + 2) that the
// wrapper allocates.  The merge takes each slot's live splits in
// ascending order (deterministic), 8 splits' loads in flight a thread.
// Splits of 128 rows (8 pages of 16): 512 split CTAs, 244 live at the
// timing run's positions.  A call by CUDA events, the host's enqueue
// included, 0.062-0.089 ms against 0.126-0.163 for page gather + SDPA;
// device time 0.022 ms (split 0.016, merge 0.005) against 0.025 (NVIDIA
// H100 80GB HBM3, 700.00 W, chip_smoke.py).  Tensor cores would not pay: at
// 2 flops a byte the kernel is bound by bytes and latency, not by FP32
// issue.
//
// sfc_flash_attention in f32 at D = 64 or 128, bq = 128 and bkv a
// multiple of 64 runs the register-tiled SIMT core (tiled::, below;
// kernels/attention.py::flash_core is the same rule).  Bound on the H100:
// the FP32 pipes (TF32 stays off): 0.513 ms at the model's forward (BH
// 64, S 2048, D 64, causal).  flash_rows took 3.92-3.99 ms there (SDPA f32
// 1.21-1.23; H100 80GB HBM3, 700.00 W): a lane scored one kv row against
// Q rows re-read from shared memory for every 4-deep step (~2.7 FFMA a
// shared-memory load), K and V were staged through registers behind
// three barriers a tile, and a q tile of 128 rows took two passes over
// its kv walk.  This core holds the CTA's 128 query rows in one pass:
// Q^T is copied once (4-byte cp.async that transpose it), K^T and V
// stream through a two-stage cp.async ring of 64 kv rows (K^T by 4-byte
// copies, V as stored by 16-byte ones; the next stage in flight while
// this one is used), and each thread owns 8 query rows: an 8 x
// 4 tile of S (2 + 1 LDS.128 for 32 FFMA a d), the online softmax on its
// rows (a row's maximum by 4 shuffles among the 16 lanes sharing it, its
// sum kept per thread), P through its warp's rows of shared memory, and
// an 8 x D/16 tile of O (P·V: 2 + D/64 LDS.128 for 32 D/64 FFMA a kv
// row), so the rescale by alpha never leaves the thread.  Every score is
// flash_rows' fmaf chain over d; the row sums and P·V are summed in
// another order (within 1e-4 of the plain version).  1.24-1.33 ms there,
// SDPA f32 1.23 in the same runs (chip_smoke.py and an A/B probe); the
// FFMA share of the issued stage is ~0.72 (SASS: the S loop 288 of 340,
// P·V 1,024 of 1,170; the softmax's 40 expf and the copies the rest) at
// 167 registers and one CTA (8 warps) an SM.
//
// sfc_flash_prefill in f32 with Dk = Dv = 64 or 128, 128 rows a CTA (ps g
// = 128; or CTAs of 128 / g tokens, below) and pages of 4 to 64 rows (a
// multiple of 4) runs the same core
// (tiled_core, templated on the walk) on a paged cp.async producer
// (prefill_tiled_kernel; kernels/attention.py::prefill_core picks the core
// and the entry launches it or refuses the call).  At the serving cohort
// (8 lanes, Tq 1024, 1,056 CTAs, TinyLlama's Hkv 4, g 8, D 64, pages of
// 16) the bound is 0.613 ms of FP32 operations, and flash_rows took
// 6.24-6.38 ms there (its three faults above, and its page lookups done a
// row a thread behind a barrier).  The core is unchanged; what the pages
// change is the producer: a stage is 64 / ps whole pages of one kv head,
// ps rows Hkv D apart in the pool.  Warp 0 looks a stage's pages up
// through the page table two stages ahead, a lane a page, and publishes
// (logical page, physical page) and the stage's largest position in three
// slots of shared memory, so each copy reads its page from shared memory
// and the lookups' latency hides behind a stage of arithmetic; Q^T's rows
// come through PrefillWalk::row (g heads of a token D apart, tokens Hkv g
// D apart).  A thread's 4 kv columns lie in one page (ps % 4 == 0), so
// their positions are lp ps + (4 c mod ps) + j; the slots of a stage past
// the run's end re-read its last page and score -inf; a stage whose pages
// are all live and at or before the CTA's first query position masks
// nothing.  1.37-1.41 ms at that shape with the runs launched longest
// first, 1.54-1.58 in table order in the same runs, against flash_rows'
// 6.28-6.31 in the same call (gather + SDPA f32 10.4-10.6; NVIDIA H100
// 80GB HBM3, 700.00 W; chip_smoke.py), at 168 registers (251 at D = 128,
// no spill), one CTA an SM.
//
// sfc_flash_attention in bf16 at D = 64 or 128, bq = 128 and bkv a
// multiple of 64 runs the tensor-core core instead (flash_wgmma_kernel;
// kernels/attention.py::flash_core is the same rule).  At the model's
// forward (BH 64, S 2048, D 64, causal) the work is 0.0348 ms of bf16
// tensor-core operations, and on the SIMT core, whose every product runs
// on the FP32 pipes, it took 3.894 ms (NVIDIA H100 80GB HBM3, 700.00 W;
// SDPA 0.187).  The design moves both products onto wgmma: TMA loads Q
// once and K, V in 128-row stages (two 64-row boxes each, 128-byte
// swizzle) into a ring of full / empty mbarriers, one producer thread
// walking the run's table rows in table order (the serpentine order);
// two consumer warpgroups of 64 query rows each run S = Q K^T
// (m64n128k16, K K-major from shared memory), the masks and the online
// softmax on S's accumulator fragments (a row lives in one quad of
// lanes: 2 shuffles a row maximum, the row sums kept per thread until
// the end), and O += P V with P's fragments packed to bf16 in registers
// as wgmma's A operand (m64nDk16, V MN-major).  P in bf16 is the only
// precision change (the reference multiplies p.v in f32), and one bf16
// term of P is what ships: at the forward's shape the kernel is within
// one bf16 ulp of the plain version (1.56e-2 at outputs up to 3.8,
// inside rtol 8e-3 / atol 4e-3), so the two-term split P_hi + P_lo is
// not needed.  What bounds it now is the softmax on the SMs (128 x 128
// exponentials and their masks, maxima and sums a stage), which the
// tensor cores wait for: 0.216 ms at that shape on the same card, then
// 0.183-0.197 with a stage that masks nothing skipping the mask
// arithmetic and a 3-stage ring at D = 64 (SDPA 0.148-0.159 in the same
// runs; chip_smoke.py).
//
// At D = 80 (Zamba2's shared attention, HuBERT's encoder) both cores take
// row 20 too; flash_rows ran it before, 4.39-4.43 ms in bf16 and 4.47-4.52
// in f32 at Zamba2's forward (BH 64, S 2048, causal), against bounds of
// 0.0434 ms (bf16 tensor-core operations) and 0.641 (FP32).  The
// tensor-core core keeps its 128-row tiles as two 64-column chunks: the
// tensor maps span the true 80 columns (160-byte rows), so the second
// chunk's box reads columns 64..79 and TMA writes zeros past them, with
// no padded copy on the host.  S = Q K^T issues the 5 k16 steps D has (4
// in chunk 0, 1 in chunk 1), each score still one product over d, and
// P V is m64n80k16 on the same MN-major descriptor (the second atom's
// first 16 columns), 40 accumulators a thread, the unmasked fast path kept
// (166 registers, no spill, 2 stages, 164,912 B).  Against it, a
// 64-column chunk plus a 16-column tail in the 32-byte swizzle (20 KB
// tiles, 3 stages, P V as m64n64k16 + m64n16k16) and m64n128k16 over the
// zero-filled chunk read 0.2057 and 0.2036 ms (medians of 6 turns each)
// to this form's 0.1955, SDPA 0.197 (H100 80GB HBM3, 700.00 W; an A/B probe
// since removed): the softmax on the 128 x 128 stage sets the pace, not
// the products or the ring.  In chip_smoke.py 0.205 ms, SDPA 0.181,
// flash_rows (on tiles of 64) 3.77.  The register-tiled core gives a thread 5 of
// D's columns: float4 columns 4 c .. 4 c + 3 as at D = 64 and column 64 +
// c, one LDS.32 a kv row (the 16 lanes of a row group read 16 consecutive
// floats) for 8 more FMAs; Q^T, K^T and the score chain index d up to 80
// unchanged, so every score is still flash_rows' fmaf chain (214
// registers, no spill, 156,928 B, one CTA an SM).  1.510 ms (1.495-1.517)
// against SDPA f32 1.62, where padding D to 96 inside the kernel (16 zero
// d in S, a float2 tail) read 1.724 in the same runs; in chip_smoke.py
// 1.561, SDPA f32 1.601, flash_rows 3.78.
//
// sfc_flash_prefill in bf16 with Dk = Dv = 64 or 128, 128 query rows a
// CTA (ps g = 128; or CTAs of 128 / g tokens, below) and pages of 8 to 64 rows
// runs the same consumer on a paged
// producer (prefill_wgmma_kernel; kernels/attention.py::prefill_core
// picks the core and the entry launches it or refuses the call).  At the serving cohort (8 lanes, Tq 1024, 1,056 CTAs of
// 128 rows, TinyLlama's Hkv 4, g 8, D 64, pages of 16) the work is 0.0415
// ms of bf16 tensor-core operations; on the SIMT core it took 6.44 ms
// (H100 80GB HBM3, 700.00 W; page gather + SDPA 0.73).  Its bound is row
// 20's: the softmax on the SMs.  What the page table changes is the
// producer: a CTA's 128 rows (ps tokens x the g heads of one kv head, in
// PrefillWalk::row order) are one 4-D TMA box of Q {Dk, g, Hkv, B Tq};
// K and V come a page at a time, a 3-D box {D, Hkv, P ps} of ps rows of
// one kv head, each on its own 1024-byte swizzle atom (hence ps >= 8),
// 128 / ps pages a stage, looked up and issued by one lane each of the
// producer warp.  Positions are not contiguous across pages, so the
// producer publishes per stage each 8-column block's first position in
// shared memory, which a masked stage reads; the slots of a stage past
// the run's end re-read its last page and score -inf, and a stage whose
// pages are all live and at or before the CTA's first query position
// masks nothing (at D = 64, row 20's fast path).  0.226-0.261 ms at that
// shape, 2.9-3.6x faster than page gather + SDPA (0.75-0.84 in the same
// runs; chip_smoke.py).
//
// Row 22 where a q tile's ps g rows fill less than a CTA: OLMoE's and
// StableLM's g = 1 (16 rows at pages of 16), Minitron's g = 4 (64).  Both
// cores needed ps g = 128, so every such shape ran flash_rows, a CTA of
// ps g rows a q tile: at OLMoE's serving cohort (8 lanes, Tq 1,024, Hkv
// 16, D 128, pages of 16) 5,584 CTAs of 16 rows on the FP32 pipes, each
// staging its whole walk's K/V as f32 behind a row-a-thread page lookup,
// so every K/V byte was read 8x as often as at 128 rows: 20.6-20.8 ms in
// bf16 against a bound of 0.0435 and a page gather + SDPA of 0.71-0.83,
// 17.5-17.6 in f32 (bound 0.540, gather + SDPA f32 3.9-4.0).  A CTA of
// either core now takes T = 128 / g consecutive tokens of one lane
// (every shape whose q tile fits, ps g <= 128, so T >= ps): its T g
// rows are those tokens x the g heads of one kv head in
// PrefillWalk::row order (128 where g divides 128; 125 at Qwen's g = 5,
// whose q tile of 80 rows fits no whole number of times), and it walks
// logical pages 0 .. (p0 + its last new token) / ps, which cover each
// earlier token's pages; an earlier token's rows see the later pages
// masked by position, which adds exactly zero to a finite online-softmax
// state (decode's argument above), so every row is the function the
// per-tile walk computes.  Where T is not a multiple of ps a CTA's first
// and last pages are partly its own: the masks are by position, not by
// page.  The CTAs are the JAX table at bq = T (the host builds it from
// the cohort of the ps table, kernels/attention.py::prefill_cta_schedule,
// with runs of (first row, rows, t0, tokens) launched longest first), a
// lane's CTAs covering its q tiles' ceil(n / ps) ps tokens (one CTA of
// pad tokens only where those end past its CTAs of new tokens), so the
// rows written are the per-tile launch's.  Where ps divides T those CTAs
// are the earlier groups of T / ps whole q tiles: the same CTAs, walks,
// order and bits (tools/gqa_hashes.py).  The wgmma producer loads Q as one 4-D box
// of T tokens x g heads, T g 128-byte rows a column chunk, the bytes its
// barrier expects (TMA fills zeros past B Tq; at T g < 128 the chunk's
// last rows keep what they held, and a row of S = Q K^T is its own Q
// row's alone); the tiled core copies Q^T's rows through the same walk
// and zeroes the rest; neither writes a row past the CTA's tokens
// (consume skips a null row).  A stage masks nothing when its pages are
// live and at or before the CTA's first position, p0 + t0.
// At that cohort 752 CTAs of 128 rows (one partial group a lane; the
// causal diagonal 128 tokens wide instead of 16): 0.240 ms in bf16
// against flash_rows' 20.73 in the same run and a gather + SDPA of 0.725
// (0.18 of the bound, row 20's softmax its limit; at D = 128 every stage
// takes the masked path), and on another cohort (592 CTAs) 1.540 ms in
// f32 against 17.28 and a gather + SDPA f32 of 3.98 (0.35 of the bound;
// H100 80GB HBM3, 700.00 W; chip_smoke.py phase 7d).  At Qwen2.5-14B's
// cohort (Hkv 8, g 5, the same lanes' shapes) 1,264 CTAs of 25 tokens:
// 0.373 ms in bf16 (0.24 of its 0.0885 ms bound) against flash_rows'
// 15.63 on the same cohort (1,928 CTAs of 80 rows, each in two passes of
// 64) and a gather + SDPA of 1.366; f32 on another cohort 3.913 ms (0.47
// of its bound) against 20.92 and 16.75 (chip_smoke.py phase 7e).
//
// The latent core (lat::, below) runs sfc_flash_decode and sfc_flash_prefill
// for MLA (DeepSeek-V2's absorbed-weight attention, models/attention.py::
// mla_decode_paged / mla_prefill_paged): the same TPU kernels,
// _flash_decode_kernel and _flash_prefill_kernel, at Hkv = 1, g = 128
// query heads of D = 576 (c_kv 512 + k_rope 64) in f32 over one latent pool
// in bf16 (or f32) given as both K and V.  The wrapper picks it
// (kernels/attention.py::is_latent: one kv head, an f32 q, one pool); the
// entries launch it for that core's code or refuse the call.  Each 1,152-byte
// pool row is read by 128 heads: 4 g D = 294,912 FP32 operations a row, 256
// a byte, far above the ridge of ~20 (67 TFLOP/s over 3.35 TB/s), so the
// bound is the FP32 pipes (TF32 stays off; a bf16 tensor-core product would
// change the numbers).  A CTA of 8 warps takes 32 query rows (a row block
// of the slot's heads in decode, of the run's ps g rows in prefill), 4 a
// warp from end to end, and walks the kv rows in stages of 32, the online
// softmax's step.  A first form of this core kept Q^T and one f32 stage
// in shared memory and gave a thread 4 scores of S = Q K^T: 5 LDS.128 a
// warp for 16 FFMA, the stage loaded and converted behind four barriers a
// stage, 140.0 ms at chip_smoke.py's prefill cohort against a 27.7 ms
// bound (0.20).  This core takes q off shared memory: a lane holds its warp's 4 rows on
// its slice of 18 d in registers, and S runs as a systolic chain along the
// warp (lane l takes kv row t - l at step t and continues the chains lane
// l - 1 ran one step before, over its slice, d ascending: each score is
// still one fmaf chain over d from 0), so a fma costs a quarter of a shared
// load and the q operand none; P V holds 4 rows x 18 columns a lane.  The
// pool's rows land as stored by 16-byte cp.async in a ring of three
// stages, issued two stages ahead, one CTA barrier a stage; rows, scores
// and sums never leave their warp.  Decode is split-KV as the split core
// (splits of 128 kv rows, dec::walk_steps, the same f32 workspace) and its
// merge takes 8 rows a CTA.  One CTA an SM (217 / 240 registers, no
// spill; 116,224 B of shared memory for a bf16 pool, 226,816 for f32).
// At chip_smoke.py's shapes (8 slots, pools of 16-row pages) prefill takes
// 67.1-67.5 ms against the 27.7 ms bound (0.41), decode 0.20-0.23 ms a
// call by CUDA events with 0.135 ms of device time (split 0.104, merge
// 0.031 a launch; 180 live split CTAs, 1.36 waves), where a page gather +
// SDPA in f32 with the heads folded into the query axis takes 118.0-118.7
// and 0.77-0.91 (NVIDIA H100 80GB HBM3, 700.00 W).  What bounds it now: the issue slots.  A step of
// S issues 72 FFMA beside ~50 other instructions (9 shared loads, 18
// bf16-to-f32 conversions, 4 shuffles, the ring row, lane 31's store), a
// row of P V 72 beside ~34, and S runs at ~0.7 of even that rate with 2
// warps a scheduler; a skew of two rows a lane (the shuffles off the
// chain's path, two rows a step) measured slower.
#include <climits>
#include <cmath>
#include <cstddef>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "kernel_info.cuh"
#include "wgmma_gemm.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TK = 64;                // kv rows staged per shared-memory tile
constexpr int MAX_D = 128;            // head widths Dk, Dv the kernels take
constexpr int ND = MAX_D / 32;        // output columns per lane
constexpr int MAX_ROWS = 256;         // query rows per CTA
constexpr float MASK = (float)(-0.7 * 3.4028234663852886e38);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ __forceinline__ int k_stride(int dk) { return dk + 4; }
__host__ __device__ __forceinline__ int v_stride(int dv) { return (dv + 3) / 4 * 4 + 4; }

// shared memory of one CTA: Q rows of a pass, one K and one V tile (f32),
// each warp's probabilities, and the tile's row offsets and positions
size_t smem_bytes(int pass_rows, int dk, int dv) {
  const size_t floats = (size_t)pass_rows * k_stride(dk) + (size_t)TK * k_stride(dk) +
                        (size_t)TK * v_stride(dv) + (size_t)pass_rows * 32;
  return 4 * floats + 2 * sizeof(size_t) * TK + sizeof(int) * TK;
}

// ---------------------------------------------------------------------------
// the three walks: which query rows a CTA owns and which kv rows it visits
// ---------------------------------------------------------------------------

// sfc_flash_attention: rows of q tile qt of sequence bh; kv rows of the
// run's tiles in table order
struct DenseWalk {
  const int* sched;
  int start, bh, S, D, bq, bkv, qt, klim, nkv;
  bool causal;

  __device__ DenseWalk(const int* sched_, const int* runs, int S_, int D_, int bq_, int bkv_,
                       int causal_, int kv_valid, const int* seqlen)
      : sched(sched_), S(S_), D(D_), bq(bq_), bkv(bkv_), causal(causal_ != 0) {
    start = runs[2 * blockIdx.x];
    nkv = runs[2 * blockIdx.x + 1] * bkv;
    bh = blockIdx.y;
    qt = sched[4 * start];
    klim = INT_MAX;
    if (kv_valid >= 0) klim = kv_valid;
    if (seqlen != nullptr) klim = min(klim, seqlen[bh]);
  }
  __device__ int rows() const { return bq; }
  __device__ size_t q_off(int r) const { return ((size_t)bh * S + (size_t)qt * bq + r) * D; }
  __device__ size_t o_off(int r) const { return q_off(r); }
  __device__ int qlim(int r) const { return causal ? qt * bq + r : INT_MAX; }
  __device__ void kv(int f, size_t& ko, size_t& vo, int& pos) const {
    const int t = f / bkv;
    pos = sched[4 * (start + t) + 1] * bkv + (f - t * bkv);
    ko = vo = ((size_t)bh * S + pos) * D;
  }
};

// sfc_flash_prefill: the (token, head) rows of the CTA's tokens t0 ..
// t0 + tokens - 1 of slot, kv head h; kv rows of the walk's pages in
// table order.  The SIMT core's runs (ctas == false) are (first row,
// rows), one q tile of ps tokens each (t0 = its qt ps from the table);
// the wgmma and tiled cores' (ctas == true) are (first row, rows, t0,
// tokens) of a table of CTAs of T = 128 / g tokens (kernels/attention.py::
// prefill_cta_schedule), each walking the pages of its last new token,
// which cover every earlier token's (those rows see the later pages
// masked by position: zero added to a finite state).
struct PrefillWalk {
  const int* sched;
  const int* table;
  int start, slot, t0, tokens, h, hkv, tq, g, dk, dv, ps, mp, p0, nkv;
  static constexpr int klim = INT_MAX;

  __device__ PrefillWalk(const int* sched_, const int* runs, bool ctas, const int* table_,
                         const int* pos0, int tq_, int g_, int dk_, int dv_, int ps_, int mp_)
      : sched(sched_), table(table_), tq(tq_), g(g_), dk(dk_), dv(dv_), ps(ps_), mp(mp_) {
    const int* run = runs + (ctas ? 4 : 2) * blockIdx.x;
    start = run[0];
    nkv = run[1] * ps;
    h = blockIdx.y;
    hkv = gridDim.y;
    slot = sched[6 * start];
    t0 = ctas ? run[2] : sched[6 * start + 1] * ps;
    tokens = ctas ? run[3] : ps;
    p0 = pos0[slot];
  }
  // the rows of the tokens the CTA writes: a slot's last CTA may hold
  // fewer than T, and T g may fall short of 128 (125 rows at g = 5); the
  // CTA's further rows are never written (the tiled core zeroes them, the
  // wgmma core's Q box reads them, zeros past B Tq, or leaves the rows
  // past T g as they were: a row of S is its own Q row's alone)
  __device__ int rows() const { return tokens * g; }
  __device__ size_t row(int r) const {
    const int tok = t0 + r / g;
    return (((size_t)slot * tq + tok) * hkv + h) * g + (r % g);
  }
  __device__ size_t q_off(int r) const { return row(r) * dk; }
  __device__ size_t o_off(int r) const { return row(r) * dv; }
  __device__ int qlim(int r) const { return p0 + t0 + r / g; }
  // page t of the run: its logical page lp and its physical page
  __device__ void page(int t, int& lp, int& phys) const {
    lp = sched[6 * (start + t) + 2];
    phys = table[(size_t)slot * mp + lp];
  }
  __device__ void kv(int f, size_t& ko, size_t& vo, int& pos) const {
    const int t = f / ps, off = f - t * ps;
    int lp, phys;
    page(t, lp, phys);
    const size_t r = ((size_t)phys * ps + off) * hkv + h;
    pos = lp * ps + off;
    ko = r * dk;
    vo = r * dv;
  }
};

// ---------------------------------------------------------------------------
// the shared online-softmax routine
// ---------------------------------------------------------------------------

// Each warp owns RW query rows of a pass of WARPS * RW rows.  For every
// 32-row chunk of the staged kv tile, lane j scores kv row j against the
// warp's rows, the warp reduces (max, sum) per row and updates (m, l,
// acc); lane j then owns output columns j, j + 32, j + 64, j + 96.  A kv
// position is kept where pos <= qlim(row) and pos < klim, else its score
// is MASK; kv rows past the walk's end score -inf (they do not exist).
template <typename T, int RW, typename Walk>
__device__ void flash_rows(const Walk& w, const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int dk, int dv, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int PASS = WARPS * RW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qs = k_stride(dk), vs = v_stride(dv);
  float* Qs = smem;
  float* Ks = Qs + PASS * qs;
  float* Vs = Ks + TK * qs;
  float* Ps = Vs + TK * vs;
  size_t* Koff = reinterpret_cast<size_t*>(Ps + PASS * 32);
  size_t* Voff = Koff + TK;
  int* Kpos = reinterpret_cast<int*>(Voff + TK);
  const int R = w.rows(), nkv = w.nkv;

  for (int r0 = 0; r0 < R; r0 += PASS) {
    __syncthreads();  // the previous pass is done with Qs
    for (int idx = threadIdx.x; idx < PASS * dk; idx += THREADS) {
      const int r = idx / dk, d = idx - r * dk;
      Qs[r * qs + d] = r0 + r < R ? to_f32(q[w.q_off(r0 + r) + d]) : 0.f;
    }
    float m[RW], l[RW], acc[RW][ND];
    int lim[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = r0 + warp * RW + i;
      m[i] = -INFINITY;
      l[i] = 0.f;
      lim[i] = r < R ? w.qlim(r) : INT_MAX;
#pragma unroll
      for (int c = 0; c < ND; ++c) acc[i][c] = 0.f;
    }

    for (int f0 = 0; f0 < nkv; f0 += TK) {
      __syncthreads();  // the previous tile is consumed (and Qs is staged)
      if (threadIdx.x < TK) {
        const int f = f0 + threadIdx.x;
        size_t ko = 0, vo = 0;
        int pos = -1;
        if (f < nkv) w.kv(f, ko, vo, pos);
        Koff[threadIdx.x] = ko;
        Voff[threadIdx.x] = vo;
        Kpos[threadIdx.x] = pos;
      }
      __syncthreads();
      const int nrows = min(TK, nkv - f0);
      for (int idx = threadIdx.x; idx < TK * dk; idx += THREADS) {
        const int j = idx / dk, d = idx - j * dk;
        Ks[j * qs + d] = j < nrows ? to_f32(k[Koff[j] + d]) : 0.f;
      }
      for (int idx = threadIdx.x; idx < TK * dv; idx += THREADS) {
        const int j = idx / dv, d = idx - j * dv;
        Vs[j * vs + d] = j < nrows ? to_f32(v[Voff[j] + d]) : 0.f;
      }
      __syncthreads();

      for (int c0 = 0; c0 < nrows; c0 += 32) {
        const int j = c0 + lane;
        const int kp = Kpos[j];
        float s[RW];
#pragma unroll
        for (int i = 0; i < RW; ++i) s[i] = 0.f;
        const float* kr = Ks + j * qs;
        for (int d = 0; d < dk; d += 4) {
          const float4 kv4 = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
          for (int i = 0; i < RW; ++i) {
            const float4 q4 = *reinterpret_cast<const float4*>(Qs + (warp * RW + i) * qs + d);
            s[i] = fmaf(q4.x, kv4.x, s[i]);
            s[i] = fmaf(q4.y, kv4.y, s[i]);
            s[i] = fmaf(q4.z, kv4.z, s[i]);
            s[i] = fmaf(q4.w, kv4.w, s[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          float sc = -INFINITY;
          if (kp >= 0) sc = (kp <= lim[i] && kp < w.klim) ? s[i] * scale : MASK;
          const float mn = fmaxf(m[i], warp_max(sc));
          const float p = expf(sc - mn);
          const float alpha = expf(m[i] - mn);
          l[i] = alpha * l[i] + warp_sum(p);
#pragma unroll
          for (int c = 0; c < ND; ++c) acc[i][c] *= alpha;
          m[i] = mn;
          Ps[(warp * RW + i) * 32 + lane] = p;
        }
        __syncwarp();
        const int jn = min(32, nrows - c0);
        for (int jj = 0; jj < jn; ++jj) {
          const float* vr = Vs + (c0 + jj) * vs;
          float vv[ND];
#pragma unroll
          for (int c = 0; c < ND; ++c) {
            const int d = lane + 32 * c;
            vv[c] = d < dv ? vr[d] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < RW; ++i) {
            const float p = Ps[(warp * RW + i) * 32 + jj];
#pragma unroll
            for (int c = 0; c < ND; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
          }
        }
        __syncwarp();  // Ps is rewritten by the next chunk
      }
    }

#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = r0 + warp * RW + i;
      if (r >= R) continue;
      T* orow = o + w.o_off(r);
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        const int d = lane + 32 * c;
        if (d < dv) store(orow + d, acc[i][c] / l[i]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// kernels and launchers
// ---------------------------------------------------------------------------

template <typename T, int RW>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* q, const T* k, const T* v, T* o, const int* sched, const int* runs,
                       int S, int D, int bq, int bkv, int causal, int kv_valid, const int* seqlen,
                       float scale) {
  const DenseWalk w(sched, runs, S, D, bq, bkv, causal, kv_valid, seqlen);
  flash_rows<T, RW>(w, q, k, v, o, D, D, scale);
}

template <typename T, int RW>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(const T* q, const T* kp, const T* vp, T* o, const int* sched, const int* runs,
                     const int* table, const int* pos0, int tq, int g, int dk, int dv, int ps, int mp,
                     float scale) {
  const PrefillWalk w(sched, runs, false, table, pos0, tq, g, dk, dv, ps, mp);
  flash_rows<T, RW>(w, q, kp, vp, o, dk, dv, scale);
}

using sfc::raise_smem_limit;

// one launch of kernel Kern over (runs, heads) CTAs with `smem` bytes
template <auto Kern, int RW, typename... Args>
int launch(int runs, int heads, size_t smem, void* stream, Args... args) {
  if (runs == 0 || heads == 0) return 0;
  if (heads > 65535) return (int)cudaErrorInvalidConfiguration;
  // passes of RW * WARPS query rows at Dk = Dv = MAX_D: the most a launch asks for
  const cudaError_t err = raise_smem_limit<Kern>((int)smem_bytes(RW * WARPS, MAX_D, MAX_D));
  if (err != cudaSuccess) return (int)err;
  Kern<<<dim3(runs, heads), THREADS, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

bool bad_shape(int rows, int dk, int dv) {
  return rows < 1 || rows > MAX_ROWS || dk < 4 || dk > MAX_D || dk % 4 || dv < 1 || dv > MAX_D;
}

// query blocks of up to 8 rows take one row per warp, larger ones 8
template <typename T>
int attention_t(const void* q, const void* k, const void* v, void* o, const void* sched,
                const void* runs, int n_runs, int BH, int S, int D, int bq, int bkv, int causal,
                int kv_valid, const void* seqlen, float scale, void* stream) {
  if (bq > WARPS)
    return launch<flash_attention_kernel<T, 8>, 8>(
        n_runs, BH, smem_bytes(8 * WARPS, D, D), stream, (const T*)q, (const T*)k, (const T*)v,
        (T*)o, (const int*)sched, (const int*)runs, S, D, bq, bkv, causal, kv_valid,
        (const int*)seqlen, scale);
  return launch<flash_attention_kernel<T, 1>, 1>(
      n_runs, BH, smem_bytes(WARPS, D, D), stream, (const T*)q, (const T*)k, (const T*)v, (T*)o,
      (const int*)sched, (const int*)runs, S, D, bq, bkv, causal, kv_valid, (const int*)seqlen,
      scale);
}

template <typename T>
int prefill_t(const void* q, const void* kp, const void* vp, void* o, const void* sched,
              const void* runs, int n_runs, int hkv, const void* table, const void* pos0, int tq,
              int g, int dk, int dv, int ps, int mp, float scale, void* stream) {
  if (ps * g > WARPS)
    return launch<flash_prefill_kernel<T, 8>, 8>(
        n_runs, hkv, smem_bytes(8 * WARPS, dk, dv), stream, (const T*)q, (const T*)kp,
        (const T*)vp, (T*)o, (const int*)sched, (const int*)runs, (const int*)table,
        (const int*)pos0, tq, g, dk, dv, ps, mp, scale);
  return launch<flash_prefill_kernel<T, 1>, 1>(
      n_runs, hkv, smem_bytes(WARPS, dk, dv), stream, (const T*)q, (const T*)kp, (const T*)vp,
      (T*)o, (const int*)sched, (const int*)runs, (const int*)table, (const int*)pos0, tq, g, dk,
      dv, ps, mp, scale);
}

// ---------------------------------------------------------------------------
// the register-tiled SIMT core: sfc_flash_attention in f32 at D = 64, 80
// or 128, bq = 128, bkv a multiple of 64; sfc_flash_prefill in f32 at Dk =
// Dv = 64 or 128, ps * g = 128 rows a CTA and pages of 4 to 64 rows
// ---------------------------------------------------------------------------

namespace tiled {

using sfc::cp_async4;
using sfc::cp_async16;
using sfc::cp_async_commit;
using sfc::cp_async_wait;

constexpr int BQ = 128;       // query rows of a CTA, all in one pass
constexpr int KV = 64;        // kv rows of a ring stage
constexpr int STAGES = 2;     // ring stages
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LDQ = BQ + 4;   // Q^T's row stride, [d][row]
constexpr unsigned FULL = 0xffffffffu;
// prefill: a thread's 4 kv columns lie in one page (ps % 4 == 0), so a
// stage holds at most KV / 4 pages.  A stage's page facts: its largest
// position (INT_MAX unless every page is live), then each page's logical
// page (-1 past the run's end) and physical page.  Three stages' facts are
// kept: the masks read stage i's, the copies stage i + 1's, and warp 0
// publishes stage i + 2's.
constexpr int PAGE_MIN = 4;
constexpr int MAX_PAGES = KV / PAGE_MIN;
constexpr int FACTS = 1 + 2 * MAX_PAGES;
constexpr int FACT_SLOTS = 3;

// Shared memory at head width D, in floats: Q^T [d][row + pad] (copied
// once), P [kv][row] (each warp's 16 rows), then the ring's stages of K^T
// [d][kv] and V [kv][d].  K^T and P keep 16-byte chunks XOR-swizzled
// (chunk c of row x at c ^ (x & 7), x = d for K^T, kv / 4 for P), so
// 4-byte copies into K^T and the float4 writes of P hit 32 banks and the
// fragment reads stay conflict-free LDS.128s: 132,096 B at D = 64,
// 156,928 B at D = 80, 231,424 B at D = 128, one CTA an SM; prefill adds
// its page facts after the ring (396 B).
template <int D>
struct Layout {
  static constexpr int Q_FLOATS = D * LDQ;
  static constexpr int P_FLOATS = KV * BQ;
  static constexpr int K_FLOATS = D * KV;
  static constexpr int STAGE_FLOATS = K_FLOATS + KV * D;
  static constexpr int SMEM = 4 * (Q_FLOATS + P_FLOATS + STAGES * STAGE_FLOATS);
  static constexpr int PREFILL_SMEM = SMEM + 4 * FACT_SLOTS * FACTS;
};

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// Row 20's stages: KV consecutive positions of one table tile (bkv % KV ==
// 0), rows D apart in K and V.
template <int D>
struct DenseStages {
  static constexpr bool RAGGED = false;
  DenseWalk w;
  int n;

  __device__ DenseStages(const int* sched, const int* runs, int S, int bkv, int causal,
                         int kv_valid, const int* seqlen)
      : w(sched, runs, S, D, BQ, bkv, causal, kv_valid, seqlen), n(w.nkv / KV) {}
  __device__ void start() {}
  __device__ void lookup(int) {}
  __device__ void publish(int) {}

  // the element offset of stage i's kv row x in K and V
  struct Rows {
    size_t base;
    __device__ size_t operator()(int x) const { return base + (size_t)x * D; }
  };
  __device__ Rows rows(int i) const {
    size_t ko, vo;
    int pos;
    w.kv(i * KV, ko, vo, pos);
    return {ko};
  }
  // stage i's kv positions: column 4 c + j at pos + 4 c + j; the stage
  // masks nothing when all lie below klim and (causal) at or before the
  // CTA's first query row
  struct Cols {
    int pos;
    bool all;
    __device__ bool plain() const { return all; }
    __device__ int col(int c) const { return pos + 4 * c; }
  };
  __device__ Cols cols(int i) const {
    size_t ko, vo;
    int pos;
    w.kv(i * KV, ko, vo, pos);
    return {pos, pos + KV - 1 < w.klim && pos + KV - 1 <= w.qlim(0)};
  }
};

// Row 22's stages: KV / ps whole pages of kv head h, page t of the run in
// table order at rows t ps .. t ps + ps - 1 of stage t / (KV / ps); a page
// is ps rows Hkv D apart in the pool (P, ps, Hkv, D).  Warp 0 looks a
// stage's pages up through the page table (PrefillWalk::page) two stages
// ahead, lane t page t: the loads are issued after the copies of stage i +
// 1 and published in shared memory after stage i's arithmetic, so their
// latency hides behind it and the next CTA barrier orders the writes
// before every reader (the slot rewritten was last read in stage i - 1).
// The slots of pages past the run's end re-read its last page (V stays
// finite) and score -inf.
template <int D>
struct PagedStages {
  static constexpr bool RAGGED = true;
  PrefillWalk w;
  int n, per, lg, pages;
  int* facts;
  int lp, phys;  // warp 0, lane t < per: page t of the stage being looked up

  __device__ PagedStages(const int* sched, const int* runs, const int* table, const int* pos0, int tq,
                         int g, int ps, int mp, int* facts_)
      : w(sched, runs, true, table, pos0, tq, g, D, D, ps, mp), facts(facts_), lp(-1), phys(0) {
    per = KV / ps;
    lg = __ffs(ps) - 1;
    pages = w.nkv / ps;
    n = (pages + per - 1) / per;
  }
  __device__ void lookup(int i) {
    if (threadIdx.x >= 32 || i >= n) return;
    const int lane = threadIdx.x;
    lp = -1;
    if (lane < per) {
      const int t = i * per + lane;
      int l;
      w.page(min(t, pages - 1), l, phys);
      if (t < pages) lp = l;
    }
  }
  __device__ void publish(int i) {
    if (threadIdx.x >= 32 || i >= n) return;
    const int lane = threadIdx.x;
    const bool all = __all_sync(FULL, lane >= per || lp >= 0);
    int top = lp >= 0 ? lp * w.ps + w.ps - 1 : -1;
#pragma unroll
    for (int o = 16; o; o >>= 1) top = max(top, __shfl_xor_sync(FULL, top, o));
    int* f = facts + (i % FACT_SLOTS) * FACTS;
    if (lane < per) {
      f[1 + lane] = lp;
      f[1 + MAX_PAGES + lane] = phys;
    }
    if (lane == 0) f[0] = all ? top : INT_MAX;
  }
  // stages 0 and 1 before the first copy
  __device__ void start() {
    lookup(0);
    publish(0);
    lookup(1);
    publish(1);
    __syncthreads();
  }

  struct Rows {
    const int* phys;
    size_t page, row, head;  // ps Hkv D, Hkv D, h D
    int lg, off;             // log2 ps, ps - 1
    __device__ size_t operator()(int x) const {
      return (size_t)phys[x >> lg] * page + (size_t)(x & off) * row + head;
    }
  };
  __device__ Rows rows(int i) const {
    const size_t row = (size_t)w.hkv * D;
    return {facts + (i % FACT_SLOTS) * FACTS + 1 + MAX_PAGES, row << lg, row, (size_t)w.h * D, lg,
            w.ps - 1};
  }
  // column 4 c + j of a live page lp at lp ps + (4 c mod ps) + j, -1 for a
  // slot past the run's end; the stage masks nothing when every page is
  // live and at or before the CTA's first query position (qlim rises with
  // the row)
  struct Cols {
    const int* lp;
    int top, first, lg, ps;
    __device__ bool plain() const { return top <= first; }
    __device__ int col(int c) const {
      const int l = lp[(4 * c) >> lg];
      return l < 0 ? -1 : l * ps + ((4 * c) & (ps - 1));
    }
  };
  __device__ Cols cols(int i) const {
    const int* f = facts + (i % FACT_SLOTS) * FACTS;
    return {f + 1, f[0], w.qlim(0), lg, w.ps};
  }
};

// One CTA: the 128 query rows of the walk (St::w) in one pass, its kv rows
// KV a stage (St: which rows, which positions).  Warp w owns query rows 16
// w .. 16 w + 15; lane (h, c) = (lane / 16, lane % 16) owns rows rb .. rb
// + 7 (rb = 16 w + 8 h): scores of kv columns 4 c .. 4 c + 3 of each
// stage, output columns 64 q + 4 c .. + 3 (and 64 + c at D = 80).  Per
// stage: S = Q K^T on the 8 x 4 register tile (each score the fmaf chain
// over d ascending from 0, as flash_rows'), the masks, the online softmax (a row's maximum by 4
// shuffles among the 16 lanes that share it, its sum kept per thread until
// the end), P into the warp's rows of shared memory, O += P V on the 8 x D
// / 16 register tile.  The next K / V stage is copied while this one is
// used.
template <int D, typename St>
__device__ __forceinline__ void tiled_core(St& st, const float* __restrict__ q,
                                           const float* __restrict__ k, const float* __restrict__ v,
                                           float* __restrict__ o, float scale, float* smem) {
  using L = Layout<D>;
  constexpr int NQ = D / 64;       // float4 output columns a thread: 4 c + 64 q
  constexpr bool TAIL = D % 64 != 0;  // and at D = 80 one more: 64 NQ + c
  static_assert(D % 64 == 0 || D % 64 == 16, "tiled_core: D = 64 q or 64 q + 16");
  constexpr int NA = 4 * NQ + TAIL;
  float* Qs = smem;
  float* Ps = Qs + L::Q_FLOATS;
  float* ring = Ps + L::P_FLOATS;
  const auto& w = st.w;
  const int n = st.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = lane >> 4, c = lane & 15;
  const int rb = 16 * warp + 8 * h;
  const int xq = rb >> 2;  // the first of the thread's two float4 chunks of rows

  // Q^T, once: a warp copies 8 d x 4 rows at a time (one 32-byte sector a
  // row; banks 4 d + row with the stride BQ + 4); the rows past the walk's
  // (a partial group's) are zeros, never loaded
  const int live_rows = w.rows();
  {
#pragma unroll 4
    for (int u = warp; u < (D / 8) * (BQ / 4); u += WARPS) {
      const int d = (u % (D / 8)) * 8 + (lane & 7), r = (u / (D / 8)) * 4 + (lane >> 3);
      if (r < live_rows)
        cp_async4(Qs + d * LDQ + r, q + w.q_off(r) + d);
      else
        Qs[d * LDQ + r] = 0.f;
    }
    cp_async_commit();
  }
  st.start();
  // stage i into ring slot i % STAGES: K^T by 4-byte copies (8 d x the 4
  // kv rows of one chunk a warp copy), V as stored by 16-byte copies
  auto issue = [&](int i) {
    const auto row = st.rows(i);
    float* ks = ring + (i % STAGES) * L::STAGE_FLOATS;
    float* vs = ks + L::K_FLOATS;
#pragma unroll 4
    for (int u = warp; u < (D / 8) * (KV / 4); u += WARPS) {
      const int d = (u % (D / 8)) * 8 + (lane & 7), x = u / (D / 8);
      cp_async4(ks + d * KV + ((x ^ (d & 7)) << 2) + (lane >> 3), k + row(4 * x + (lane >> 3)) + d);
    }
#pragma unroll
    for (int id = threadIdx.x; id < KV * D / 4; id += THREADS) {
      const int r = id / (D / 4), c4 = id % (D / 4);
      cp_async16(vs + r * D + 4 * c4, v + row(r) + 4 * c4);
    }
  };

  float m[8], l[8], acc[8][NA];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NA; ++j) acc[i][j] = 0.f;
  }
  if (n > 0) issue(0);
  cp_async_commit();

  for (int i = 0; i < n; ++i) {
    cp_async_wait<0>();  // this thread's copies of stage i (and Q) have landed
    __syncthreads();     // everyone's; everyone is done with stage i - 1's slot
    if (i + 1 < n) issue(i + 1);
    cp_async_commit();
    st.lookup(i + 2);
    const float* ks = ring + (i % STAGES) * L::STAGE_FLOATS;
    const float* vs = ks + L::K_FLOATS;

    // S = Q K^T: per d, two LDS.128 of Q (broadcast to the 16 lanes of a
    // row group) and one of K^T for 32 FMAs; step d + 1's fragments are
    // read while step d's FMAs issue
    float s[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
    float fq[2][8], fk[2][4];
    // d's fragments; sw = d & 7, known where the loop is unrolled
    auto frag = [&](int d, int sw, float (&a)[8], float (&b)[4]) {
      const float4 q0 = ld4(Qs + d * LDQ + rb), q1 = ld4(Qs + d * LDQ + rb + 4);
      const float4 k0 = ld4(ks + d * KV + ((c ^ sw) << 2));
      a[0] = q0.x, a[1] = q0.y, a[2] = q0.z, a[3] = q0.w;
      a[4] = q1.x, a[5] = q1.y, a[6] = q1.z, a[7] = q1.w;
      b[0] = k0.x, b[1] = k0.y, b[2] = k0.z, b[3] = k0.w;
    };
    frag(0, 0, fq[0], fk[0]);
#pragma unroll 1
    for (int d0 = 0; d0 < D; d0 += 8) {
#pragma unroll
      for (int dd = 0; dd < 8; ++dd) {
        if (dd < 7 || d0 + 8 < D) frag(d0 + dd + 1, (dd + 1) & 7, fq[(dd + 1) & 1], fk[(dd + 1) & 1]);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[r][j] = fmaf(fq[dd & 1][r], fk[dd & 1][j], s[r][j]);
      }
    }

    // masks: kv position kp is kept where kp <= qlim(row) and kp < klim,
    // else scored MASK; a column past the walk's end (ragged stages)
    // scores -inf
    const auto cols = st.cols(i);
    if (cols.plain()) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] *= scale;
    } else {
      const int kb = cols.col(c);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int lim = w.qlim(rb + r);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kp = kb + j;
          float sc = (kp <= lim && kp < w.klim) ? s[r][j] * scale : MASK;
          if constexpr (St::RAGGED) sc = kb < 0 ? -INFINITY : sc;
          s[r][j] = sc;
        }
      }
    }

    // the online softmax on the thread's rows; P to shared memory as
    // [kv][row], the thread's 8 rows of kv column 4 c + j two float4s
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
#pragma unroll
      for (int off = 8; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float mn = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[r][j] = expf(s[r][j] - mn);
        ps += s[r][j];
      }
      l[r] = alpha * l[r] + ps;
#pragma unroll
      for (int j = 0; j < NA; ++j) acc[r][j] *= alpha;
      m[r] = mn;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* prow = Ps + (4 * c + j) * BQ;
      const int f = c & 7;  // ((4 c + j) >> 2) & 7
      *reinterpret_cast<float4*>(prow + ((xq ^ f) << 2)) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(prow + (((xq + 1) ^ f) << 2)) = make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
    __syncwarp();  // the warp's P is written

    // O += P V: per kv row, two LDS.128 of P (broadcast) and NQ of V for
    // 32 NQ FMAs; at D = 80 one more LDS.32 of V (the 16 lanes of a row
    // group read 16 consecutive floats) for 8
#pragma unroll 1
    for (int j0 = 0; j0 < KV; j0 += 32) {
#pragma unroll
      for (int jj = 0; jj < 32; ++jj) {
        const int j = j0 + jj;
        const int f = (jj >> 2) & 7;  // (j >> 2) & 7, j0 a multiple of 32
        const float4 p0 = ld4(Ps + j * BQ + ((xq ^ f) << 2));
        const float4 p1 = ld4(Ps + j * BQ + (((xq + 1) ^ f) << 2));
        const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int qq = 0; qq < NQ; ++qq) {
          const float4 v4 = ld4(vs + j * D + 64 * qq + 4 * c);
          const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int jj4 = 0; jj4 < 4; ++jj4)
              acc[r][4 * qq + jj4] = fmaf(p[r], vv[jj4], acc[r][4 * qq + jj4]);
        }
        if constexpr (TAIL) {
          const float vt = vs[j * D + 64 * NQ + c];
#pragma unroll
          for (int r = 0; r < 8; ++r) acc[r][4 * NQ] = fmaf(p[r], vt, acc[r][4 * NQ]);
        }
      }
    }
    __syncwarp();  // the warp is done with P before the next stage rewrites it
    st.publish(i + 2);
  }
  cp_async_wait<0>();

  // a row's sum over its 16 lanes; O = acc / l, float4 stores (the
  // walk's rows only)
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float lt = l[r];
#pragma unroll
    for (int off = 8; off; off >>= 1) lt += __shfl_xor_sync(FULL, lt, off);
    if (rb + r >= live_rows) continue;
    float* orow = o + w.o_off(rb + r);
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq)
      *reinterpret_cast<float4*>(orow + 64 * qq + 4 * c) =
          make_float4(acc[r][4 * qq] / lt, acc[r][4 * qq + 1] / lt, acc[r][4 * qq + 2] / lt,
                      acc[r][4 * qq + 3] / lt);
    if constexpr (TAIL) orow[64 * NQ + c] = acc[r][4 * NQ] / lt;
  }
}

// One CTA per (run, bh): the 128 query rows of q tile qt, the run's kv
// tiles in table order.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, const int* __restrict__ sched,
                   const int* __restrict__ runs, int S, int bkv, int causal, int kv_valid,
                   const int* __restrict__ seqlen, float scale) {
  extern __shared__ __align__(16) float smem[];
  DenseStages<D> st(sched, runs, S, bkv, causal, kv_valid, seqlen);
  tiled_core<D>(st, q, k, v, o, scale, smem);
}

// One CTA per (run, kv head h): the 128 rows of PrefillWalk (tokens t0
// .. t0 + 128 / g - 1 x the g query heads of h, row r = token g + head;
// rows past the tokens the CTA writes zero and unwritten), the walk's
// pages in table order, KV / ps pages a stage.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
prefill_tiled_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                     const float* __restrict__ vp, float* __restrict__ o,
                     const int* __restrict__ sched, const int* __restrict__ runs,
                     const int* __restrict__ table, const int* __restrict__ pos0, int tq, int g,
                     int ps, int mp, float scale) {
  extern __shared__ __align__(16) float smem[];
  PagedStages<D> st(sched, runs, table, pos0, tq, g, ps, mp,
                    reinterpret_cast<int*>(smem + Layout<D>::SMEM / 4));
  tiled_core<D>(st, q, kp, vp, o, scale, smem);
}

template <int D>
int attention(const void* q, const void* k, const void* v, void* o, const void* sched,
              const void* runs, int n_runs, int BH, int S, int bkv, int causal, int kv_valid,
              const void* seqlen, float scale, void* stream) {
  if (n_runs == 0 || BH == 0) return 0;
  if (BH > 65535) return (int)cudaErrorInvalidConfiguration;
  // 16-byte copies of V, float4 stores of O
  if ((uintptr_t)v % 16 || (uintptr_t)o % 16) return (int)cudaErrorInvalidValue;
  const cudaError_t err = raise_smem_limit<flash_tiled_kernel<D>>(Layout<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_tiled_kernel<D><<<dim3(n_runs, BH), THREADS, Layout<D>::SMEM, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (const int*)sched,
      (const int*)runs, S, bkv, causal, kv_valid, (const int*)seqlen, scale);
  return (int)cudaGetLastError();
}

template <int D>
int prefill(const void* q, const void* kp, const void* vp, void* o, const void* sched,
            const void* runs, int n_runs, int hkv, const void* table, const void* pos0, int tq,
            int g, int ps, int mp, float scale, void* stream) {
  if (n_runs == 0 || hkv == 0) return 0;
  if (hkv > 65535) return (int)cudaErrorInvalidConfiguration;
  // 16-byte copies of V, float4 stores of O; K's pool beside V's
  if ((uintptr_t)kp % 16 || (uintptr_t)vp % 16 || (uintptr_t)o % 16) return (int)cudaErrorInvalidValue;
  const cudaError_t err = raise_smem_limit<prefill_tiled_kernel<D>>(Layout<D>::PREFILL_SMEM);
  if (err != cudaSuccess) return (int)err;
  prefill_tiled_kernel<D><<<dim3(n_runs, hkv), THREADS, Layout<D>::PREFILL_SMEM, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)kp, (const float*)vp, (float*)o, (const int*)sched,
      (const int*)runs, (const int*)table, (const int*)pos0, tq, g, ps, mp, scale);
  return (int)cudaGetLastError();
}

}  // namespace tiled

// ---------------------------------------------------------------------------
// sfc_flash_decode: split-KV over each slot's pages, then a merge
// ---------------------------------------------------------------------------

namespace dec {

constexpr int GR = 8;              // query rows of a CTA: a row group of g
constexpr int MAX_WARPS = 4;       // a warp walks 32 kv rows a round
constexpr int MERGE_THREADS = 256;
constexpr int SMEM_CAP = 227 * 1024;  // the H100's dynamic shared memory a CTA

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// A split CTA's shared memory at element size es (bytes), Dk, Dv, page
// size ps and split_pages pages a split.  A warp walks chunks of 32 kv
// rows (warp w the split's chunks w, w + warps, ...) through a ring of
// `stages` slots of its own (K and V as stored, 16-byte units a row, K's
// stride an odd number of units so the 8 lanes of a 16-byte read phase hit
// 8 distinct bank groups): two slots when a warp has more than one chunk
// and they fit, else one.  Then Q's GR rows in f32, zero past Dk, and each
// warp's GR x 32 probabilities.  After the walk the K/V space holds each
// warp's (acc, m, l) for the CTA's merge.
struct Geometry {
  int warps, stages, kunits, vunits, kstride, vstride, dkp;
  int v_off, q_off, p_off, bytes;

  __host__ __device__ Geometry(int es, int dk, int dv, int ps, int split_pages) {
    const int rows = split_pages * ps;
    warps = imin(MAX_WARPS, (rows + 31) / 32);
    kunits = (dk * es + 15) / 16;
    vunits = (dv * es + 15) / 16;
    kstride = (kunits | 1) * 16;
    vstride = vunits * 16;
    dkp = kunits * 16 / es;
    layout(rows > 32 * warps ? 2 : 1, dv);
    if (bytes > SMEM_CAP) layout(1, dv);
  }

  __host__ __device__ void layout(int st, int dv) {
    stages = st;
    const int slots = warps * stages * 32;  // rows of the K and V rings
    v_off = slots * kstride;
    q_off = imax(v_off + slots * vstride, warps * GR * (dv + 2) * 4);
    p_off = q_off + GR * dkp * 4;
    bytes = p_off + warps * GR * 32 * 4;
  }
};

// the number of a slot's table steps (pages) that a decode walks: up to
// its last live page, or every page when pos < 0
__device__ __forceinline__ int walk_steps(int p, int ps, int n) {
  return p >= 0 ? min(p / ps, n - 1) + 1 : n;
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// CTA (run * splits + split, kv head h, row group z): query rows z GR ..
// of the slot's group against table steps split * split_pages .. of the
// run, up to the slot's last live page.  VEC: K and V rows are whole
// 16-byte units from 16-byte aligned pools (cp.async), else staged an
// element a thread.  Lane j of a warp looks up row j of the warp's chunk
// (its pool row and position) and the warp's copies take each row's pool
// row from its lane by shuffle; a chunk's K and V are two cp.async groups,
// so the scores and the softmax run while V lands, and with two slots the
// warp's next chunk is in flight while this one is scored.  Writes the
// split's (acc, m, l) for each query row to ws[run, split, h, row] =
// (acc[0 .. Dv), m, l).
template <typename T, bool VEC>
__global__ void __launch_bounds__(MAX_WARPS * 32)
split_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
             float* __restrict__ ws, const int* __restrict__ sched, const int* __restrict__ runs,
             const int* __restrict__ table, const int* __restrict__ pos, int g, int dk, int dv,
             int ps, int mp, int split_pages, int splits, float scale) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* raw = smem_raw;
  constexpr int EPU = 16 / (int)sizeof(T);  // elements of a 16-byte unit
  constexpr unsigned FULL = 0xffffffffu;
  const Geometry geo((int)sizeof(T), dk, dv, ps, split_pages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int run = blockIdx.x / splits, split = blockIdx.x - run * splits;
  const int h = blockIdx.y, hkv = gridDim.y;
  const int r0 = blockIdx.z * GR, nr = min(GR, g - r0);
  const int start = runs[2 * run], n = runs[2 * run + 1];
  const int slot = sched[4 * start];
  const int t0 = split * split_pages;

  uint8_t* Kw = raw + warp * geo.stages * 32 * geo.kstride;  // the warp's ring slots
  uint8_t* Vw = raw + geo.v_off + warp * geo.stages * 32 * geo.vstride;
  float* Qs = reinterpret_cast<float*>(raw + geo.q_off);
  float* Ps = reinterpret_cast<float*>(raw + geo.p_off) + warp * GR * 32;

  // row 32 c + lane of the split, page t0 + f / ps of the walk (past the
  // run's last page, its last page again): its pool row and its position
  auto lookup = [&](int c, size_t& roff, int& rpos) {
    const int f = t0 * ps + 32 * c + lane;
    const int t = min(f / ps, n - 1), off = f - (f / ps) * ps;
    const int lp = sched[4 * (start + t) + 1];
    roff = ((size_t)table[(size_t)slot * mp + lp] * ps + off) * hkv + h;
    rpos = lp * ps + off;
  };
  // chunk rows 0 .. wrows - 1 into ring slot st: K, then V, a cp.async
  // group each (empty groups on the element path, which stores at once)
  auto issue = [&](int st, int wrows, size_t roff) {
    uint8_t* Ks = Kw + st * 32 * geo.kstride;
    uint8_t* Vs = Vw + st * 32 * geo.vstride;
    if (VEC) {
      for (int i = lane; i < 32 * geo.kunits; i += 32) {
        const int j = i / geo.kunits, u = i - j * geo.kunits;
        const size_t ro = __shfl_sync(FULL, roff, j);
        if (j < wrows) sfc::cp_async16(Ks + j * geo.kstride + u * 16, kp + ro * dk + u * EPU);
      }
      sfc::cp_async_commit();
      for (int i = lane; i < 32 * geo.vunits; i += 32) {
        const int j = i / geo.vunits, u = i - j * geo.vunits;
        const size_t ro = __shfl_sync(FULL, roff, j);
        if (j < wrows) sfc::cp_async16(Vs + j * geo.vstride + u * 16, vp + ro * dv + u * EPU);
      }
      sfc::cp_async_commit();
    } else {
      const int kw = geo.kunits * EPU, vw = geo.vunits * EPU;
      for (int i = lane; i < 32 * kw; i += 32) {
        const int j = i / kw, d = i - j * kw;
        const size_t ro = __shfl_sync(FULL, roff, j);
        T* dst = reinterpret_cast<T*>(Ks + j * geo.kstride) + d;
        if (j < wrows) {
          if (d < dk) *dst = kp[ro * dk + d];
          else store(dst, 0.f);  // Qs is zero there too, but 0 * garbage may be NaN
        }
      }
      for (int i = lane; i < 32 * vw; i += 32) {
        const int j = i / vw, d = i - j * vw;
        const size_t ro = __shfl_sync(FULL, roff, j);
        if (j < wrows && d < dv) reinterpret_cast<T*>(Vs + j * geo.vstride)[d] = vp[ro * dv + d];
      }
      sfc::cp_async_commit();
      sfc::cp_async_commit();
    }
  };

  // Q and the warp's first lookups do not wait for pos: they are in
  // flight together with it
  for (int i = threadIdx.x; i < GR * geo.dkp; i += blockDim.x) {
    const int r = i / geo.dkp, d = i - r * geo.dkp;
    Qs[i] = (r < nr && d < dk) ? to_f32(q[(((size_t)slot * hkv + h) * g + r0 + r) * dk + d]) : 0.f;
  }
  size_t roff;
  int rpos;
  lookup(warp, roff, rpos);
  const int p = pos[slot];
  const int steps = walk_steps(p, ps, n);
  if (t0 >= steps) return;  // wholly past the slot's last live page: no partial
  const int nkv = (min(t0 + split_pages, steps) - t0) * ps;
  const int chunks = (nkv + 31) / 32;

  float m[GR], l[GR], acc[GR][ND];
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[r][c] = 0.f;
  }
  if (warp < chunks) issue(0, min(32, nkv - 32 * warp), roff);
  __syncthreads();  // Qs is in place

  // warp w stages and reads only its own ring slots: no CTA barrier.  The
  // cp.async groups in flight at a chunk's first wait, oldest first: its
  // K, its V, the next chunk's K and V (empty when there is none, or when
  // one slot makes the next chunk wait for this one to be consumed)
  for (int c = warp, k = 0; c < chunks; c += geo.warps, ++k) {
    const int st = geo.stages == 2 ? (k & 1) : 0;
    const int wrows = min(32, nkv - 32 * c), kpos = rpos;
    const int cn = c + geo.warps;
    if (geo.stages == 2 && cn < chunks) {
      lookup(cn, roff, rpos);
      issue(st ^ 1, min(32, nkv - 32 * cn), roff);
    } else {
      sfc::cp_async_commit();
      sfc::cp_async_commit();
    }
    const uint8_t* Ks = Kw + st * 32 * geo.kstride;
    const uint8_t* Vs = Vw + st * 32 * geo.vstride;
    sfc::cp_async_wait<3>();
    __syncwarp();

    // scores: lane j against the CTA's GR query rows
    const bool live = lane < wrows;
    float s[GR];
#pragma unroll
    for (int r = 0; r < GR; ++r) s[r] = 0.f;
    if (live) {
      const uint8_t* kr = Ks + lane * geo.kstride;
      for (int u = 0; u < geo.kunits; ++u) {
        float kf[EPU];
        unpack(*reinterpret_cast<const uint4*>(kr + u * 16), kf);
#pragma unroll
        for (int r = 0; r < GR; ++r) {
          const float* qr = Qs + r * geo.dkp + u * EPU;
#pragma unroll
          for (int e = 0; e < EPU; e += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qr + e);
            s[r] = fmaf(q4.x, kf[e], s[r]);
            s[r] = fmaf(q4.y, kf[e + 1], s[r]);
            s[r] = fmaf(q4.z, kf[e + 2], s[r]);
            s[r] = fmaf(q4.w, kf[e + 3], s[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < GR; ++r) {
      const float sc = live ? (kpos <= p ? s[r] * scale : MASK) : -INFINITY;
      const float mn = fmaxf(m[r], warp_max(sc));
      const float pe = expf(sc - mn);
      const float alpha = expf(m[r] - mn);
      l[r] = alpha * l[r] + warp_sum(pe);
#pragma unroll
      for (int c = 0; c < ND; ++c) acc[r][c] *= alpha;
      m[r] = mn;
      Ps[r * 32 + lane] = pe;
    }
    sfc::cp_async_wait<2>();
    __syncwarp();
    // P . V: lane owns output columns lane, lane + 32, ...
    for (int jj = 0; jj < wrows; ++jj) {
      const T* vr = reinterpret_cast<const T*>(Vs + jj * geo.vstride);
      float vv[ND];
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < dv ? to_f32(vr[d]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < GR; ++r) {
        const float pr = Ps[r * 32 + jj];
#pragma unroll
        for (int c = 0; c < ND; ++c) acc[r][c] = fmaf(pr, vv[c], acc[r][c]);
      }
    }
    __syncwarp();  // ring slot st and Ps are consumed
    if (geo.stages == 1 && cn < chunks) {
      lookup(cn, roff, rpos);
      issue(0, min(32, nkv - 32 * cn), roff);
    }
  }
  __syncthreads();  // every warp is done with the K/V space

  // the CTA's merge: each warp's state through shared memory, warps in
  // ascending order (a warp that saw no row has m = -inf and weight 0)
  const int W = dv + 2;
  float* Mg = reinterpret_cast<float*>(raw);
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    float* dst = Mg + (warp * GR + r) * W;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int d = lane + 32 * c;
      if (d < dv) dst[d] = acc[r][c];
    }
    if (lane == 0) {
      dst[dv] = m[r];
      dst[dv + 1] = l[r];
    }
  }
  __syncthreads();
  float* out = ws + ((((size_t)run * splits + split) * hkv + h) * g + r0) * W;
  for (int i = threadIdx.x; i < nr * dv; i += blockDim.x) {
    const int r = i / dv, d = i - r * dv;
    float M = -INFINITY;
    for (int w = 0; w < geo.warps; ++w) M = fmaxf(M, Mg[(w * GR + r) * W + dv]);
    float a = 0.f, L = 0.f;
    for (int w = 0; w < geo.warps; ++w) {
      const float* src = Mg + (w * GR + r) * W;
      const float e = expf(src[dv] - M);
      a = __fadd_rn(a, __fmul_rn(e, src[d]));
      L = __fadd_rn(L, __fmul_rn(e, src[dv + 1]));
    }
    out[r * W + d] = a;
    if (d == 0) {
      out[r * W + dv] = M;
      out[r * W + dv + 1] = L;
    }
  }
}

// CTA (run, kv head h, row block z): rows z rows .. of the slot's g (all
// of them on the split core, 8 a CTA on the latent core), the slot's live
// splits in ascending order, o = sum_s e_s acc_s / sum_s e_s l_s with e_s
// = exp(m_s - max_s m_s).  A warp a row finds its max and sum (32 splits'
// loads in flight, the sum taken in split order by shuffles), then a
// thread an output element walks the splits with 8 splits' loads in
// flight.  An output's arithmetic does not depend on the row blocks.
template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_kernel(const float* __restrict__ ws, T* __restrict__ o, const int* __restrict__ sched,
             const int* __restrict__ runs, const int* __restrict__ pos, int g, int dv, int ps,
             int split_pages, int splits, int rows) {
  __shared__ float Ms[MAX_ROWS], Ls[MAX_ROWS];
  const int run = blockIdx.x, h = blockIdx.y, hkv = gridDim.y;
  const int r0 = blockIdx.z * rows, nr = min(rows, g - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int start = runs[2 * run];
  const int slot = sched[4 * start];
  const int steps = walk_steps(pos[slot], ps, runs[2 * run + 1]);
  const int live = (steps + split_pages - 1) / split_pages;
  const int W = dv + 2;
  const size_t between = (size_t)hkv * g * W;  // from one split's partials to the next
  const float* base = ws + (((size_t)run * splits * hkv + h) * g + r0) * W;
  for (int r = warp; r < nr; r += MERGE_THREADS / 32) {
    const float* pr = base + r * W;
    float M = -INFINITY;
    for (int s = lane; s < live; s += 32) M = fmaxf(M, pr[s * between + dv]);
    M = warp_max(M);
    float L = 0.f;
    for (int s0 = 0; s0 < live; s0 += 32) {
      const int s = s0 + lane;
      const float x =
          s < live ? __fmul_rn(expf(pr[s * between + dv] - M), pr[s * between + dv + 1]) : 0.f;
      const int cnt = min(32, live - s0);
      for (int j = 0; j < cnt; ++j) L = __fadd_rn(L, __shfl_sync(0xffffffffu, x, j));
    }
    if (lane == 0) {
      Ms[r] = M;
      Ls[r] = L;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr * dv; i += MERGE_THREADS) {
    const int r = i / dv, d = i - r * dv;
    const float* pr = base + r * W;
    const float M = Ms[r];
    float a = 0.f;
    for (int s0 = 0; s0 < live; s0 += 8) {
      float m8[8], v8[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const size_t at = (size_t)min(s0 + j, live - 1) * between;
        m8[j] = pr[at + dv];
        v8[j] = pr[at + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (s0 + j < live) a = __fadd_rn(a, __fmul_rn(expf(m8[j] - M), v8[j]));
    }
    store(o + (((size_t)slot * hkv + h) * g + r0 + r) * dv + d, a / Ls[r]);
  }
}

template <typename T, bool VEC>
int launch_t(const void* q, const void* kp, const void* vp, void* o, void* ws, const void* sched,
             const void* runs, int n_runs, int hkv, const void* table, const void* pos, int g,
             int dk, int dv, int ps, int mp, int split_pages, int splits, float scale,
             void* stream) {
  if (n_runs == 0 || hkv == 0) return 0;
  if (hkv > 65535) return (int)cudaErrorInvalidConfiguration;
  const Geometry geo((int)sizeof(T), dk, dv, ps, split_pages);
  // Geometry keeps every launch within SMEM_CAP
  const cudaError_t err = raise_smem_limit<split_kernel<T, VEC>>(SMEM_CAP);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_runs * splits, hkv, (g + GR - 1) / GR);
  split_kernel<T, VEC><<<grid, 32 * geo.warps, geo.bytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (float*)ws, (const int*)sched, (const int*)runs,
      (const int*)table, (const int*)pos, g, dk, dv, ps, mp, split_pages, splits, scale);
  const cudaError_t split_err = cudaGetLastError();
  if (split_err != cudaSuccess) return (int)split_err;
  merge_kernel<T><<<dim3(n_runs, hkv), MERGE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)ws, (T*)o, (const int*)sched, (const int*)runs, (const int*)pos, g, dv, ps,
      split_pages, splits, g);
  return (int)cudaGetLastError();
}

// the cp.async path: whole 16-byte units a row from 16-byte aligned pools
template <typename T>
int launch_dtype(const void* q, const void* kp, const void* vp, void* o, void* ws,
                 const void* sched, const void* runs, int n_runs, int hkv, const void* table,
                 const void* pos, int g, int dk, int dv, int ps, int mp, int split_pages,
                 int splits, float scale, void* stream) {
  const int es = (int)sizeof(T);
  const bool vec = (dk * es) % 16 == 0 && (dv * es) % 16 == 0 && (uintptr_t)kp % 16 == 0 &&
                   (uintptr_t)vp % 16 == 0;
  if (vec)
    return launch_t<T, true>(q, kp, vp, o, ws, sched, runs, n_runs, hkv, table, pos, g, dk, dv,
                             ps, mp, split_pages, splits, scale, stream);
  return launch_t<T, false>(q, kp, vp, o, ws, sched, runs, n_runs, hkv, table, pos, g, dk, dv, ps,
                            mp, split_pages, splits, scale, stream);
}

}  // namespace dec

// ---------------------------------------------------------------------------
// the latent core: sfc_flash_decode and sfc_flash_prefill at MLA's shapes
// (one kv head, one latent pool given as K and V, f32 queries)
// ---------------------------------------------------------------------------

namespace lat {

constexpr int R = 32;              // query rows of a CTA
constexpr int KV = 32;             // kv rows of a stage: the online softmax's step
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RW = R / WARPS;      // query rows of a warp
constexpr int MAX_D = 576;         // DeepSeek-V2's kv_lora_rank + qk_rope_head_dim
constexpr int DS = MAX_D / 32;     // a lane's slice of d in the scores' chain
constexpr int NP = MAX_D / 64;     // column pairs a lane in P V
constexpr int RING = 3;            // stages in shared memory: two read, one landing
constexpr int SLOTS = 4;           // stages' row facts: read, copied, looked up, kept
constexpr int MERGE_ROWS = 8;      // query rows of a decode merge CTA
constexpr unsigned FULL = 0xffffffffu;

// Shared memory at width D (a multiple of 16) for a pool of T: the ring of
// RING stages of KV pool rows as stored (D T each, by 16-byte cp.async),
// each warp's KV x RW scores (then probabilities), then SLOTS stages' row
// facts (pool row, position).  226,816 B for an f32 pool at D = 576,
// 116,224 for bf16; one CTA an SM either way (registers).
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int D) {
  return sizeof(T) * (size_t)RING * KV * D + 4 * (size_t)WARPS * KV * RW +
         (size_t)SLOTS * KV * (sizeof(size_t) + sizeof(int));
}

template <typename T>
struct Smem {
  T* ring;
  float* sw;   // this warp's KV x RW
  size_t* roff;
  int* rpos;

  __device__ Smem(char* base, int D) {
    ring = reinterpret_cast<T*>(base);
    sw = reinterpret_cast<float*>(ring + (size_t)RING * KV * D) + (threadIdx.x >> 5) * KV * RW;
    roff = reinterpret_cast<size_t*>(reinterpret_cast<float*>(ring + (size_t)RING * KV * D) +
                                     WARPS * KV * RW);
    rpos = reinterpret_cast<int*>(roff + SLOTS * KV);
  }
};

// two consecutive elements of a pool row in shared memory as f32 (4-byte
// aligned: bf16 to f32 is exact, the bits moved up)
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float2 pair(const float* p) { return *reinterpret_cast<const float2*>(p); }

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// decode: CTA (run * splits + split, kv head h, row block z): query rows
// z R .. of the slot's group against table steps split * split_pages .. of
// the run, up to the slot's last live page (dec::walk_steps; nkv = 0 for a
// split wholly past it)
struct DecodeRows {
  const int* sched;
  const int* table;
  int start, slot, h, hkv, g, r0, nr, t0, nkv, p, ps, mp;

  __device__ DecodeRows(const int* sched_, const int* runs, const int* table_, const int* pos,
                        int g_, int ps_, int mp_, int split_pages, int splits)
      : sched(sched_), table(table_), g(g_), ps(ps_), mp(mp_) {
    const int run = blockIdx.x / splits, split = blockIdx.x - run * splits;
    start = runs[2 * run];
    const int n = runs[2 * run + 1];
    slot = sched[4 * start];
    h = blockIdx.y;
    hkv = gridDim.y;
    r0 = blockIdx.z * R;
    nr = min(R, g - r0);
    t0 = split * split_pages;
    p = pos[slot];
    const int steps = dec::walk_steps(p, ps, n);
    nkv = t0 < steps ? (min(t0 + split_pages, steps) - t0) * ps : 0;
  }
  __device__ size_t q_row(int r) const { return ((size_t)slot * hkv + h) * g + r0 + r; }
  __device__ int qlim(int) const { return p; }
  // kv row f of the walk: its logical page, then its pool row and position
  __device__ int page(int f) const { return sched[4 * (start + t0 + f / ps) + 1]; }
  __device__ void place(int f, int lp, size_t& row, int& pos) const {
    const int off = f % ps;
    row = ((size_t)table[(size_t)slot * mp + lp] * ps + off) * hkv + h;
    pos = lp * ps + off;
  }
};

// prefill: CTA (run, row block y): rows y R .. of the run's ps * g rows in
// PrefillWalk::row order (row r = token r / g of the q tile, head r % g),
// the run's pages in table order; one kv head
struct PrefillRows {
  const int* sched;
  const int* table;
  int start, slot, qt, tq, g, ps, mp, p0, r0, nr, nkv;

  __device__ PrefillRows(const int* sched_, const int* runs, const int* table_, const int* pos0,
                         int tq_, int g_, int ps_, int mp_)
      : sched(sched_), table(table_), tq(tq_), g(g_), ps(ps_), mp(mp_) {
    start = runs[2 * blockIdx.x];
    nkv = runs[2 * blockIdx.x + 1] * ps;
    slot = sched[6 * start];
    qt = sched[6 * start + 1];
    p0 = pos0[slot];
    r0 = blockIdx.y * R;
    nr = min(R, ps * g - r0);
  }
  __device__ size_t q_row(int r) const {
    const int rr = r0 + r;
    return ((size_t)slot * tq + qt * ps + rr / g) * g + rr % g;
  }
  __device__ int qlim(int r) const { return p0 + qt * ps + (r0 + r) / g; }
  __device__ int page(int f) const { return sched[6 * (start + f / ps) + 2]; }
  __device__ void place(int f, int lp, size_t& row, int& pos) const {
    const int off = f % ps;
    row = (size_t)table[(size_t)slot * mp + lp] * ps + off;
    pos = lp * ps + off;
  }
};

// walk row f's facts, (0, -1) past the walk
template <typename Walk>
__device__ __forceinline__ void facts(const Walk& w, int f, size_t& ro, int& pp) {
  ro = 0;
  pp = -1;
  if (f < w.nkv) w.place(f, w.page(f), ro, pp);
}

// stage s's rows from the pool into ring slot s % RING by 16-byte cp.async
// (the pool 16-byte aligned, D a multiple of 16), closed as one group (an
// empty one past the walk)
template <typename T, bool Full, typename Walk>
__device__ __forceinline__ void copy_stage(const Walk& w, const Smem<T>& sm,
                                           const T* __restrict__ pool, int s, int D) {
  const int nrows = min(KV, w.nkv - s * KV);
  constexpr int per = 16 / (int)sizeof(T);
  const int units = Full ? MAX_D / per : D / per;
  T* dst = sm.ring + (size_t)(s % RING) * KV * D;
  const size_t* ro = sm.roff + (s % SLOTS) * KV;
  for (int i = threadIdx.x; i < nrows * units; i += THREADS) {
    const int j = i / units, u = i - j * units;
    sfc::cp_async16(dst + j * D + u * per, pool + ro[j] * D + u * per);
  }
  sfc::cp_async_commit();
}

// One CTA: R query rows (w) against the walk's kv rows, KV a stage.  Warp
// k owns rows RW k .. + RW - 1 from end to end: a lane holds those rows' q
// on its slice of d, [DS lane, DS lane + DS), in registers, and their
// output columns 2 lane + 64 c, + 1 (c < NP) in acc.
//
// S = Q K^T runs as a systolic chain along the warp: at step t lane l
// takes kv row t - l, continues the RW chains that lane l - 1 ran on that
// row one step before (a shuffle) over its slice of d ascending, and lane
// 31 ends them: each score is one fmaf chain over d ascending from 0, as
// flash_rows'.  Per step a lane reads its DS values
// of one pool row (DS / 2 words) for RW DS fmaf, so K costs 1 / RW of a
// load a fma, and the q operand none.  Stage s's last score is done at
// step 32 s + 62, when lanes 0 .. 30 are already on stage s + 1: the ring
// holds stages s and s + 1 while stage s + 2 lands, so the copy of a stage
// is issued two stages ahead, under one stage of arithmetic, and a stage
// costs one CTA barrier (the ring's turn).  A lane that has no row at a
// step (before the walk, past it) runs the step on ring rows nobody reads
// back, so the step loop has no branch.  Lane 31 leaves each row's scores
// in the warp's KV x RW; then the online softmax of the stage, lane j its
// row j (scale, masks, warp_max / warp_sum: m, alpha, l once a 32-row
// stage; the rows' butterflies side by side), the probabilities
// back in place, and O = alpha O + P V with P broadcast from shared
// memory, j ascending in the stage.  Rows, scores and sums never leave the
// warp; only the ring is shared.  On return acc holds the unnormalised
// output and m / l each row's max and sum (l as lane 0 summed it).
template <typename T, bool Full, typename Walk>
__device__ __forceinline__ void latent_core(const Walk& w, const Smem<T>& sm,
                                            const float* __restrict__ q,
                                            const T* __restrict__ pool, int D, float scale,
                                            float (&acc)[RW][2 * NP], float (&m)[RW],
                                            float (&l)[RW]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nkv = w.nkv, nst = (nkv + KV - 1) / KV;
  const bool active = RW * warp < w.nr;

  // the first stages' row facts, then their copies
  for (int f = threadIdx.x; f < min(RING, nst) * KV; f += THREADS)
    facts(w, f, sm.roff[(f / KV) % SLOTS * KV + f % KV], sm.rpos[(f / KV) % SLOTS * KV + f % KV]);
  // this lane's q: RW rows on its slice of d, zero past the CTA's rows
  float qr[RW][DS];
  int lim[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const bool live = RW * warp + r < w.nr;
    lim[r] = live ? w.qlim(RW * warp + r) : INT_MAX;
    const float* qrow = q + (live ? w.q_row(RW * warp + r) * D : 0) + DS * lane;
#pragma unroll
    for (int i = 0; i < DS / 2; ++i) {
      float2 v = make_float2(0.f, 0.f);
      if (live && (Full || DS * lane + 2 * i < D)) v = *reinterpret_cast<const float2*>(qrow + 2 * i);
      qr[r][2 * i] = v.x;
      qr[r][2 * i + 1] = v.y;
    }
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 2 * NP; ++c) acc[r][c] = 0.f;
  }
  __syncthreads();
  copy_stage<T, Full>(w, sm, pool, 0, D);
  copy_stage<T, Full>(w, sm, pool, 1, D);

  float out[RW];  // this lane's chains after its last step
#pragma unroll
  for (int r = 0; r < RW; ++r) out[r] = 0.f;
  int t = 0, rr = 0;  // step; ring row of this lane's row t - lane
  for (int s = 0; s < nst; ++s) {
    sfc::cp_async_wait<0>();
    __syncthreads();  // stages s, s + 1 landed; stage s - 1 consumed
    if (s + 2 < nst) copy_stage<T, Full>(w, sm, pool, s + 2, D);
    // stage s + 3's facts, published after this stage (the barrier above
    // the copy that reads them orders them): the page looked up here, the
    // pool row after the scores, so neither load stalls the warp
    const int fn = (s + 3) * KV + (int)threadIdx.x;
    const bool look = threadIdx.x < KV && s + 3 < nst;
    const int lpn = look && fn < nkv ? w.page(fn) : 0;

    if (active) {
      // the steps that end stage s's rows in lane 31
      const int t_end = min(KV * s + KV - 1, nkv - 1) + 31;
#pragma unroll 2
      for (; t <= t_end; ++t) {
        const int j = t - lane;
        float c[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float in = __shfl_up_sync(FULL, out[r], 1);
          c[r] = lane == 0 ? 0.f : in;
        }
        // ring row of row j (row 0 before the walk; rows past it are read
        // and never used)
        rr = j <= 0 ? 0 : (rr + 1 == RING * KV ? 0 : rr + 1);
        const T* kr = sm.ring + rr * D + DS * lane;
#pragma unroll
        for (int i = 0; i < DS / 2; ++i) {
          if (Full || DS * lane + 2 * i < D) {
            const float2 k2 = pair(kr + 2 * i);
#pragma unroll
            for (int r = 0; r < RW; ++r) c[r] = fmaf(qr[r][2 * i], k2.x, c[r]);
#pragma unroll
            for (int r = 0; r < RW; ++r) c[r] = fmaf(qr[r][2 * i + 1], k2.y, c[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < RW; ++r) out[r] = c[r];
        if (lane == 31 && j >= 0)
          *reinterpret_cast<float4*>(sm.sw + (j % KV) * RW) = make_float4(c[0], c[1], c[2], c[3]);
      }
      __syncwarp();
    }
    size_t ro = 0;
    int pp = -1;
    if (look && fn < nkv) w.place(fn, lpn, ro, pp);

    if (active) {
      // the online softmax of stage s: lane j its row j, the scores scaled
      // and masked (a row past the walk scores -inf)
      const int nrows = min(KV, nkv - KV * s);
      const float4 x4 = *reinterpret_cast<const float4*>(sm.sw + lane * RW);
      const int kp = sm.rpos[(s % SLOTS) * KV + lane];
      float x[RW], mx[RW], alpha[RW], pe[RW], ls[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        x[r] = lane < nrows ? (kp <= lim[r] ? __fmul_rn(comp(x4, r), scale) : MASK) : -INFINITY;
        mx[r] = x[r];
      }
#pragma unroll
      for (int o = 16; o; o >>= 1)  // warp_max of each row
#pragma unroll
        for (int r = 0; r < RW; ++r) mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], o));
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float mn = fmaxf(m[r], mx[r]);
        pe[r] = expf(x[r] - mn);
        alpha[r] = expf(m[r] - mn);
        ls[r] = pe[r];
        m[r] = mn;
      }
#pragma unroll
      for (int o = 16; o; o >>= 1)  // warp_sum of each row
#pragma unroll
        for (int r = 0; r < RW; ++r) ls[r] += __shfl_xor_sync(FULL, ls[r], o);
#pragma unroll
      for (int r = 0; r < RW; ++r) l[r] = alpha[r] * l[r] + ls[r];
      *reinterpret_cast<float4*>(sm.sw + lane * RW) = make_float4(pe[0], pe[1], pe[2], pe[3]);
      __syncwarp();

      // O = alpha O + P V
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int c = 0; c < 2 * NP; ++c) acc[r][c] *= alpha[r];
      const T* vb = sm.ring + (size_t)(s % RING) * KV * D + 2 * lane;
#pragma unroll 2
      for (int jj = 0; jj < nrows; ++jj) {
        const float4 p = *reinterpret_cast<const float4*>(sm.sw + jj * RW);
        const T* vr = vb + jj * D;
#pragma unroll
        for (int c = 0; c < NP; ++c) {
          if (Full || 2 * lane + 64 * c < D) {
            const float2 v = pair(vr + 64 * c);
#pragma unroll
            for (int r = 0; r < RW; ++r) {
              acc[r][2 * c] = fmaf(comp(p, r), v.x, acc[r][2 * c]);
              acc[r][2 * c + 1] = fmaf(comp(p, r), v.y, acc[r][2 * c + 1]);
            }
          }
        }
      }
      __syncwarp();  // P consumed before the next stage's scores land
    }
    if (look) {
      sm.roff[((s + 3) % SLOTS) * KV + threadIdx.x] = ro;
      sm.rpos[((s + 3) % SLOTS) * KV + threadIdx.x] = pp;
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) l[r] = __shfl_sync(FULL, l[r], 0);
}

// decode's split CTAs: the split's (acc, m, l) of each row to ws[run,
// split, h, row] = (acc[0 .. D), m, l), as dec::split_kernel's
template <typename T, bool Full>
__global__ void __launch_bounds__(THREADS, 1)
decode_kernel(const float* __restrict__ q, const T* __restrict__ pool, float* __restrict__ ws,
              const int* __restrict__ sched, const int* __restrict__ runs,
              const int* __restrict__ table, const int* __restrict__ pos, int g, int D, int ps,
              int mp, int split_pages, int splits, float scale) {
  extern __shared__ __align__(16) char smem[];
  const DecodeRows w(sched, runs, table, pos, g, ps, mp, split_pages, splits);
  if (w.nkv == 0) return;  // wholly past the slot's last live page: no partial
  const Smem<T> sm(smem, D);
  float acc[RW][2 * NP], m[RW], l[RW];
  latent_core<T, Full>(w, sm, q, pool, D, scale, acc, m, l);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, W = D + 2;
  float* out = ws + (((size_t)blockIdx.x * w.hkv + w.h) * g + w.r0 + RW * warp) * W;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    if (RW * warp + r >= w.nr) continue;
#pragma unroll
    for (int c = 0; c < NP; ++c)
      if (Full || 2 * lane + 64 * c < D)
        *reinterpret_cast<float2*>(out + r * W + 2 * lane + 64 * c) =
            make_float2(acc[r][2 * c], acc[r][2 * c + 1]);
    if (lane == 0) {
      out[r * W + D] = m[r];
      out[r * W + D + 1] = l[r];
    }
  }
}

template <typename T, bool Full>
__global__ void __launch_bounds__(THREADS, 1)
prefill_kernel(const float* __restrict__ q, const T* __restrict__ pool, float* __restrict__ o,
               const int* __restrict__ sched, const int* __restrict__ runs,
               const int* __restrict__ table, const int* __restrict__ pos0, int tq, int g, int D,
               int ps, int mp, float scale) {
  extern __shared__ __align__(16) char smem[];
  const PrefillRows w(sched, runs, table, pos0, tq, g, ps, mp);
  const Smem<T> sm(smem, D);
  float acc[RW][2 * NP], m[RW], l[RW];
  latent_core<T, Full>(w, sm, q, pool, D, scale, acc, m, l);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    if (RW * warp + r >= w.nr) continue;
    float* orow = o + w.q_row(RW * warp + r) * D + 2 * lane;
#pragma unroll
    for (int c = 0; c < NP; ++c)
      if (Full || 2 * lane + 64 * c < D)
        *reinterpret_cast<float2*>(orow + 64 * c) =
            make_float2(acc[r][2 * c] / l[r], acc[r][2 * c + 1] / l[r]);
  }
}

// D a multiple of 16 up to MAX_D, one kv head, any number of query rows
bool shape(int hkv, int dk, int dv) {
  return hkv == 1 && dk == dv && dk >= 16 && dk <= MAX_D && dk % 16 == 0;
}

template <typename T, bool Full>
int decode_t(const void* q, const void* pool, void* o, void* ws, const void* sched,
             const void* runs, int n_runs, const void* table, const void* pos, int g, int D,
             int ps, int mp, int split_pages, int splits, float scale, void* stream) {
  cudaError_t err = raise_smem_limit<decode_kernel<T, Full>>((int)smem_bytes<T>(MAX_D));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_runs * splits, 1, (g + R - 1) / R);
  decode_kernel<T, Full><<<grid, THREADS, smem_bytes<T>(D), (cudaStream_t)stream>>>(
      (const float*)q, (const T*)pool, (float*)ws, (const int*)sched, (const int*)runs,
      (const int*)table, (const int*)pos, g, D, ps, mp, split_pages, splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 merge_grid(n_runs, 1, (g + MERGE_ROWS - 1) / MERGE_ROWS);
  dec::merge_kernel<float><<<merge_grid, dec::MERGE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)ws, (float*)o, (const int*)sched, (const int*)runs, (const int*)pos, g, D, ps,
      split_pages, splits, MERGE_ROWS);
  return (int)cudaGetLastError();
}

// D = MAX_D (every lane's slice and columns whole) or a narrower width
template <typename T>
int decode(const void* q, const void* pool, void* o, void* ws, const void* sched, const void* runs,
           int n_runs, const void* table, const void* pos, int g, int D, int ps, int mp,
           int split_pages, int splits, float scale, void* stream) {
  if (n_runs == 0) return 0;
  if ((g + R - 1) / R > 65535) return (int)cudaErrorInvalidConfiguration;
  return D == MAX_D ? decode_t<T, true>(q, pool, o, ws, sched, runs, n_runs, table, pos, g, D, ps,
                                        mp, split_pages, splits, scale, stream)
                    : decode_t<T, false>(q, pool, o, ws, sched, runs, n_runs, table, pos, g, D, ps,
                                         mp, split_pages, splits, scale, stream);
}

template <typename T, bool Full>
int prefill_t(const void* q, const void* pool, void* o, const void* sched, const void* runs,
              int n_runs, const void* table, const void* pos0, int tq, int g, int D, int ps,
              int mp, float scale, void* stream) {
  const cudaError_t err = raise_smem_limit<prefill_kernel<T, Full>>((int)smem_bytes<T>(MAX_D));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_runs, (ps * g + R - 1) / R);
  prefill_kernel<T, Full><<<grid, THREADS, smem_bytes<T>(D), (cudaStream_t)stream>>>(
      (const float*)q, (const T*)pool, (float*)o, (const int*)sched, (const int*)runs,
      (const int*)table, (const int*)pos0, tq, g, D, ps, mp, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int prefill(const void* q, const void* pool, void* o, const void* sched, const void* runs,
            int n_runs, const void* table, const void* pos0, int tq, int g, int D, int ps, int mp,
            float scale, void* stream) {
  if (n_runs == 0) return 0;
  if ((ps * g + R - 1) / R > 65535) return (int)cudaErrorInvalidConfiguration;
  return D == MAX_D ? prefill_t<T, true>(q, pool, o, sched, runs, n_runs, table, pos0, tq, g, D,
                                         ps, mp, scale, stream)
                    : prefill_t<T, false>(q, pool, o, sched, runs, n_runs, table, pos0, tq, g, D,
                                          ps, mp, scale, stream);
}

}  // namespace lat


// ---------------------------------------------------------------------------
// sfc_flash_attention and sfc_flash_prefill in bf16 on the tensor cores:
// TMA + wgmma
// ---------------------------------------------------------------------------

namespace tc {

using namespace sfc;

constexpr int BQ = 128;                  // query rows of a CTA: two consumer warpgroups of 64
constexpr int STAGE_KV = 128;            // kv rows of a ring stage
constexpr int BLOCKS = STAGE_KV / 8;     // 8-column blocks of a stage's scores
constexpr int THREADS = 384;             // two consumer warpgroups + the producer warpgroup
constexpr int CHUNK = 128 * 64 * 2;      // 128 rows of 64 bf16 columns (one 128-byte swizzle row each)
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory at head width D: Q, then STAGES x (K, V), each as
// ceil(D / 64) column chunks of 128 rows (at D = 80 the second chunk holds
// columns 64..79 and the zeros TMA fills past the tensor's 80); the
// barriers after the ring, then (prefill) the producer's per-stage page
// facts.  The ring is 3 stages deep at D = 64 (112 KB), 2 at D = 80 and
// 128 (160 KB).
template <int D>
struct Layout {
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int CHUNKS = (D + 63) / 64;
  static constexpr int TILE_BYTES = CHUNKS * CHUNK;  // Q, or K or V of one stage
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int BARRIER_BYTES = (2 * STAGES + 2) * 8;  // full, empty, Q's; 16-byte multiple
  static constexpr int FACTS = STAGES * (BLOCKS + 1);         // ints: block positions, stage maxima
  static constexpr int SMEM = TILE_BYTES + STAGES * STAGE_BYTES + BARRIER_BYTES + 1024;
  static constexpr int PREFILL_SMEM = SMEM + FACTS * 4;
};

// the ring of a CTA: Q's tile, the stages, their barriers (every thread
// calls this; it ends in a CTA barrier)
template <int D>
struct Smem {
  uint8_t* qs;
  uint8_t* ring;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* qbar;
  int* facts;  // 16-byte aligned, after the barriers

  __device__ explicit Smem(uint8_t* raw) {
    using L = Layout<D>;
    qs = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~(uintptr_t)1023);
    ring = qs + L::TILE_BYTES;
    full = reinterpret_cast<uint64_t*>(ring + L::STAGES * L::STAGE_BYTES);
    empty = full + L::STAGES;
    qbar = empty + L::STAGES;
    facts = reinterpret_cast<int*>(full + 2 * L::STAGES + 2);
    if (threadIdx.x == 0) {
      for (int s = 0; s < L::STAGES; ++s) {
        wg::mbar_init(&full[s], 1);
        wg::mbar_init(&empty[s], 2);
      }
      wg::mbar_init(qbar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A consumer warpgroup (wgi = 0 or 1) of both tensor-core kernels: query
// rows 64 wgi .. 64 wgi + 63 of the CTA's 128 in Q's tile, n stages of the
// ring.  Per stage: S = Q K^T (m64n128k16, both from shared memory, K
// K-major), the walk's masks, the online softmax on the accumulator
// fragments (a row lives in one quad of lanes), and O += P V with P packed
// to bf16 in registers as the A fragments (m64nDk16, V MN-major).  Scores
// are kept in log2 units (scale * log2 e after the product) for ex2.
// Masks: load(i, s) once stage i (ring slot s) has landed; plain(): the
// stage masks nothing (at D = 64 and 80 its scores then stay unscaled
// until the exponent, scale > 0 keeping the maxima: one branch for the
// CTA; at D = 128 the second copy of the loop would spill); mask(j, v):
// register j's scaled score v, MASK where the position is masked, -inf
// where the column does not exist.  The thread's rows r0 and r0 + 8 end in o0, o1
// (a null pointer: a row that is not written).
template <int D, typename Masks>
__device__ __forceinline__ void consume(Masks& mk, const Smem<D>& sm, int wgi, int n, float scale_log2,
                                        __nv_bfloat16* o0, __nv_bfloat16* o1) {
  using L = Layout<D>;
  const int t = threadIdx.x & 127;
  const int cq = (t & 3) * 2;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const uint32_t qa = wg::smem_u32(sm.qs) + wgi * 64 * 128;
  wg::mbar_wait(sm.qbar, 0);
  int s = 0;
  uint32_t phase = 0;
  for (int i = 0; i < n; ++i) {
    wg::mbar_wait(&sm.full[s], phase);
    mk.load(i, s);
    const uint32_t ka = wg::smem_u32(sm.ring + s * L::STAGE_BYTES);
    const uint32_t va = ka + L::TILE_BYTES;

    // S = Q K^T: chunk kk / 4 of Q and K, 32 bytes along the swizzled row a step
    float sc[64];
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * CHUNK + (kk % 4) * 32;
      wg::wgmma_m64n128k16_kmajor(sc, wg::desc_sw128(qa + off, 16, 1024),
                                  wg::desc_sw128(ka + off, 16, 1024), kk);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();

    // masks and row maxima: register j holds row r0 + 8 ((j >> 1) & 1),
    // stage column 8 (j >> 2) + cq + (j & 1)
    const bool unmasked = D != 128 && mk.plain() && scale_log2 > 0.f;
    float mx0 = -INFINITY, mx1 = -INFINITY;
    if (unmasked) {
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        if (j & 2)
          mx1 = fmaxf(mx1, sc[j]);
        else
          mx0 = fmaxf(mx0, sc[j]);
      }
      mx0 *= scale_log2;
      mx1 *= scale_log2;
    } else {
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        const float v = mk.mask(j, sc[j] * scale_log2);
        sc[j] = v;
        if (j & 2)
          mx1 = fmaxf(mx1, v);
        else
          mx0 = fmaxf(mx0, v);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    const float sl = unmasked ? scale_log2 : 1.f;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const float p = ex2(fmaf(sc[j], sl, -((j & 2) ? mn1 : mn0)));
      sc[j] = p;
      if (j & 2)
        s1 += p;
      else
        s0 += p;
    }
    l0 = l0 * a0 + s0;  // this thread's part of the row sum (the quad's are added at the end)
    l1 = l1 * a1 + s1;
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] *= (j & 2) ? a1 : a0;
    // P's k16 slice kk is accumulator registers 8 kk .. 8 kk + 7, in the
    // order of the A fragment's four bf16 pairs
    uint32_t pa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

    // O += P V: V's k16 slice is 16 rows (2048 bytes) further, its column
    // chunks CHUNK bytes apart (n80 reads the second's first 16 columns)
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t db = wg::desc_sw128(va + kk * 2048, CHUNK, 1024);
      if constexpr (D == 64)
        wg::wgmma_m64n64k16_rs(acc, pa[kk], db);
      else if constexpr (D == 80)
        wg::wgmma_m64n80k16_rs(acc, pa[kk], db);
      else
        wg::wgmma_m64n128k16_rs(acc, pa[kk], db);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    if (t == 0) wg::mbar_arrive(&sm.empty[s]);
    if (++s == L::STAGES) {
      s = 0;
      phase ^= 1;
    }
  }

  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
#pragma unroll
  for (int j = 0; j < D / 2; j += 2) {
    const int c = (j >> 2) * 8 + cq;
    if (j & 2) {
      if (o1) *reinterpret_cast<__nv_bfloat162*>(o1 + c) = __floats2bfloat162_rn(acc[j] / l1, acc[j + 1] / l1);
    } else {
      if (o0) *reinterpret_cast<__nv_bfloat162*>(o0 + c) = __floats2bfloat162_rn(acc[j] / l0, acc[j + 1] / l0);
    }
  }
}

// this consumer thread's first row of the CTA's 128 (the accumulator
// layout of wg::acc_row): r0 and r0 + 8
__device__ __forceinline__ int consumer_row(int wgi) {
  const int t = threadIdx.x & 127;
  return wgi * 64 + (t >> 5) * 16 + ((t & 31) >> 2);
}

// row 20's masks: a stage is two 64-row halves, each a contiguous slice of
// one table tile; a half past the run's end (nkv % 128 == 64) re-reads the
// first and scores -inf
struct DenseMasks {
  const DenseWalk& w;
  int lim0, lim1, cq;
  int kb[2];
  bool live[2];

  __device__ void load(int i, int) {
    size_t ko, vo;  // the walk's element offsets (unused: TMA takes rows)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = i * STAGE_KV + h * 64;
      live[h] = f < w.nkv;
      kb[h] = 0;
      if (live[h]) w.kv(f, ko, vo, kb[h]);
    }
  }
  // all kv rows exist, lie below klim and (causal) at or before the CTA's
  // first query row
  __device__ bool plain() const {
    const int kmax = max(kb[0], kb[1]) + 63;
    return live[1] && kmax < w.klim && kmax <= w.qlim(0);
  }
  __device__ float mask(int j, float v) const {
    const int h = j >> 5;
    const int kp = kb[h] + ((j >> 2) & 7) * 8 + cq + (j & 1);
    const float r = (kp <= ((j & 2) ? lim1 : lim0) && kp < w.klim) ? v : MASK;
    return live[h] ? r : -INFINITY;
  }
};

// One CTA per (run, bh): 128 query rows of q tile qt, the run's kv tiles
// in table order, 128 kv rows a stage.  Warpgroup 2's first thread loads
// Q once and K, V stages (two 64-row boxes each) into the ring; warpgroups
// 0 and 1 consume (see consume).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv, __nv_bfloat16* __restrict__ o,
                   const int* __restrict__ sched, const int* __restrict__ runs, int S, int bkv,
                   int causal, int kv_valid, const int* __restrict__ seqlen, float scale_log2) {
  using L = Layout<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Smem<D> sm(smem_raw);

  // the CTA's query rows, kv rows and limits: flash_rows' walk
  const DenseWalk w(sched, runs, S, D, BQ, bkv, causal, kv_valid, seqlen);
  const int nkv = w.nkv;
  const int n = (nkv + STAGE_KV - 1) / STAGE_KV;
  const int row_base = w.bh * S;  // the (BH S, D) row of (bh, position 0)
  const int g = threadIdx.x / 128;

  if (g == 2) {  // the producer warpgroup: one thread issues every load
    if (threadIdx.x == 256) {
      size_t ko, vo;
      int pos;
      wg::mbar_expect_tx(sm.qbar, L::TILE_BYTES);
      for (int c = 0; c < L::CHUNKS; ++c)
        wg::tma_load_2d(sm.qs + c * CHUNK, &mq, sm.qbar, c * 64, row_base + w.qt * BQ);
      int s = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n; ++i) {
        wg::mbar_wait(&sm.empty[s], phase ^ 1);
        wg::mbar_expect_tx(&sm.full[s], L::STAGE_BYTES);
        uint8_t* ks = sm.ring + s * L::STAGE_BYTES;
        uint8_t* vs = ks + L::TILE_BYTES;
        for (int h = 0; h < 2; ++h) {
          int f = i * STAGE_KV + h * 64;
          if (f >= nkv) f -= 64;
          w.kv(f, ko, vo, pos);
          const int row = row_base + pos;
          for (int c = 0; c < L::CHUNKS; ++c) {
            wg::tma_load_2d(ks + c * CHUNK + h * (CHUNK / 2), &mk, &sm.full[s], c * 64, row);
            wg::tma_load_2d(vs + c * CHUNK + h * (CHUNK / 2), &mv, &sm.full[s], c * 64, row);
          }
        }
        if (++s == L::STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int r0 = consumer_row(g);
  DenseMasks masks{w, w.qlim(r0), w.qlim(r0 + 8), (threadIdx.x & 3) * 2, {0, 0}, {false, false}};
  __nv_bfloat16* o0 = o + w.o_off(r0);
  consume<D>(masks, sm, g, n, scale_log2, o0, o0 + 8 * D);
}

template <int D>
int attention_wgmma(const void* q, const void* k, const void* v, void* o, const void* sched,
                    const void* runs, int n_runs, int BH, int S, int bkv, int causal, int kv_valid,
                    const void* seqlen, float scale, void* stream) {
  if (n_runs == 0 || BH == 0) return 0;
  if (BH > 65535) return (int)cudaErrorInvalidConfiguration;
  // TMA: 16-byte aligned bases, int32 row coordinates
  if ((uintptr_t)q % 16 || (uintptr_t)k % 16 || (uintptr_t)v % 16 || (uintptr_t)o % 4 ||
      (long long)BH * S > INT_MAX)
    return (int)cudaErrorInvalidValue;
  // the maps span the D true columns (rows 2 D bytes apart): at D = 80 the
  // second chunk's box reads columns 64..79 and TMA fills the rest with
  // zeros (no padded copy on the host)
  CUtensorMap mq, mk, mv;
  const uint64_t rows = (uint64_t)BH * S;
  int err = make_tensor_map_bf16(&mq, q, rows, D, BQ, 64);
  if (!err) err = make_tensor_map_bf16(&mk, k, rows, D, 64, 64);
  if (!err) err = make_tensor_map_bf16(&mv, v, rows, D, 64, 64);
  if (err) return err;
  const cudaError_t attr = raise_smem_limit<flash_wgmma_kernel<D>>(Layout<D>::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  flash_wgmma_kernel<D><<<dim3(n_runs, BH), THREADS, Layout<D>::SMEM, (cudaStream_t)stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, (const int*)sched, (const int*)runs, S, bkv, causal, kv_valid,
      (const int*)seqlen, scale * LOG2E);
  return (int)cudaGetLastError();
}

// row 22's masks: a stage is 128 / ps whole pages, each page's kv
// positions lp ps .. lp ps + ps - 1 of its own logical page.  The producer
// publishes per stage the position of each 8-column block's first column
// (-1 for the slots of pages past the run's end, which re-read a live page
// and score -inf) and the stage's largest position when all its pages are
// live (else INT_MAX); the positions are read from shared memory where a
// block is masked, not held in registers.
struct PrefillMasks {
  const int* facts;  // [STAGES][BLOCKS] block positions, then [STAGES] stage maxima
  int stages, lim0, lim1, first, cq;
  const int* bpos;
  int top;

  __device__ void load(int, int s) {
    bpos = facts + s * BLOCKS;
    top = facts[stages * BLOCKS + s];
  }
  // every page live and at or before the CTA's first query row's position
  __device__ bool plain() const { return top <= first; }
  __device__ float mask(int j, float v) const {
    const int kb = bpos[j >> 2];
    const int kp = kb + cq + (j & 1);
    const float r = kp <= ((j & 2) ? lim1 : lim0) ? v : MASK;
    return kb >= 0 ? r : -INFINITY;
  }
};

// One CTA per (run, kv head h): the T g rows of PrefillWalk (tokens t0 ..
// t0 + T - 1 x the g query heads of h, row r = token g + head; T = 128 /
// g) in one 4-D box of Q of T g 128-byte rows a column chunk (the
// barrier expects those bytes; at T g < 128 the chunk's last rows keep
// what they held), the walk's pages in table order, 128 / ps pages a
// stage.  Rows past the tokens the CTA writes (a slot's last CTA) are
// read (TMA fills zeros past B Tq) but never written.  Warp 8 produces:
// lane 0 loads Q, and per stage lane i < 128 / ps
// looks up page i (PrefillWalk::page), publishes the stage's block
// positions and issues the page's K and V boxes (ps rows of one kv head,
// 128-byte rows, at row i ps of the stage); a slot past the run's end
// re-reads the run's last page.  Warpgroups 0 and 1 consume (see consume).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
prefill_wgmma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv, __nv_bfloat16* __restrict__ o,
                     const int* __restrict__ sched, const int* __restrict__ runs, int cta_tokens,
                     const int* __restrict__ table, const int* __restrict__ pos0, int tq, int g,
                     int ps, int mp, float scale_log2) {
  using L = Layout<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Smem<D> sm(smem_raw);

  const PrefillWalk w(sched, runs, true, table, pos0, tq, g, D, D, ps, mp);
  const int pages = w.nkv / ps;
  const int per_stage = STAGE_KV / ps;
  const int n = (pages + per_stage - 1) / per_stage;
  const int wgi = threadIdx.x / 128;

  if (wgi == 2) {
    if (threadIdx.x >= 256 + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      wg::mbar_expect_tx(sm.qbar, L::CHUNKS * cta_tokens * g * 128);
      for (int c = 0; c < L::CHUNKS; ++c)
        wg::tma_load_4d(sm.qs + c * CHUNK, &mq, sm.qbar, c * 64, 0, w.h, w.slot * tq + w.t0);
    }
    int* bpos = sm.facts;
    int* tops = sm.facts + L::STAGES * BLOCKS;
    int s = 0;
    uint32_t phase = 0;
    for (int i = 0; i < n; ++i) {
      const int t = i * per_stage + lane;
      const bool mine = lane < per_stage;
      const int live = mine && t < pages;
      int lp = 0, phys = 0;
      if (mine) w.page(min(t, pages - 1), lp, phys);
      const bool all_live = __all_sync(FULL, live || !mine);
      int top = live ? lp * ps + ps - 1 : -1;
#pragma unroll
      for (int d = 16; d; d >>= 1) top = max(top, __shfl_xor_sync(FULL, top, d));
      // lane b < BLOCKS describes columns 8 b .. 8 b + 7, in page 8 b / ps
      const int pb = (8 * lane) / ps;
      const int blp = __shfl_sync(FULL, lp, pb & 31);
      const int blive = __shfl_sync(FULL, live, pb & 31);
      wg::mbar_wait(&sm.empty[s], phase ^ 1);
      if (lane < BLOCKS) bpos[s * BLOCKS + lane] = blive ? blp * ps + (8 * lane) % ps : -1;
      if (lane == 0) tops[s] = all_live ? top : INT_MAX;
      __threadfence_block();
      __syncwarp();
      if (lane == 0) wg::mbar_expect_tx(&sm.full[s], L::STAGE_BYTES);
      __syncwarp();
      if (mine) {
        uint8_t* ks = sm.ring + s * L::STAGE_BYTES + lane * ps * 128;
        uint8_t* vs = ks + L::TILE_BYTES;
        for (int c = 0; c < L::CHUNKS; ++c) {
          wg::tma_load_3d(ks + c * CHUNK, &mk, &sm.full[s], c * 64, w.h, phys * ps);
          wg::tma_load_3d(vs + c * CHUNK, &mv, &sm.full[s], c * 64, w.h, phys * ps);
        }
      }
      if (++s == L::STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  const int r0 = consumer_row(wgi), live = w.rows();
  PrefillMasks masks{sm.facts, L::STAGES, w.qlim(r0), w.qlim(r0 + 8), w.qlim(0),
                     (threadIdx.x & 3) * 2, sm.facts, INT_MAX};
  consume<D>(masks, sm, wgi, n, scale_log2, r0 < live ? o + w.o_off(r0) : nullptr,
             r0 + 8 < live ? o + w.o_off(r0 + 8) : nullptr);
}

template <int D>
int prefill_wgmma(const void* q, const void* kp, const void* vp, void* o, const void* sched,
                  const void* runs, int n_runs, int cta_tokens, int hkv, const void* table,
                  const void* pos0, int tq, int g, int ps, int mp, int B, int P, float scale,
                  void* stream) {
  if (n_runs == 0 || hkv == 0) return 0;
  if (hkv > 65535) return (int)cudaErrorInvalidConfiguration;
  // TMA: 16-byte aligned bases, int32 coordinates
  if ((uintptr_t)q % 16 || (uintptr_t)kp % 16 || (uintptr_t)vp % 16 || (uintptr_t)o % 4 ||
      (long long)B * tq > INT_MAX || (long long)P * ps > INT_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  // Q (B Tq, Hkv, g, D): one box is a CTA's T = BQ / g tokens x g heads of
  // one kv head; past B Tq TMA fills zeros
  const uint64_t qdims[4] = {(uint64_t)D, (uint64_t)g, (uint64_t)hkv, (uint64_t)B * tq};
  const uint64_t qstrides[3] = {2ull * D, 2ull * g * D, 2ull * hkv * g * D};
  const uint32_t qbox[4] = {64, (uint32_t)g, 1, (uint32_t)cta_tokens};
  // the pools (P ps, Hkv, D): one box is one page of one kv head
  const uint64_t kdims[3] = {(uint64_t)D, (uint64_t)hkv, (uint64_t)P * ps};
  const uint64_t kstrides[2] = {2ull * D, 2ull * hkv * D};
  const uint32_t kbox[3] = {64, 1, (uint32_t)ps};
  int err = make_tensor_map_bf16_nd(&mq, q, 4, qdims, qstrides, qbox);
  if (!err) err = make_tensor_map_bf16_nd(&mk, kp, 3, kdims, kstrides, kbox);
  if (!err) err = make_tensor_map_bf16_nd(&mv, vp, 3, kdims, kstrides, kbox);
  if (err) return err;
  const cudaError_t attr = raise_smem_limit<prefill_wgmma_kernel<D>>(Layout<D>::PREFILL_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  prefill_wgmma_kernel<D><<<dim3(n_runs, hkv), THREADS, Layout<D>::PREFILL_SMEM, (cudaStream_t)stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, (const int*)sched, (const int*)runs, cta_tokens, (const int*)table,
      (const int*)pos0, tq, g, ps, mp, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace tc

// the shapes the tensor-core core (bf16 inputs) and the register-tiled
// core (f32) take, D = 80 being Zamba2's and HuBERT's head width; every
// other shape runs flash_rows.
// kernels/attention.py::flash_core is this rule.
static_assert(tc::BQ == 128 && tiled::BQ == 128 && tiled::KV == 64, "core_shape's constants");
bool core_shape(int D, int bq, int bkv) {
  return (D == 64 || D == 80 || D == 128) && bq == 128 && bkv % 64 == 0;
}

// a q tile's ps * g rows fit a 128-row CTA, which then holds T = 128 / g
// consecutive tokens of one slot (T >= ps; T g = 128 where g divides it)
bool prefill_cta_rows(int ps, int g) { return g >= 1 && ps * g <= tc::BQ; }
int prefill_cta_tokens(int g) { return tc::BQ / g; }

// the prefill shapes the tensor-core core takes (bf16 inputs): Dk == Dv
// in {64, 128}; a q tile fits the two warpgroups' 128 rows; whole pages a
// 64-row half (64 % ps == 0) of at least 8 rows, so that every page's box
// lands on a 1024-byte swizzle atom.
bool prefill_tensor_core_shape(int dk, int dv, int ps, int g) {
  return dk == dv && (dk == 64 || dk == 128) && prefill_cta_rows(ps, g) && ps >= 8 && 64 % ps == 0;
}

// the prefill shapes the register-tiled core takes (f32 inputs): Dk == Dv
// in {64, 128}; a q tile fits its 128 rows; whole pages a 64-row stage (64
// % ps == 0) whose rows a thread's 4 kv columns do not straddle (ps % 4
// == 0): ps in {4, 8, 16, 32, 64}, a power of two.
static_assert(tiled::KV == 64 && tiled::PAGE_MIN == 4 && tiled::BQ == tc::BQ,
              "prefill_tiled_shape's constants");
bool prefill_tiled_shape(int dk, int dv, int ps, int g) {
  return dk == dv && (dk == 64 || dk == 128) && prefill_cta_rows(ps, g) && ps >= tiled::PAGE_MIN &&
         ps % tiled::PAGE_MIN == 0 && tiled::KV % ps == 0;
}

// sfc_flash_prefill's and sfc_flash_decode's cores, as the wrapper names
// them (kernels/attention.py::prefill_core and is_latent pick one by these
// rules and pass its code)
enum PrefillCore { PREFILL_SIMT = 0, PREFILL_WGMMA = 1, PREFILL_TILED = 2, PREFILL_LATENT = 3 };
enum DecodeCore { DECODE_SPLIT = 0, DECODE_LATENT = 1 };

// the latent core's operands: one pool given as K and V, q and the pool
// 16-byte aligned
bool latent_operands(const void* q, const void* kp, const void* vp) {
  return kp == vp && (uintptr_t)q % 16 == 0 && (uintptr_t)kp % 16 == 0;
}

}  // namespace

extern "C" int sfc_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   const void* sched, const void* runs, int n_runs, int BH, int S,
                                   int D, int bq, int bkv, int causal, int kv_valid,
                                   const void* seqlen, float scale, int dtype, void* stream) {
  if (bad_shape(bq, D, D) || bkv < 1) return (int)cudaErrorInvalidValue;
  using Core = int (*)(const void*, const void*, const void*, void*, const void*, const void*, int,
                       int, int, int, int, int, const void*, float, void*);
  if (dtype == 0 && core_shape(D, bq, bkv)) {
    const Core f = D == 64 ? &tiled::attention<64> : D == 80 ? &tiled::attention<80> : &tiled::attention<128>;
    return f(q, k, v, o, sched, runs, n_runs, BH, S, bkv, causal, kv_valid, seqlen, scale, stream);
  }
  if (dtype == 0)
    return attention_t<float>(q, k, v, o, sched, runs, n_runs, BH, S, D, bq, bkv, causal, kv_valid,
                              seqlen, scale, stream);
  if (core_shape(D, bq, bkv)) {
    const Core f = D == 64   ? &tc::attention_wgmma<64>
                   : D == 80 ? &tc::attention_wgmma<80>
                             : &tc::attention_wgmma<128>;
    return f(q, k, v, o, sched, runs, n_runs, BH, S, bkv, causal, kv_valid, seqlen, scale, stream);
  }
  return attention_t<__nv_bfloat16>(q, k, v, o, sched, runs, n_runs, BH, S, D, bq, bkv, causal,
                                    kv_valid, seqlen, scale, stream);
}

// ws: the f32 workspace of the split partials, (n_runs, splits, hkv, g,
// dv + 2); splits * split_pages must cover the mp pages of a run.  dtype:
// the pools'; q is in it too on the split core, f32 on the latent core.
extern "C" int sfc_flash_decode(const void* q, const void* kp, const void* vp, void* o, void* ws,
                                const void* sched, const void* runs, int n_runs, int hkv,
                                const void* table, const void* pos, int g, int dk, int dv, int ps,
                                int mp, int split_pages, int splits, float scale, int dtype,
                                int core, void* stream) {
  if (ps < 1 || split_pages < 1 || splits < 1 || (long long)split_pages * splits < mp ||
      (long long)split_pages * ps > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  if (core == DECODE_LATENT) {
    if (!lat::shape(hkv, dk, dv) || g < 1 || !latent_operands(q, kp, vp))
      return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      return lat::decode<float>(q, kp, o, ws, sched, runs, n_runs, table, pos, g, dk, ps, mp,
                                split_pages, splits, scale, stream);
    return lat::decode<__nv_bfloat16>(q, kp, o, ws, sched, runs, n_runs, table, pos, g, dk, ps, mp,
                                      split_pages, splits, scale, stream);
  }
  if (core != DECODE_SPLIT || bad_shape(g, dk, dv)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dec::launch_dtype<float>(q, kp, vp, o, ws, sched, runs, n_runs, hkv, table, pos, g, dk,
                                    dv, ps, mp, split_pages, splits, scale, stream);
  return dec::launch_dtype<__nv_bfloat16>(q, kp, vp, o, ws, sched, runs, n_runs, hkv, table, pos,
                                          g, dk, dv, ps, mp, split_pages, splits, scale, stream);
}

// core: a PrefillCore code, the core the wrapper picked; the entry
// launches it, or refuses the call for a shape outside that core's rule.
// tokens: the tokens a CTA holds, T = 128 / g on the wgmma and tiled
// cores (sched their CTA table, runs of (first row, rows, t0, tokens);
// kernels/attention.py::prefill_cta_schedule), one q tile's ps on the
// others (runs of (first row, rows)).
extern "C" int sfc_flash_prefill(const void* q, const void* kp, const void* vp, void* o,
                                 const void* sched, const void* runs, int n_runs, int tokens, int hkv,
                                 const void* table, const void* pos0, int tq, int g, int dk, int dv,
                                 int ps, int mp, int B, int P, float scale, int dtype, int core,
                                 void* stream) {
  if (ps < 1 || g < 1) return (int)cudaErrorInvalidValue;
  const bool ctas = core == PREFILL_WGMMA || core == PREFILL_TILED;
  if (tokens != (ctas ? prefill_cta_tokens(g) : ps)) return (int)cudaErrorInvalidValue;
  if (core == PREFILL_LATENT) {
    if (!lat::shape(hkv, dk, dv) || !latent_operands(q, kp, vp))
      return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      return lat::prefill<float>(q, kp, o, sched, runs, n_runs, table, pos0, tq, g, dk, ps, mp,
                                 scale, stream);
    return lat::prefill<__nv_bfloat16>(q, kp, o, sched, runs, n_runs, table, pos0, tq, g, dk, ps,
                                       mp, scale, stream);
  }
  if (bad_shape(ps * g, dk, dv)) return (int)cudaErrorInvalidValue;
  if (core == PREFILL_WGMMA) {
    if (dtype == 0 || !prefill_tensor_core_shape(dk, dv, ps, g)) return (int)cudaErrorInvalidValue;
    return dk == 64 ? tc::prefill_wgmma<64>(q, kp, vp, o, sched, runs, n_runs, tokens, hkv, table,
                                            pos0, tq, g, ps, mp, B, P, scale, stream)
                    : tc::prefill_wgmma<128>(q, kp, vp, o, sched, runs, n_runs, tokens, hkv, table,
                                             pos0, tq, g, ps, mp, B, P, scale, stream);
  }
  if (core == PREFILL_TILED) {
    if (dtype != 0 || !prefill_tiled_shape(dk, dv, ps, g)) return (int)cudaErrorInvalidValue;
    return dk == 64 ? tiled::prefill<64>(q, kp, vp, o, sched, runs, n_runs, hkv, table, pos0, tq, g,
                                         ps, mp, scale, stream)
                    : tiled::prefill<128>(q, kp, vp, o, sched, runs, n_runs, hkv, table, pos0, tq, g,
                                          ps, mp, scale, stream);
  }
  if (core != PREFILL_SIMT) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return prefill_t<float>(q, kp, vp, o, sched, runs, n_runs, hkv, table, pos0, tq, g, dk, dv, ps,
                            mp, scale, stream);
  return prefill_t<__nv_bfloat16>(q, kp, vp, o, sched, runs, n_runs, hkv, table, pos0, tq, g, dk,
                                  dv, ps, mp, scale, stream);
}

// The register-tiled f32 core's build and residency, for the record: d =
// 64 or 128; out as kernel_info.cuh's, the design constants the core's D,
// kv rows a stage and stages.  sfc_flash_tiled_info reads row 20's
// kernel, sfc_prefill_tiled_info row 22's.
extern "C" int sfc_flash_tiled_info(int d, int* out) {
  if (d != 64 && d != 80 && d != 128) return (int)cudaErrorInvalidValue;
  const void* fn = d == 64   ? (const void*)tiled::flash_tiled_kernel<64>
                   : d == 80 ? (const void*)tiled::flash_tiled_kernel<80>
                             : (const void*)tiled::flash_tiled_kernel<128>;
  const int smem = d == 64 ? tiled::Layout<64>::SMEM
                   : d == 80 ? tiled::Layout<80>::SMEM
                             : tiled::Layout<128>::SMEM;
  return sfc::kernel_info(fn, tiled::THREADS, smem, {d, tiled::KV, tiled::STAGES}, out);
}

extern "C" int sfc_prefill_tiled_info(int d, int* out) {
  if (d != 64 && d != 128) return (int)cudaErrorInvalidValue;
  const void* fn = d == 64 ? (const void*)tiled::prefill_tiled_kernel<64>
                           : (const void*)tiled::prefill_tiled_kernel<128>;
  const int smem = d == 64 ? tiled::Layout<64>::PREFILL_SMEM : tiled::Layout<128>::PREFILL_SMEM;
  return sfc::kernel_info(fn, tiled::THREADS, smem, {d, tiled::KV, tiled::STAGES}, out);
}

// Row 20's tensor-core kernel's build and residency, for the record: d =
// 64, 80 or 128; the design constants the core's D, kv rows a stage and
// ring stages.
extern "C" int sfc_flash_wgmma_info(int d, int* out) {
  if (d != 64 && d != 80 && d != 128) return (int)cudaErrorInvalidValue;
  const void* fn = d == 64   ? (const void*)tc::flash_wgmma_kernel<64>
                   : d == 80 ? (const void*)tc::flash_wgmma_kernel<80>
                             : (const void*)tc::flash_wgmma_kernel<128>;
  const int smem = d == 64 ? tc::Layout<64>::SMEM : d == 80 ? tc::Layout<80>::SMEM : tc::Layout<128>::SMEM;
  const int stages = d == 64 ? tc::Layout<64>::STAGES
                     : d == 80 ? tc::Layout<80>::STAGES
                               : tc::Layout<128>::STAGES;
  return sfc::kernel_info(fn, tc::THREADS, smem, {d, tc::STAGE_KV, stages}, out);
}

// The latent core's build and residency, for the record: which = 0 decode,
// 1 prefill, at a bf16 pool and D = 576; out as kernel_info.cuh's, the
// design constants its query rows a CTA, kv rows a stage and largest D.

extern "C" int sfc_flash_latent_info(int which, int* out) {
  if (which != 0 && which != 1) return (int)cudaErrorInvalidValue;
  const void* fn = which == 0 ? (const void*)lat::decode_kernel<__nv_bfloat16, true>
                              : (const void*)lat::prefill_kernel<__nv_bfloat16, true>;
  return sfc::kernel_info(fn, lat::THREADS, (int)lat::smem_bytes<__nv_bfloat16>(lat::MAX_D),
                          {lat::R, lat::KV, lat::MAX_D}, out);
}
