// Flash attention over curve- and page-scheduled runs: three kernels that
// share one online-softmax device routine (flash_rows).
//
// sfc_flash_attention replaces src/repro/kernels/attention.py::
// flash_attention_swizzled (_flash_kernel): attention over (BH, S, D) with
// a jump-over (q_tile, kv_tile, first, last) table; causal attention lists
// only the lower-triangular tiles, each q tile's kv tiles in serpentine
// order.  One CTA per (run, bh): a run is one q tile's kv walk.
//
// sfc_flash_decode replaces flash_attention_decode (_flash_decode_kernel):
// one decode step of (B, Hkv, g, Dk) grouped queries against (P, ps, Hkv,
// D) page pools read through page_table[slot, lp].  One CTA per (slot run,
// kv head) serves the g query heads of its group, and stops at the slot's
// last live page (lp <= pos // ps): a later page is masked by position and
// adds exactly zero to a finite state.
//
// sfc_flash_prefill replaces flash_attention_prefill (_flash_prefill_kernel):
// a cohort's (B, Tq, Hkv, g, Dk) new tokens, causal over each slot's paged
// prefix.  One CTA per (run, kv head); a run is one (slot, q tile of ps
// tokens) and its rows are the ps * g (token, head) pairs of the tile.
// Rows that no run covers stay unwritten, as on the TPU.
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
// the ridge of the bf16 tensor cores.  This first design is SIMT f32: a
// CTA of 8 warps stages 64 kv rows of K and V at a time in shared memory
// as f32 (the page-table or tile-table lookup done once per row by one
// thread), each warp owns RW query rows held in shared memory, a lane
// owns one kv row of each 32-row chunk for the scores and 4 of the 128
// output columns for P.V, and each row's (m, l, acc) lives in registers.
// Query blocks of more than 64 rows (prefill's 16 x 8, bq = 128) are
// walked in passes of 64.  No tensor cores, no TMA, no split-KV: decode
// at 8 slots x 4 kv heads runs 32 CTAs on 132 SMs.  Those are later work.
#include <climits>
#include <cmath>
#include <cstddef>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mutex>

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

// sfc_flash_decode: the g query heads of (slot, kv head h); kv rows of the
// slot's pages up to its last live one
struct DecodeWalk {
  const int* sched;
  const int* table;
  int start, slot, h, hkv, g, dk, dv, ps, mp, p, nkv;
  static constexpr int klim = INT_MAX;

  __device__ DecodeWalk(const int* sched_, const int* runs, const int* table_, const int* pos,
                        int g_, int dk_, int dv_, int ps_, int mp_)
      : sched(sched_), table(table_), g(g_), dk(dk_), dv(dv_), ps(ps_), mp(mp_) {
    start = runs[2 * blockIdx.x];
    const int n = runs[2 * blockIdx.x + 1];
    h = blockIdx.y;
    hkv = gridDim.y;
    slot = sched[4 * start];
    p = pos[slot];
    nkv = (p >= 0 ? min(p / ps, n - 1) + 1 : n) * ps;
  }
  __device__ int rows() const { return g; }
  __device__ size_t q_off(int r) const { return (((size_t)slot * hkv + h) * g + r) * dk; }
  __device__ size_t o_off(int r) const { return (((size_t)slot * hkv + h) * g + r) * dv; }
  __device__ int qlim(int) const { return p; }
  __device__ void kv(int f, size_t& ko, size_t& vo, int& pos) const {
    const int t = f / ps, off = f - t * ps;
    const int lp = sched[4 * (start + t) + 1];
    const size_t row = ((size_t)table[(size_t)slot * mp + lp] * ps + off) * hkv + h;
    pos = lp * ps + off;
    ko = row * dk;
    vo = row * dv;
  }
};

// sfc_flash_prefill: the ps * g (token, head) rows of q tile qt of slot,
// kv head h; kv rows of the run's pages in table order
struct PrefillWalk {
  const int* sched;
  const int* table;
  int start, slot, qt, h, hkv, tq, g, dk, dv, ps, mp, p0, nkv;
  static constexpr int klim = INT_MAX;

  __device__ PrefillWalk(const int* sched_, const int* runs, const int* table_, const int* pos0,
                         int tq_, int g_, int dk_, int dv_, int ps_, int mp_)
      : sched(sched_), table(table_), tq(tq_), g(g_), dk(dk_), dv(dv_), ps(ps_), mp(mp_) {
    start = runs[2 * blockIdx.x];
    nkv = runs[2 * blockIdx.x + 1] * ps;
    h = blockIdx.y;
    hkv = gridDim.y;
    slot = sched[6 * start];
    qt = sched[6 * start + 1];
    p0 = pos0[slot];
  }
  __device__ int rows() const { return ps * g; }
  __device__ size_t row(int r) const {
    const int tok = qt * ps + r / g;
    return (((size_t)slot * tq + tok) * hkv + h) * g + (r % g);
  }
  __device__ size_t q_off(int r) const { return row(r) * dk; }
  __device__ size_t o_off(int r) const { return row(r) * dv; }
  __device__ int qlim(int r) const { return p0 + qt * ps + r / g; }
  __device__ void kv(int f, size_t& ko, size_t& vo, int& pos) const {
    const int t = f / ps, off = f - t * ps;
    const int lp = sched[6 * (start + t) + 2];
    const size_t r = ((size_t)table[(size_t)slot * mp + lp] * ps + off) * hkv + h;
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
flash_decode_kernel(const T* q, const T* kp, const T* vp, T* o, const int* sched, const int* runs,
                    const int* table, const int* pos, int g, int dk, int dv, int ps, int mp,
                    float scale) {
  const DecodeWalk w(sched, runs, table, pos, g, dk, dv, ps, mp);
  flash_rows<T, RW>(w, q, kp, vp, o, dk, dv, scale);
}

template <typename T, int RW>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(const T* q, const T* kp, const T* vp, T* o, const int* sched, const int* runs,
                     const int* table, const int* pos0, int tq, int g, int dk, int dv, int ps, int mp,
                     float scale) {
  const PrefillWalk w(sched, runs, table, pos0, tq, g, dk, dv, ps, mp);
  flash_rows<T, RW>(w, q, kp, vp, o, dk, dv, scale);
}

constexpr int MAX_DEVICES = 64;

// kernel Kern's dynamic shared-memory limit (above the 48 KB static one),
// raised once per device to the most a launch of it can ask for: passes of
// RW * WARPS query rows at Dk = Dv = MAX_D
template <auto Kern, int RW>
cudaError_t raise_smem_limit() {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t attr[MAX_DEVICES];
  std::call_once(once[dev], [dev] {
    attr[dev] = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem_bytes(RW * WARPS, MAX_D, MAX_D));
  });
  return attr[dev];
}

// one launch of kernel Kern over (runs, heads) CTAs with `smem` bytes
template <auto Kern, int RW, typename... Args>
int launch(int runs, int heads, size_t smem, void* stream, Args... args) {
  if (runs == 0 || heads == 0) return 0;
  if (heads > 65535) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t err = raise_smem_limit<Kern, RW>();
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
int decode_t(const void* q, const void* kp, const void* vp, void* o, const void* sched,
             const void* runs, int n_runs, int hkv, const void* table, const void* pos, int g,
             int dk, int dv, int ps, int mp, float scale, void* stream) {
  if (g > WARPS)
    return launch<flash_decode_kernel<T, 8>, 8>(
        n_runs, hkv, smem_bytes(8 * WARPS, dk, dv), stream, (const T*)q, (const T*)kp,
        (const T*)vp, (T*)o, (const int*)sched, (const int*)runs, (const int*)table,
        (const int*)pos, g, dk, dv, ps, mp, scale);
  return launch<flash_decode_kernel<T, 1>, 1>(
      n_runs, hkv, smem_bytes(WARPS, dk, dv), stream, (const T*)q, (const T*)kp, (const T*)vp,
      (T*)o, (const int*)sched, (const int*)runs, (const int*)table, (const int*)pos, g, dk, dv,
      ps, mp, scale);
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

}  // namespace

extern "C" int sfc_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   const void* sched, const void* runs, int n_runs, int BH, int S,
                                   int D, int bq, int bkv, int causal, int kv_valid,
                                   const void* seqlen, float scale, int dtype, void* stream) {
  if (bad_shape(bq, D, D) || bkv < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return attention_t<float>(q, k, v, o, sched, runs, n_runs, BH, S, D, bq, bkv, causal, kv_valid,
                              seqlen, scale, stream);
  return attention_t<__nv_bfloat16>(q, k, v, o, sched, runs, n_runs, BH, S, D, bq, bkv, causal,
                                    kv_valid, seqlen, scale, stream);
}

extern "C" int sfc_flash_decode(const void* q, const void* kp, const void* vp, void* o,
                                const void* sched, const void* runs, int n_runs, int hkv,
                                const void* table, const void* pos, int g, int dk, int dv, int ps,
                                int mp, float scale, int dtype, void* stream) {
  if (bad_shape(g, dk, dv) || ps < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return decode_t<float>(q, kp, vp, o, sched, runs, n_runs, hkv, table, pos, g, dk, dv, ps, mp,
                           scale, stream);
  return decode_t<__nv_bfloat16>(q, kp, vp, o, sched, runs, n_runs, hkv, table, pos, g, dk, dv,
                                 ps, mp, scale, stream);
}

extern "C" int sfc_flash_prefill(const void* q, const void* kp, const void* vp, void* o,
                                 const void* sched, const void* runs, int n_runs, int hkv,
                                 const void* table, const void* pos0, int tq, int g, int dk, int dv,
                                 int ps, int mp, float scale, int dtype, void* stream) {
  if (bad_shape(ps * g, dk, dv) || ps < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return prefill_t<float>(q, kp, vp, o, sched, runs, n_runs, hkv, table, pos0, tq, g, dk, dv, ps,
                            mp, scale, stream);
  return prefill_t<__nv_bfloat16>(q, kp, vp, o, sched, runs, n_runs, hkv, table, pos0, tq, g, dk,
                                  dv, ps, mp, scale, stream);
}
