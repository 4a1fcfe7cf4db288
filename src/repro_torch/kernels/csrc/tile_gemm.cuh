// Shared 128x128 SIMT tile product for the curve-scheduled kernels.
//
// One CTA of 256 threads computes a 128x128 f32 tile of A . B over a K
// loop, staging 16-deep chunks of both operands through shared memory
// and prefetching the next chunk into registers while the current one is
// multiplied.  Thread (tx, ty) = (tid % 16, tid / 16) owns rows
// {4ty..4ty+3, 64+4ty..64+4ty+3} and columns {4tx..4tx+3, 64+4tx..64+4tx+3}
// of the tile, so its shared-memory reads are float4-wide and
// conflict-free.  Every product is an explicit __fmaf_rn accumulated in
// k order, so two kernels that call this on the same operands get the
// same bits (the e-join's two passes rely on that).
//
// Operands are read through small loader structs:
//   RowLoader<T>: element (r, k) at p[r * ld + k]  (A of a GEMM, or the
//                 rows of a point / centroid matrix for x . c^T)
//   KLoader<T>:   element (k, c) at p[k * ld + c]  (B of a GEMM)
// Both zero-fill outside (rows, K), so ragged tiles need no special case.
#pragma once

#include <cstddef>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sfc {

constexpr int TILE = 128;
constexpr int BK = 16;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int tile_row(int ty, int i) { return i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4); }
__device__ __forceinline__ int tile_col(int tx, int j) { return j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4); }

template <typename T>
struct RowLoader {
  const T* p;     // row 0 of the tile, column 0 of K
  size_t ld;      // elements between consecutive rows
  int rows;       // valid rows (<= TILE)
  int K;          // valid depth
  // thread t loads rows t/2, depth (t%2)*8 .. +7 of the chunk at k0
  __device__ __forceinline__ void load(float (&r)[8], int k0) const {
    const int t = threadIdx.x;
    const int row = t >> 1;
    const int kb = k0 + (t & 1) * 8;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k = kb + q;
      r[q] = (row < rows && k < K) ? to_f32(p[(size_t)row * ld + k]) : 0.f;
    }
  }
  __device__ __forceinline__ void store(float* s, const float (&r)[8]) const {
    const int t = threadIdx.x;
    const int row = t >> 1;
    const int kb = (t & 1) * 8;
#pragma unroll
    for (int q = 0; q < 8; ++q) s[(kb + q) * TILE + row] = r[q];
  }
};

template <typename T>
struct KLoader {
  const T* p;     // depth 0 of the tile, column 0
  size_t ld;      // elements between consecutive depths
  int cols;       // valid columns (<= TILE)
  int K;          // valid depth
  // thread t loads depth t/16, columns (t%16)*8 .. +7 of the chunk at k0
  __device__ __forceinline__ void load(float (&r)[8], int k0) const {
    const int t = threadIdx.x;
    const int k = k0 + (t >> 4);
    const int cb = (t & 15) * 8;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = cb + q;
      r[q] = (c < cols && k < K) ? to_f32(p[(size_t)k * ld + c]) : 0.f;
    }
  }
  __device__ __forceinline__ void store(float* s, const float (&r)[8]) const {
    const int t = threadIdx.x;
    const int kk = t >> 4;
    const int cb = (t & 15) * 8;
#pragma unroll
    for (int q = 0; q < 8; ++q) s[kk * TILE + cb + q] = r[q];
  }
};

// acc[i][j] = sum_k A(tile_row(i), k) * B(k, tile_col(j)), k ascending.
// With WithNorms, threads 0..127 also return the squared norm of A-row
// t in *norm and threads 128..255 that of B-column t-128 (both summed in
// k order with __fmaf_rn).  As/Bs: BK*TILE floats of shared memory each.
template <bool WithNorms, typename LA, typename LB>
__device__ __forceinline__ void tile_product(float (&acc)[8][8], const LA& la, const LB& lb,
                                             int K, float* As, float* Bs, float* norm) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float nacc = 0.f;
  float ra[8], rb[8];
  la.load(ra, 0);
  lb.load(rb, 0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // everyone is done reading the previous chunk
    la.store(As, ra);
    lb.store(Bs, rb);
    __syncthreads();
    if (k0 + BK < K) {
      la.load(ra, k0 + BK);
      lb.load(rb, k0 + BK);
    }
    if (WithNorms) {
      const float* src = threadIdx.x < TILE ? As + threadIdx.x : Bs + (threadIdx.x - TILE);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float v = src[kk * TILE];
        nacc = __fmaf_rn(v, v, nacc);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + kk * TILE + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(As + kk * TILE + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * TILE + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * TILE + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
  }
  if (WithNorms) *norm = nacc;
}

}  // namespace sfc
