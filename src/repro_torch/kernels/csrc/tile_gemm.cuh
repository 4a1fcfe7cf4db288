// 128x128 SIMT tile product, now used only through phased.cuh: the
// Floyd-Warshall trailing kernel's (min, +) product (floyd_warshall.cu,
// row 16), and its thread-tile layout (tile_row, tile_col) by the
// Floyd-Warshall diagonal closure and the Cholesky trailing kernel
// (cholesky.cu).  The Floyd-Warshall panels, the matmuls, the k-means
// assign and the e-join's passes stage their operands by cp.async.
//
// One CTA of 256 threads computes a 128x128 f32 tile of A (x) B over a K
// loop, staging 16-deep chunks of both operands through shared memory
// and prefetching the next chunk into registers while the current one is
// multiplied.  Thread (tx, ty) = (tid % 16, tid / 16) owns rows
// {4ty..4ty+3, 64+4ty..64+4ty+3} and columns {4tx..4tx+3, 64+4tx..64+4tx+3}
// of the tile, so its shared-memory reads are float4-wide and
// conflict-free.
//
// Operands are read through small loader structs:
//   RowLoader<T>: element (r, k) at p[r * ld + k]  (A)
//   KLoader<T>:   element (k, c) at p[k * ld + c]  (B)
// Both fill outside (rows, K) with their `fill` member, so ragged tiles
// need no special case.  The fill must be the semiring's neutral element:
// +inf for the (min, +) product, where a zero-filled depth would offer the
// candidate 0 + 0 = 0 to every output (blocks that are not multiples of
// BK = 16, e.g. b = 88, reach past the tile edge).
//
// tile_product is a template over its semiring: MinPlus (acc = min(acc,
// a + b) with __fadd_rn, from +inf, the shortest-path product of
// Floyd-Warshall).
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
  float fill = 0.f;  // value outside (rows, K)
  // thread t loads rows t/2, depth (t%2)*8 .. +7 of the chunk at k0
  __device__ __forceinline__ void load(float (&r)[8], int k0) const {
    const int t = threadIdx.x;
    const int row = t >> 1;
    const int kb = k0 + (t & 1) * 8;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k = kb + q;
      r[q] = (row < rows && k < K) ? to_f32(p[(size_t)row * ld + k]) : fill;
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
  float fill = 0.f;  // value outside (K, cols)
  // thread t loads depth t/16, columns (t%16)*8 .. +7 of the chunk at k0
  __device__ __forceinline__ void load(float (&r)[8], int k0) const {
    const int t = threadIdx.x;
    const int k = k0 + (t >> 4);
    const int cb = (t & 15) * 8;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = cb + q;
      r[q] = (c < cols && k < K) ? to_f32(p[(size_t)k * ld + c]) : fill;
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

struct MinPlus {  // acc = min_k (a + b): the (min, +) product
  static __device__ __forceinline__ float zero() { return __int_as_float(0x7f800000); }
  static __device__ __forceinline__ float fold(float acc, float a, float b) {
    return fminf(acc, __fadd_rn(a, b));
  }
};

// acc[i][j] = Ring::fold over k ascending of A(tile_row(i), k) and
// B(k, tile_col(j)), from the ring's zero.  As/Bs: BK*TILE floats of
// shared memory each.
template <typename Ring, typename LA, typename LB>
__device__ __forceinline__ void tile_product(float (&acc)[8][8], const LA& la, const LB& lb,
                                             int K, float* As, float* Bs) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = Ring::zero();
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
        for (int j = 0; j < 8; ++j) acc[i][j] = Ring::fold(acc[i][j], a[i], b[j]);
    }
  }
}

}  // namespace sfc
