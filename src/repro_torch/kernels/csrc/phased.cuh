// What the phased kernels (floyd_warshall.cu, cholesky.cu) share: one
// launch per (k, phase) barrier group of a phased table, one CTA per
// table row (the Cholesky trailing kernel: one persistent CTA an SM over
// the rows).  CTA x owns tile (i, j) read from row `row_begin + x`,
// columns col_i and col_i + 1, of the int32 table `sched` (`sched_cols`
// columns); every tile is b x b inside the row-major n x n matrix.
#pragma once

#include "tile_gemm.cuh"

namespace sfc {

// the (i, j) tile this CTA owns
__device__ __forceinline__ int2 cta_tile(const int* sched, int sched_cols, int col_i, int row_begin) {
  const int* s = sched + (size_t)(row_begin + blockIdx.x) * sched_cols + col_i;
  return make_int2(s[0], s[1]);
}

// the first element of tile (ti, tj)
__device__ __forceinline__ float* tile_at(float* D, int n, int b, int ti, int tj) {
  return D + (size_t)ti * b * n + (size_t)tj * b;
}

// one tile per CTA: 8 <= b <= TILE, b % 8 == 0 (the wrappers raise first)
inline bool bad_block(int b) { return b < 8 || b > TILE || b % 8 != 0; }

}  // namespace sfc
