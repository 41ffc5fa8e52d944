// The chunk walk shared by the CSR kernel (csr_spmm.cu) and the binned
// kernel (binned_spmm.cu).
//
// A layout is a list of chunks of `chunk` nonzeros.  Each chunk belongs to
// one owner (a row tile for CSR, a (slab, row tile) visit for binned),
// gathers from one B row slab (`chunk_slabs`), and stores slab-local
// columns, row slots within the owner's ROW_TILE rows, and values.  The
// chunks of an owner are contiguous: owner o holds chunks
// [owner_ptr[o], owner_ptr[o + 1]).
//
// One thread block per (owner, column slice).  Each thread owns one column
// of C and keeps ROW_TILE fp32 accumulators in registers.  The chunk's
// indices and values are the same for every thread of the block (broadcast
// loads through L1); the B row loads are coalesced across the warp.  The
// owner's ROW_TILE x d block is written once at the end.  The slot select
// is unrolled so the accumulators stay in registers (a dynamic index would
// put them in local memory).
#pragma once

#include "common.cuh"

namespace repro {

constexpr int ROW_TILE = 8;
constexpr int ROW_TILE_MAX_THREADS = 128;

template <typename V, typename I, typename O>
__global__ void row_tile_spmm_kernel(const int* __restrict__ owner_ptr,
                                     const int* __restrict__ chunk_slabs,
                                     const I* __restrict__ cols,
                                     const I* __restrict__ slots,
                                     const V* __restrict__ vals,
                                     const V* __restrict__ b,
                                     O* __restrict__ out, long long out_rows,
                                     int d, long long b_tile, int chunk) {
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= d) return;
  const long long owner = blockIdx.x;
  float acc[ROW_TILE];
#pragma unroll
  for (int r = 0; r < ROW_TILE; ++r) acc[r] = 0.f;

  const int c0 = owner_ptr[owner];
  const int c1 = owner_ptr[owner + 1];
  for (int c = c0; c < c1; ++c) {
    const long long base = static_cast<long long>(chunk_slabs[c]) * b_tile;
    const long long e0 = static_cast<long long>(c) * chunk;
#pragma unroll 4
    for (int e = 0; e < chunk; ++e) {
      const int slot = to_i32(slots[e0 + e]);
      const float v = to_f32(vals[e0 + e]);
      const long long row = base + to_i32(cols[e0 + e]);
      const float p = round_product<V>(to_f32(b[row * d + col]) * v);
#pragma unroll
      for (int r = 0; r < ROW_TILE; ++r) acc[r] += (slot == r) ? p : 0.f;
    }
  }
  const long long r0 = owner * ROW_TILE;
#pragma unroll
  for (int r = 0; r < ROW_TILE; ++r) {
    if (r0 + r < out_rows) out[(r0 + r) * d + col] = from_f32<O>(acc[r]);
  }
}

// Launch shape of the chunk walk: one column per thread, up to
// ROW_TILE_MAX_THREADS columns per block.
inline void row_tile_launch_shape(long long owners, int d, dim3* grid,
                                  dim3* block) {
  int threads = ((d + 31) / 32) * 32;
  if (threads > ROW_TILE_MAX_THREADS) threads = ROW_TILE_MAX_THREADS;
  *block = dim3(threads);
  *grid = dim3(static_cast<unsigned>(owners), (d + threads - 1) / threads);
}

template <typename V, typename I, typename O>
cudaError_t row_tile_spmm(const void* owner_ptr, const void* chunk_slabs,
                          const void* cols, const void* slots,
                          const void* vals, const void* b, void* out,
                          long long owners, long long out_rows, int d,
                          long long b_tile, int chunk, cudaStream_t stream) {
  dim3 grid, block;
  row_tile_launch_shape(owners, d, &grid, &block);
  row_tile_spmm_kernel<V, I, O><<<grid, block, 0, stream>>>(
      static_cast<const int*>(owner_ptr),
      static_cast<const int*>(chunk_slabs), static_cast<const I*>(cols),
      static_cast<const I*>(slots), static_cast<const V*>(vals),
      static_cast<const V*>(b), static_cast<O*>(out), out_rows, d, b_tile,
      chunk);
  return cudaGetLastError();
}

}  // namespace repro
