// Two-phase binned SpMM, phase two: C = A @ B, walked slab-major, with
// the fold of the visits into their row tiles done in the kernel.
//
// Replaces the TPU kernel `binned_spmm_pallas`
// (src/repro/kernels/binned_spmm.py, which reuses `_csr_kernel`), its
// epilogue included.  The layout is the reference's `csr_to_slab_bins`
// packing, unchanged: a *visit* is one (B slab, row tile) pair with
// nonzeros, its chunks are contiguous, and visits are ordered slab-major.
// The host derives, once per layout, each chunk's real length and a work
// list of pieces (a visit's chunk range cut at PIECE_NNZ real entries).
//
// What bounds it on the card: bytes.  Every nonzero gathers one B row of
// d values, and every visit adds its touched rows into C; the slab-major
// order keeps the B slab that resident warps gather from hot in L2.
//
// The first version was bound by latency instead: one block per visit,
// each thread walking every slot of the visit's chunk, padding included,
// with one dependent B load per slot (about 460 ns per slot), then 8 x d
// fp32 partials per visit (2.8 GB at n = 2**20) that an index_add_ pass
// read back to fold.
//
// What the design does about it: the piece walk of row_tile.cuh, one warp
// per piece over the real entries only, with GATHER_UNROLL gathers in
// flight.  Each entry adds into its row's register accumulator, and an
// 8-bit mask records the rows it touched.  At the end the warp adds only those rows into one fp32 [n, d]
// accumulator with atomics: no partials buffer, no second pass over them.
// The accumulator is C itself at fp32, zeroed once per call; at bf16 a
// second kernel casts it into C once.  The atomics add a tile's visits in
// no fixed order, so the last bits of C can change from run to run; the
// tolerance of two computed sides (the sum of both bounds) covers it.
#include "row_tile.cuh"

namespace repro {

template <typename V, typename I>
__global__ void __launch_bounds__(PIECE_WARPS* WARP) binned_piece_kernel(
    const int* __restrict__ piece_ptr, const int* __restrict__ piece_owner,
    const int* __restrict__ visit_tiles, const int* __restrict__ chunk_len,
    const int* __restrict__ chunk_slabs, const I* __restrict__ cols,
    const I* __restrict__ slots, const V* __restrict__ vals,
    const V* __restrict__ b, float* __restrict__ acc_out,
    long long num_pieces, long long out_rows, int d, long long b_tile,
    int chunk) {
  const long long p =
      static_cast<long long>(blockIdx.x) * PIECE_WARPS + threadIdx.x / WARP;
  if (p >= num_pieces) return;
  const int lane = threadIdx.x & (WARP - 1);
  const int col0 = blockIdx.y * WARP_COLS;
  float acc[ROW_TILE][COLS_PER_LANE];
  const unsigned touched = walk_piece<V, I>(
      piece_ptr[p], piece_ptr[p + 1], chunk_len, chunk_slabs, cols, slots,
      vals, b, d, b_tile, chunk, col0, acc);
  const long long r0 =
      static_cast<long long>(visit_tiles[piece_owner[p]]) * ROW_TILE;
#pragma unroll
  for (int r = 0; r < ROW_TILE; ++r) {
    if (!((touched >> r) & 1u) || r0 + r >= out_rows) continue;
#pragma unroll
    for (int j = 0; j < COLS_PER_LANE; ++j) {
      const int col = col0 + lane + WARP * j;
      if (col < d) atomicAdd(acc_out + (r0 + r) * d + col, acc[r][j]);
    }
  }
}

template <typename V, typename I>
cudaError_t binned_spmm(const void* piece_ptr, const void* piece_owner,
                        const void* visit_tiles, const void* chunk_len,
                        const void* chunk_slabs, const void* cols,
                        const void* slots, const void* vals, const void* b,
                        void* acc, void* c, long long num_pieces,
                        long long out_rows, int d, long long b_tile,
                        int chunk, cudaStream_t stream) {
  if (num_pieces > 0) {
    dim3 grid, block;
    piece_launch_shape(num_pieces, d, &grid, &block);
    binned_piece_kernel<V, I><<<grid, block, 0, stream>>>(
        static_cast<const int*>(piece_ptr),
        static_cast<const int*>(piece_owner),
        static_cast<const int*>(visit_tiles),
        static_cast<const int*>(chunk_len),
        static_cast<const int*>(chunk_slabs), static_cast<const I*>(cols),
        static_cast<const I*>(slots), static_cast<const V*>(vals),
        static_cast<const V*>(b), static_cast<float*>(acc), num_pieces,
        out_rows, d, b_tile, chunk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (acc == c) return cudaSuccess;  // fp32: the accumulator is C
  return store_rows<V>(static_cast<const float*>(acc), nullptr,
                       static_cast<V*>(c),
                       (out_rows + ROW_TILE - 1) / ROW_TILE, out_rows, d,
                       stream);
}

}  // namespace repro

using repro::INDEX_I16;
using repro::INDEX_I32;
using repro::VALUE_BF16;
using repro::VALUE_F32;

extern "C" int binned_spmm_launch(
    int value_type, int index_type, const void* piece_ptr,
    const void* piece_owner, const void* visit_tiles, const void* chunk_len,
    const void* chunk_slabs, const void* cols, const void* slots,
    const void* vals, const void* b, void* acc, void* c,
    long long num_pieces, long long n, int d, long long b_tile, int chunk,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_BINNED(V, I)                                                \
  repro::binned_spmm<V, I>(piece_ptr, piece_owner, visit_tiles, chunk_len, \
                           chunk_slabs, cols, slots, vals, b, acc, c,      \
                           num_pieces, n, d, b_tile, chunk, s)
  if (value_type == VALUE_F32 && index_type == INDEX_I32)
    return REPRO_BINNED(float, int32_t);
  if (value_type == VALUE_F32 && index_type == INDEX_I16)
    return REPRO_BINNED(float, int16_t);
  if (value_type == VALUE_BF16 && index_type == INDEX_I32)
    return REPRO_BINNED(__nv_bfloat16, int32_t);
  if (value_type == VALUE_BF16 && index_type == INDEX_I16)
    return REPRO_BINNED(__nv_bfloat16, int16_t);
#undef REPRO_BINNED
  return static_cast<int>(cudaErrorInvalidValue);
}
