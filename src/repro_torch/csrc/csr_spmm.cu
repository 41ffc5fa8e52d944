// CSR SpMM over row-tiled chunks: C = A @ B.
//
// Replaces the TPU kernel `csr_spmm_pallas` (src/repro/kernels/csr_spmm.py,
// body `_csr_kernel`).  The layout is the reference's `csr_to_row_tiles`
// packing, unchanged: chunks of 128 slots per row tile of 8 rows, each
// chunk gathering from one B row slab with slab-local columns.  The host
// derives, once per layout, each chunk's real length and a work list of
// pieces (a tile's chunk range cut at PIECE_NNZ real entries).
//
// What bounds it on the card: bytes.  Every nonzero gathers one B row of d
// values; on a random pattern those rows come from all over B, so the
// kernel moves about nnz * d * sizeof(value) bytes of B through L2 and HBM
// for 2 * nnz * d FLOPs, far below the H100's ridge point.
//
// The first version was bound by latency instead: one block per tile, each
// thread walking every slot of every chunk, padding included, with one
// dependent B load per slot, about 460 ns per slot (~17 slots per nonzero
// on the L2-slab layout), and a hub row's tile walked by one block alone.
//
// What the design does about it (row_tile.cuh): one warp per piece reads
// only the real entries, 32 chunks' lengths and 32 entries at a time, and
// keeps GATHER_UNROLL gathers in flight; each entry adds into its row's
// register accumulator.  A tile that is one piece stores its 8 x d block
// once, zeros included, so C needs no clearing.  The pieces of a split tile run in parallel and add their
// touched rows into an fp32 buffer of the split tiles' rows with atomics;
// a second kernel then stores those rows into C at its dtype.  The atomics
// may change the last bits of a split tile's rows from run to run; the
// tolerance of two computed sides (the sum of both bounds) covers it.
#include "row_tile.cuh"

namespace repro {

template <typename V, typename I, typename O>
__global__ void __launch_bounds__(PIECE_WARPS* WARP) csr_piece_kernel(
    const int* __restrict__ piece_ptr, const int* __restrict__ piece_owner,
    const int* __restrict__ piece_split, const int* __restrict__ chunk_len,
    const int* __restrict__ chunk_slabs, const I* __restrict__ cols,
    const I* __restrict__ slots, const V* __restrict__ vals,
    const V* __restrict__ b, O* __restrict__ out,
    float* __restrict__ split_acc, long long num_pieces, long long out_rows,
    int d, long long b_tile, int chunk) {
  const long long p =
      static_cast<long long>(blockIdx.x) * PIECE_WARPS + threadIdx.x / WARP;
  if (p >= num_pieces) return;
  const int lane = threadIdx.x & (WARP - 1);
  const int col0 = blockIdx.y * WARP_COLS;
  float acc[ROW_TILE][COLS_PER_LANE];
  const unsigned touched = walk_piece<V, I>(
      piece_ptr[p], piece_ptr[p + 1], chunk_len, chunk_slabs, cols, slots,
      vals, b, d, b_tile, chunk, col0, acc);
  const int split = piece_split[p];
  if (split < 0) {
    const long long r0 = static_cast<long long>(piece_owner[p]) * ROW_TILE;
#pragma unroll
    for (int r = 0; r < ROW_TILE; ++r) {
      if (r0 + r >= out_rows) continue;
#pragma unroll
      for (int j = 0; j < COLS_PER_LANE; ++j) {
        const int col = col0 + lane + WARP * j;
        if (col < d) out[(r0 + r) * d + col] = from_f32<O>(acc[r][j]);
      }
    }
  } else {
    float* dst = split_acc + static_cast<long long>(split) * ROW_TILE * d;
#pragma unroll
    for (int r = 0; r < ROW_TILE; ++r) {
      if (!((touched >> r) & 1u)) continue;
#pragma unroll
      for (int j = 0; j < COLS_PER_LANE; ++j) {
        const int col = col0 + lane + WARP * j;
        if (col < d) atomicAdd(dst + static_cast<long long>(r) * d + col,
                               acc[r][j]);
      }
    }
  }
}

template <typename V, typename I, typename O>
cudaError_t csr_spmm(const void* piece_ptr, const void* piece_owner,
                     const void* piece_split, const void* split_tiles,
                     const void* chunk_len, const void* chunk_slabs,
                     const void* cols, const void* slots, const void* vals,
                     const void* b, void* c, void* split_acc,
                     long long num_pieces, long long num_split,
                     long long out_rows, int d, long long b_tile, int chunk,
                     cudaStream_t stream) {
  if (num_pieces == 0) return cudaSuccess;
  dim3 grid, block;
  piece_launch_shape(num_pieces, d, &grid, &block);
  csr_piece_kernel<V, I, O><<<grid, block, 0, stream>>>(
      static_cast<const int*>(piece_ptr), static_cast<const int*>(piece_owner),
      static_cast<const int*>(piece_split), static_cast<const int*>(chunk_len),
      static_cast<const int*>(chunk_slabs), static_cast<const I*>(cols),
      static_cast<const I*>(slots), static_cast<const V*>(vals),
      static_cast<const V*>(b), static_cast<O*>(c),
      static_cast<float*>(split_acc), num_pieces, out_rows, d, b_tile, chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return store_rows<O>(static_cast<const float*>(split_acc),
                       static_cast<const int*>(split_tiles),
                       static_cast<O*>(c), num_split, out_rows, d, stream);
}

}  // namespace repro

using repro::INDEX_I16;
using repro::INDEX_I32;
using repro::VALUE_BF16;
using repro::VALUE_F32;

extern "C" int csr_spmm_launch(
    int value_type, int index_type, const void* piece_ptr,
    const void* piece_owner, const void* piece_split,
    const void* split_tiles, const void* chunk_len, const void* chunk_slabs,
    const void* cols, const void* slots, const void* vals, const void* b,
    void* c, void* split_acc, long long num_pieces, long long num_split,
    long long n, int d, long long b_tile, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_CSR(V, I)                                                      \
  repro::csr_spmm<V, I, V>(piece_ptr, piece_owner, piece_split, split_tiles, \
                           chunk_len, chunk_slabs, cols, slots, vals, b, c,  \
                           split_acc, num_pieces, num_split, n, d, b_tile,   \
                           chunk, s)
  if (value_type == VALUE_F32 && index_type == INDEX_I32)
    return REPRO_CSR(float, int32_t);
  if (value_type == VALUE_F32 && index_type == INDEX_I16)
    return REPRO_CSR(float, int16_t);
  if (value_type == VALUE_BF16 && index_type == INDEX_I32)
    return REPRO_CSR(__nv_bfloat16, int32_t);
  if (value_type == VALUE_BF16 && index_type == INDEX_I16)
    return REPRO_CSR(__nv_bfloat16, int16_t);
#undef REPRO_CSR
  return static_cast<int>(cudaErrorInvalidValue);
}
