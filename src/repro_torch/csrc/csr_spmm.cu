// CSR SpMM over row-tiled chunks: C = A @ B.
//
// Replaces the TPU kernel `csr_spmm_pallas` (src/repro/kernels/csr_spmm.py,
// body `_csr_kernel`).  The layout is the reference's `csr_to_row_tiles`
// packing, unchanged: chunks of 128 nonzeros per row tile of 8 rows, each
// chunk gathering from one B row slab with slab-local columns.  The
// wrapper adds `tile_ptr[num_tiles + 1]`, the chunk range of each tile,
// computed once from the non-decreasing tile ids.
//
// What bounds it on the card: bytes.  Every nonzero gathers one B row of d
// values; on a random pattern those rows come from all over B, so the
// kernel moves about nnz * d * sizeof(value) bytes of B through L2 and HBM
// for 2 * nnz * d FLOPs, far below the H100's ridge point.
//
// What the design does about it: one block per (row tile, column slice),
// one column per thread, so each gathered B row is one coalesced warp load;
// the 8 output rows stay in registers and C is written once, in the
// operand dtype.  The TPU kernel's one-hot matmul was its stand-in for a
// scatter; here the row slot selects the register directly.  No load
// balancing: a hub row's tile walks all its chunks alone (scale-free
// imbalance is left for a later change).
#include "row_tile.cuh"

using repro::INDEX_I16;
using repro::INDEX_I32;
using repro::VALUE_BF16;
using repro::VALUE_F32;

extern "C" int csr_spmm_launch(int value_type, int index_type,
                               const void* tile_ptr, const void* chunk_slabs,
                               const void* cols, const void* slots,
                               const void* vals, const void* b, void* c,
                               long long num_tiles, long long n, int d,
                               long long b_tile, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_type == VALUE_F32 && index_type == INDEX_I32)
    return repro::row_tile_spmm<float, int32_t, float>(
        tile_ptr, chunk_slabs, cols, slots, vals, b, c, num_tiles, n, d,
        b_tile, chunk, s);
  if (value_type == VALUE_F32 && index_type == INDEX_I16)
    return repro::row_tile_spmm<float, int16_t, float>(
        tile_ptr, chunk_slabs, cols, slots, vals, b, c, num_tiles, n, d,
        b_tile, chunk, s);
  if (value_type == VALUE_BF16 && index_type == INDEX_I32)
    return repro::row_tile_spmm<__nv_bfloat16, int32_t, __nv_bfloat16>(
        tile_ptr, chunk_slabs, cols, slots, vals, b, c, num_tiles, n, d,
        b_tile, chunk, s);
  if (value_type == VALUE_BF16 && index_type == INDEX_I16)
    return repro::row_tile_spmm<__nv_bfloat16, int16_t, __nv_bfloat16>(
        tile_ptr, chunk_slabs, cols, slots, vals, b, c, num_tiles, n, d,
        b_tile, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
