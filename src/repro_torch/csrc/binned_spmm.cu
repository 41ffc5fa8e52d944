// Two-phase binned SpMM, phase two: C partials = A @ B, walked slab-major.
//
// Replaces the TPU kernel `binned_spmm_pallas`
// (src/repro/kernels/binned_spmm.py, which reuses `_csr_kernel`).  The
// layout is the reference's `csr_to_slab_bins` packing, unchanged: a
// *visit* is one (B slab, row tile) pair with nonzeros, its chunks are
// contiguous, and visits are ordered slab-major.  The wrapper adds
// `visit_ptr[num_visits + 1]`, the chunk range of each visit.
//
// What bounds it on the card: bytes.  Each visit gathers B rows of one
// slab and writes a private fp32 partial of 8 x d values; the partials
// cost 2 * visits * 8 * d * 4 extra bytes over CSR, paid back only when
// the slab-major order keeps B slabs hot in L2.
//
// What the design does about it: the chunk body is the CSR kernel's
// (row_tile.cuh), with the visit as the owner; consecutive blocks walk
// consecutive visits, so blocks resident at the same time gather from the
// same slab.  The partials are fp32 and written once; the wrapper folds
// them into row tiles with an fp32 index_add_ and casts once.
#include "row_tile.cuh"

using repro::INDEX_I16;
using repro::INDEX_I32;
using repro::VALUE_BF16;
using repro::VALUE_F32;

extern "C" int binned_spmm_launch(int value_type, int index_type,
                                  const void* visit_ptr,
                                  const void* chunk_slabs, const void* cols,
                                  const void* slots, const void* vals,
                                  const void* b, void* partials,
                                  long long num_visits, int d,
                                  long long b_tile, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = num_visits * repro::ROW_TILE;
  if (value_type == VALUE_F32 && index_type == INDEX_I32)
    return repro::row_tile_spmm<float, int32_t, float>(
        visit_ptr, chunk_slabs, cols, slots, vals, b, partials, num_visits,
        rows, d, b_tile, chunk, s);
  if (value_type == VALUE_F32 && index_type == INDEX_I16)
    return repro::row_tile_spmm<float, int16_t, float>(
        visit_ptr, chunk_slabs, cols, slots, vals, b, partials, num_visits,
        rows, d, b_tile, chunk, s);
  if (value_type == VALUE_BF16 && index_type == INDEX_I32)
    return repro::row_tile_spmm<__nv_bfloat16, int32_t, float>(
        visit_ptr, chunk_slabs, cols, slots, vals, b, partials, num_visits,
        rows, d, b_tile, chunk, s);
  if (value_type == VALUE_BF16 && index_type == INDEX_I16)
    return repro::row_tile_spmm<__nv_bfloat16, int16_t, float>(
        visit_ptr, chunk_slabs, cols, slots, vals, b, partials, num_visits,
        rows, d, b_tile, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
