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
//
// At d <= 32 instructions bound it, not bytes.  The wide walk
// (csr_piece_kernel) gives every warp a 64-column slice, so each entry
// costs the whole warp three shuffles, the address arithmetic, two
// predicated loads and an 8-row select over two columns, about 45 warp
// instructions whatever d is; at d = 4 only 4 lanes load.  The narrow
// walk (csr_narrow_kernel, d <= 32) spends L lanes on an entry, L the
// smallest power of two >= d, one column each: the warp walks 32 / L
// entries of a piece per step, each shuffle serves them all, and each
// lane keeps one column of the 8 rows.  At the end of a piece the groups'
// rows are summed with __shfl_xor_sync, and group 0 stores them as the
// wide walk does.  The order of the sums within a row changes with L; the
// rounding contract does not.  The host picks the walk and L from d
// (kernels/csr_spmm.py::csr_variant), and the launcher refuses a choice
// that does not fit d.
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
  store_piece_rows<O>(p, col0 + lane, acc, touched, piece_owner,
                      piece_split, out, split_acc, out_rows, d);
}

// One warp per piece, L lanes per entry (d <= L <= 32): the narrow walk,
// then group 0 (lanes 0 .. L - 1, one column each) stores the piece's
// rows or adds its touched rows into the split tiles' buffer.
template <typename V, typename I, typename O, int L>
__global__ void __launch_bounds__(PIECE_WARPS* WARP) csr_narrow_kernel(
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
  const int col = threadIdx.x & (WARP - 1);
  float acc[ROW_TILE];
  const unsigned touched = walk_piece_narrow<V, I, L>(
      piece_ptr[p], piece_ptr[p + 1], chunk_len, chunk_slabs, cols, slots,
      vals, b, d, b_tile, chunk, acc);
  if (col >= d) return;  // col < d <= L: group 0
  float rows[ROW_TILE][1];
#pragma unroll
  for (int r = 0; r < ROW_TILE; ++r) rows[r][0] = acc[r];
  store_piece_rows<O>(p, col, rows, touched, piece_owner, piece_split, out,
                      split_acc, out_rows, d);
}

// The launcher's walk codes, in the order of kernels/csr_spmm.py VARIANTS.
constexpr int CSR_WIDE = 0;
constexpr int CSR_NARROW = 1;

template <typename V, typename I, typename O>
using PieceKernel = void (*)(const int*, const int*, const int*, const int*,
                             const int*, const I*, const I*, const V*,
                             const V*, O*, float*, long long, long long, int,
                             long long, int);

// The kernel of a walk: the wide one, or the narrow one at `lanes` lanes
// per entry; nullptr where the choice does not fit d.
template <typename V, typename I, typename O>
PieceKernel<V, I, O> piece_kernel(int variant, int lanes, int d) {
  if (variant == CSR_WIDE) return csr_piece_kernel<V, I, O>;
  if (variant != CSR_NARROW || lanes < d) return nullptr;
  switch (lanes) {
    case 1: return csr_narrow_kernel<V, I, O, 1>;
    case 2: return csr_narrow_kernel<V, I, O, 2>;
    case 4: return csr_narrow_kernel<V, I, O, 4>;
    case 8: return csr_narrow_kernel<V, I, O, 8>;
    case 16: return csr_narrow_kernel<V, I, O, 16>;
    case 32: return csr_narrow_kernel<V, I, O, 32>;
    default: return nullptr;
  }
}

template <typename V, typename I, typename O>
cudaError_t csr_spmm(int variant, int lanes, const void* piece_ptr,
                     const void* piece_owner, const void* piece_split,
                     const void* split_tiles, const void* chunk_len,
                     const void* chunk_slabs, const void* cols,
                     const void* slots, const void* vals, const void* b,
                     void* c, void* split_acc, long long num_pieces,
                     long long num_split, long long out_rows, int d,
                     long long b_tile, int chunk, cudaStream_t stream) {
  const PieceKernel<V, I, O> kernel = piece_kernel<V, I, O>(variant, lanes, d);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  if (num_pieces == 0) return cudaSuccess;
  dim3 grid, block;
  piece_launch_shape(num_pieces, d, &grid, &block);
  kernel<<<grid, block, 0, stream>>>(
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
    int variant, int lanes, int value_type, int index_type,
    const void* piece_ptr, const void* piece_owner, const void* piece_split,
    const void* split_tiles, const void* chunk_len, const void* chunk_slabs,
    const void* cols, const void* slots, const void* vals, const void* b,
    void* c, void* split_acc, long long num_pieces, long long num_split,
    long long n, int d, long long b_tile, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_CSR(V, I)                                                      \
  repro::csr_spmm<V, I, V>(variant, lanes, piece_ptr, piece_owner,          \
                           piece_split, split_tiles, chunk_len, chunk_slabs, \
                           cols, slots, vals, b, c, split_acc, num_pieces,   \
                           num_split, n, d, b_tile, chunk, s)
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
