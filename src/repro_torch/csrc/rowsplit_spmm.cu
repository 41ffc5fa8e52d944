// Row-split SpMM: equal-nnz chunks into per-chunk row-window partials.
//
// Replaces the TPU kernel `rowsplit_spmm_pallas`
// (src/repro/kernels/binned_spmm.py, body `_rowsplit_kernel`).  The layout
// is the reference's `pack_rowsplit_chunks` packing, unchanged: chunk c
// holds exactly `chunk` nonzeros of the row-major stream (global columns,
// zero padding at the end), and `slots[c, e]` is the nonzero's row within
// the chunk's window of `window` rows.  The TPU kernel reduces a chunk
// into its window with a one-hot matmul; here the slots are used directly.
//
// What bounds it on the card: bytes.  Every nonzero gathers one B row
// (d values) and the kernel writes a private fp32 window of window x d
// values per chunk, so the partials cost 2 * chunks * window * d * 4
// extra bytes (written here, read by the fold).  There is no hub-row
// serialisation: every block does the same `chunk` nonzeros.
//
// What the design does about it: one thread block per (chunk, column
// slice), one thread per column of C.  Inside a chunk the slots never
// decrease (the packer ranks the nonzeros in row-major order, and the
// padding repeats the last slot with value 0), so each thread keeps one
// fp32 register accumulator and flushes it to its slot of the window when
// the slot changes.  Every slot of the window is written exactly once:
// slots past the chunk's last row are written as zeros, because
// `row_map` maps them to real rows of later chunks, not to the sentinel.
// The chunk's indices and values are the same for every thread (broadcast
// loads); the B row loads are coalesced across the warp.  Products round
// at the operand dtype and sums run in fp32, as in row_tile.cuh.  The
// wrapper folds the partials with an fp32 index_add_ over `row_map`.
#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 128;

template <typename V, typename I>
__global__ void rowsplit_kernel(const I* __restrict__ cols,
                                const I* __restrict__ slots,
                                const V* __restrict__ vals,
                                const V* __restrict__ b,
                                float* __restrict__ partials, int window,
                                int d, int chunk) {
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= d) return;
  const long long c = blockIdx.x;
  const long long e0 = c * chunk;
  float* out = partials + c * window * static_cast<long long>(d) + col;
  int cur = 0;
  float acc = 0.f;
  for (int e = 0; e < chunk; ++e) {
    const int slot = repro::to_i32(slots[e0 + e]);
    if (slot != cur) {  // the same branch for every thread of the block
      out[static_cast<long long>(cur) * d] = acc;
      for (int s = cur + 1; s < slot; ++s)
        out[static_cast<long long>(s) * d] = 0.f;
      cur = slot;
      acc = 0.f;
    }
    const float v = repro::to_f32(vals[e0 + e]);
    const long long row = repro::to_i32(cols[e0 + e]);
    acc += repro::round_product<V>(repro::to_f32(b[row * d + col]) * v);
  }
  out[static_cast<long long>(cur) * d] = acc;
  for (int s = cur + 1; s < window; ++s)
    out[static_cast<long long>(s) * d] = 0.f;
}

template <typename V, typename I>
cudaError_t launch(const void* cols, const void* slots, const void* vals,
                   const void* b, void* partials, long long num_chunks,
                   int window, int d, int chunk, cudaStream_t stream) {
  int threads = ((d + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  dim3 grid(static_cast<unsigned>(num_chunks), (d + threads - 1) / threads);
  rowsplit_kernel<V, I><<<grid, threads, 0, stream>>>(
      static_cast<const I*>(cols), static_cast<const I*>(slots),
      static_cast<const V*>(vals), static_cast<const V*>(b),
      static_cast<float*>(partials), window, d, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rowsplit_spmm_launch(int value_type, int index_type,
                                    const void* cols, const void* slots,
                                    const void* vals, const void* b,
                                    void* partials, long long num_chunks,
                                    int window, int d, int chunk,
                                    void* stream) {
  using repro::INDEX_I16;
  using repro::INDEX_I32;
  using repro::VALUE_BF16;
  using repro::VALUE_F32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_chunks < 1 || num_chunks > 0x7fffffffLL || window < 1 || d < 1 ||
      chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (value_type == VALUE_F32 && index_type == INDEX_I32)
    return launch<float, int32_t>(cols, slots, vals, b, partials,
                                  num_chunks, window, d, chunk, s);
  if (value_type == VALUE_F32 && index_type == INDEX_I16)
    return launch<float, int16_t>(cols, slots, vals, b, partials,
                                  num_chunks, window, d, chunk, s);
  if (value_type == VALUE_BF16 && index_type == INDEX_I32)
    return launch<__nv_bfloat16, int32_t>(cols, slots, vals, b, partials,
                                          num_chunks, window, d, chunk, s);
  if (value_type == VALUE_BF16 && index_type == INDEX_I16)
    return launch<__nv_bfloat16, int16_t>(cols, slots, vals, b, partials,
                                          num_chunks, window, d, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
