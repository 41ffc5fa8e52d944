// BCSR SpMM: C[block row i] = sum over the row's blocks of A_blk @ B[col].
//
// Replaces the TPU kernel `bcsr_spmm_pallas`
// (src/repro/kernels/bcsr_spmm.py, body `_bcsr_kernel`).  The layout is the
// reference's: dense t x t blocks sorted by (block row, block column), the
// block row pointer `block_ptr[nb + 1]`, and `pad_empty_block_rows`'s zero
// block for every block row that has none.
//
// What bounds it on the card: at t = 64 a stored block carries 64 * 64 *
// 2 * d FLOPs for 16 KB of fp32 values, so a dense-block operator sits
// near the fp32 CUDA-core ridge; with sparse blocks (low fill) the padded
// FLOPs are wasted work.  This kernel runs on CUDA cores, so its ceiling is
// the fp32 CUDA-core rate; a tensor-core (wgmma) version is a later change.
//
// What the design does about it: one block per (block row, 32-column
// slice) walks its block row (block_tile.cuh).  The C tile stays in
// registers across the row's blocks and is written once, in the operand
// dtype.  A and the B tile are staged in shared memory as fp32.
#include "block_tile.cuh"

namespace {

template <typename V>
__global__ void __launch_bounds__(repro::BLOCK_THREADS)
    bcsr_kernel(const int* __restrict__ block_ptr,
                const int* __restrict__ block_cols,
                const V* __restrict__ blocks, const V* __restrict__ b,
                V* __restrict__ c, int t, int d) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = smem + t * t;
  const long long br = blockIdx.x;
  const int col0 = blockIdx.y * repro::BLOCK_COLS;
  float acc[repro::BLOCK_ACC];
#pragma unroll
  for (int j = 0; j < repro::BLOCK_ACC; ++j) acc[j] = 0.f;
  const int i1 = block_ptr[br + 1];
  const long long tt = static_cast<long long>(t) * t;
  for (int i = block_ptr[br]; i < i1; ++i) {
    repro::accumulate_block<V>(blocks + i * tt, b,
                               static_cast<long long>(block_cols[i]) * t, d,
                               col0, t, As, Bs, acc);
  }
  repro::store_tile<V>(c, br * t, d, col0, t, acc);
}

template <typename V>
cudaError_t launch(const void* block_ptr, const void* block_cols,
                   const void* blocks, const void* b, void* c, long long nb,
                   int t, int d, cudaStream_t stream) {
  const size_t smem = repro::block_tile_smem(t);
  cudaError_t err = repro::allow_smem(bcsr_kernel<V>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(static_cast<unsigned>(nb),
            (d + repro::BLOCK_COLS - 1) / repro::BLOCK_COLS);
  bcsr_kernel<V><<<grid, repro::BLOCK_THREADS, smem, stream>>>(
      static_cast<const int*>(block_ptr), static_cast<const int*>(block_cols),
      static_cast<const V*>(blocks), static_cast<const V*>(b),
      static_cast<V*>(c), t, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bcsr_spmm_launch(int value_type, const void* block_ptr,
                                const void* block_cols, const void* blocks,
                                const void* b, void* c, long long nb, int t,
                                int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t < 1 || t > repro::BLOCK_MAX_T)
    return static_cast<int>(cudaErrorInvalidValue);
  if (value_type == repro::VALUE_F32)
    return launch<float>(block_ptr, block_cols, blocks, b, c, nb, t, d, s);
  if (value_type == repro::VALUE_BF16)
    return launch<__nv_bfloat16>(block_ptr, block_cols, blocks, b, c, nb, t,
                                 d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
