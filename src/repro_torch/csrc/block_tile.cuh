// Dense t x t block times a t x 32 B tile, accumulated in registers: the
// body of the generic BCSR kernel (bcsr_spmm.cu), which serves every shape
// the t = 64 variants do not take.
//
// A thread block has 256 threads laid out as 32 columns x 8 row groups; the
// thread (ty, tx) owns column tx of the block's 32-column C slice and rows
// ty, ty + 8, ty + 16, ... of the t-row C tile (at most 16 rows, t <= 128).
// Each step stages the A block (t * t) and the B tile (t x 32) in shared
// memory as fp32 and runs fp32 FMAs on the CUDA cores.  A bf16 x bf16
// product is exact in fp32 and the FMA rounds only the sum, matching the
// reference's `jnp.dot(..., preferred_element_type=float32)`.  Every warp
// reads one A row element at a time (a shared-memory broadcast) and 32
// consecutive B tile elements (no bank conflict).
#pragma once

#include "common.cuh"

namespace repro {

constexpr int BLOCK_COLS = 32;
constexpr int BLOCK_ROW_GROUPS = 8;
constexpr int BLOCK_THREADS = BLOCK_COLS * BLOCK_ROW_GROUPS;
constexpr int BLOCK_MAX_T = 128;
constexpr int BLOCK_ACC = BLOCK_MAX_T / BLOCK_ROW_GROUPS;

// Dynamic shared memory of one block: the fp32 A block and B tile.
inline size_t block_tile_smem(int t) {
  return sizeof(float) * (static_cast<size_t>(t) * t +
                          static_cast<size_t>(t) * BLOCK_COLS);
}

// acc += A (t x t, row-major at `a`) @ B[b_row0 : b_row0 + t, col0 : col0
// + 32].  Every thread of the block must call it (it synchronises).
template <typename V>
__device__ __forceinline__ void accumulate_block(
    const V* __restrict__ a, const V* __restrict__ b, long long b_row0,
    int d, int col0, int t, float* As, float* Bs, float (&acc)[BLOCK_ACC]) {
  __syncthreads();  // the previous step's readers are done with As / Bs
  const int tt = t * t;
  for (int i = threadIdx.x; i < tt; i += BLOCK_THREADS) As[i] = to_f32(a[i]);
  for (int i = threadIdx.x; i < t * BLOCK_COLS; i += BLOCK_THREADS) {
    const int r = i / BLOCK_COLS;
    const int col = col0 + i % BLOCK_COLS;
    Bs[i] = col < d ? to_f32(b[(b_row0 + r) * d + col]) : 0.f;
  }
  __syncthreads();
  const int tx = threadIdx.x % BLOCK_COLS;
  const int ty = threadIdx.x / BLOCK_COLS;
  for (int k = 0; k < t; ++k) {
    const float bv = Bs[k * BLOCK_COLS + tx];
#pragma unroll
    for (int j = 0; j < BLOCK_ACC; ++j) {
      const int r = ty + j * BLOCK_ROW_GROUPS;
      if (r < t) acc[j] = fmaf(As[r * t + k], bv, acc[j]);
    }
  }
}

// C[row0 : row0 + t, col0 : col0 + 32] = acc, cast to the operand dtype.
template <typename V>
__device__ __forceinline__ void store_tile(V* __restrict__ c, long long row0,
                                           int d, int col0, int t,
                                           const float (&acc)[BLOCK_ACC]) {
  const int col = col0 + threadIdx.x % BLOCK_COLS;
  const int ty = threadIdx.x / BLOCK_COLS;
  if (col >= d) return;
#pragma unroll
  for (int j = 0; j < BLOCK_ACC; ++j) {
    const int r = ty + j * BLOCK_ROW_GROUPS;
    if (r < t) c[(row0 + r) * d + col] = from_f32<V>(acc[j]);
  }
}

// Allow a kernel more than the default 48 KB of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
