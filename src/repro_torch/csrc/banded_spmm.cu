// Banded SpMM: C[block row i] = sum_{o < 2w+1} band[i, o] @ B[clip(i+o-w)].
//
// Replaces the TPU kernel `banded_spmm_pallas`
// (src/repro/kernels/banded_spmm.py, body `_banded_kernel`).  The layout is
// the reference's `band_to_blocks` tensor band[nb, 2w+1, t, t], with zero
// blocks at the edges so the clamped B tile index never needs a mask.
//
// What bounds it on the card: the band tensor.  It stores every t x t block
// the band touches densely, so at t = 128 and a few diagonals it holds far
// more bytes and FLOPs than the nonzeros need; the kernel streams it once
// and B about (2w+1) times through L2.  At t = 128 the kernel is near the
// fp32 CUDA-core ridge, so the padded FLOPs are what it pays for.
//
// What the design does about it: one block per (block row, 32-column
// slice) loops over the 2w+1 band blocks (block_tile.cuh), keeping the C
// tile in registers and writing it once.  t ranges from 1 to 128; at t =
// 128 the fp32 A block alone is 64 KB of shared memory, which the launch
// allows with the dynamic shared-memory attribute.
#include "block_tile.cuh"

namespace {

template <typename V>
__global__ void __launch_bounds__(repro::BLOCK_THREADS)
    banded_kernel(const V* __restrict__ band, const V* __restrict__ b,
                  V* __restrict__ c, int nb, int W, int w, int t, int d) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = smem + t * t;
  const int i = blockIdx.x;
  const int col0 = blockIdx.y * repro::BLOCK_COLS;
  float acc[repro::BLOCK_ACC];
#pragma unroll
  for (int j = 0; j < repro::BLOCK_ACC; ++j) acc[j] = 0.f;
  const long long tt = static_cast<long long>(t) * t;
  for (int o = 0; o < W; ++o) {
    int cb = i + o - w;
    cb = cb < 0 ? 0 : (cb > nb - 1 ? nb - 1 : cb);
    repro::accumulate_block<V>(band + (static_cast<long long>(i) * W + o) * tt,
                               b, static_cast<long long>(cb) * t, d, col0, t,
                               As, Bs, acc);
  }
  repro::store_tile<V>(c, static_cast<long long>(i) * t, d, col0, t, acc);
}

template <typename V>
cudaError_t launch(const void* band, const void* b, void* c, int nb, int W,
                   int w, int t, int d, cudaStream_t stream) {
  const size_t smem = repro::block_tile_smem(t);
  cudaError_t err = repro::allow_smem(banded_kernel<V>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(static_cast<unsigned>(nb),
            (d + repro::BLOCK_COLS - 1) / repro::BLOCK_COLS);
  banded_kernel<V><<<grid, repro::BLOCK_THREADS, smem, stream>>>(
      static_cast<const V*>(band), static_cast<const V*>(b),
      static_cast<V*>(c), nb, W, w, t, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" int banded_spmm_launch(int value_type, const void* band,
                                  const void* b, void* c, int nb, int W,
                                  int w, int t, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t < 1 || t > repro::BLOCK_MAX_T || W != 2 * w + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (value_type == repro::VALUE_F32)
    return launch<float>(band, b, c, nb, W, w, t, d, s);
  if (value_type == repro::VALUE_BF16)
    return launch<__nv_bfloat16>(band, b, c, nb, W, w, t, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
