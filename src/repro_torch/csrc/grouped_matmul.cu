// Grouped matmul: out[i*bm:(i+1)*bm] = x[i*bm:(i+1)*bm] @ w[group_ids[i]].
//
// Replaces the TPU kernel `grouped_matmul_pallas`
// (src/repro/kernels/grouped_matmul.py, body `_gmm_kernel`): the MoE
// expert FFN as a block-diagonal SpMM over expert-sorted, block-aligned
// token rows.  The TPU kernel walks (row block, n tile, k tile) in order
// and carries the output tile in VMEM across the k steps; here one thread
// block owns a TILE_M x TILE_N output tile and loops over k itself.
//
// What bounds it on the card: at fp32 operations (2 * T * K * N FLOPs on
// the CUDA cores, 67 TFLOP/s); at bf16 bytes (the expert weights, E * K *
// N values, dominate, and 989 TFLOP/s of tensor cores make the FLOPs
// cheap).
//
// What the design does about it: one thread block of 256 threads per
// (64-row tile, 128-column tile); the grid runs column tiles fastest, so
// the blocks resident at one time work on a few consecutive row tiles and
// share their experts' weights through L2.  Each k step stages the x tile
// and the w[group_ids[row0 / bm]] tile in shared memory.  A row tile never
// straddles two row blocks (bm % 64 == 0), so one expert serves the whole
// tile.  fp32: each thread keeps 4 x 8 fp32 accumulators in registers and
// runs fp32 FMAs (no TF32, as the reference accumulates full fp32).
// bf16: eight warps each own a 32 x 32 quarter-strip of the tile as 2 x 2
// `wmma` 16x16x16 bf16 fragments with fp32 accumulators; bf16 x bf16
// products are exact in fp32.  The output tile goes through shared memory
// once, is cast to the operand dtype and written once.  No TMA, wgmma or
// multi-stage pipeline yet.
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int TM = 64;        // x rows per block
constexpr int TN = 128;       // output columns per block
constexpr int THREADS = 256;

// ---- fp32: CUDA-core FMA -------------------------------------------------
constexpr int F_TK = 16;      // k-slice staged per step
constexpr int F_RM = 4;       // rows per thread
constexpr int F_CN = 8;       // columns per thread (strided by 16)

__global__ void __launch_bounds__(THREADS)
    gmm_f32_kernel(const int* __restrict__ gids, const float* __restrict__ x,
                   const float* __restrict__ w, float* __restrict__ out,
                   int K, int N, int bm) {
  // As holds the x tile transposed (k-major) so a thread reads its 4 rows
  // as one float4; the +4 pad spreads the transposing stores over banks.
  __shared__ __align__(16) float As[F_TK][TM + 4];
  __shared__ __align__(16) float Bs[F_TK][TN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long row0 = static_cast<long long>(blockIdx.y) * TM;
  const int col0 = blockIdx.x * TN;
  const long long e = gids[row0 / bm];
  const float* xb = x + row0 * K;
  const float* wb = w + e * K * N + col0;
  float acc[F_RM][F_CN];
#pragma unroll
  for (int i = 0; i < F_RM; ++i)
#pragma unroll
    for (int j = 0; j < F_CN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += F_TK) {
#pragma unroll
    for (int r = 0; r < TM * F_TK / THREADS; ++r) {
      const int i = tid + r * THREADS;
      const int m = i / F_TK;
      const int kk = i % F_TK;
      As[kk][m] = xb[static_cast<long long>(m) * K + k0 + kk];
    }
#pragma unroll
    for (int r = 0; r < F_TK * TN / THREADS; ++r) {
      const int i = tid + r * THREADS;
      const int kk = i / TN;
      const int nn = i % TN;
      Bs[kk][nn] = wb[static_cast<long long>(k0 + kk) * N + nn];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_TK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * F_RM]);
      const float a[F_RM] = {a4.x, a4.y, a4.z, a4.w};
      float bv[F_CN];
#pragma unroll
      for (int j = 0; j < F_CN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < F_RM; ++i)
#pragma unroll
        for (int j = 0; j < F_CN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < F_RM; ++i) {
    float* o = out + (row0 + ty * F_RM + i) * N + col0 + tx;
#pragma unroll
    for (int j = 0; j < F_CN; ++j) o[16 * j] = acc[i][j];
  }
}

// ---- bf16: wmma tensor-core fragments, fp32 accumulators -----------------
constexpr int H_TK = 32;      // k-slice staged per step (two 16-deep mmas)
constexpr int A_LD = H_TK + 8;
constexpr int B_LD = TN + 8;
constexpr int C_LD = TN + 4;

__global__ void __launch_bounds__(THREADS)
    gmm_bf16_kernel(const int* __restrict__ gids,
                    const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ out, int K, int N, int bm) {
  using namespace nvcuda;
  // 5,120 + 8,704 + 33,792 = 47,616 bytes of static shared memory.
  __shared__ __align__(32) __nv_bfloat16 As[TM][A_LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[H_TK][B_LD];
  __shared__ __align__(32) float Cs[TM][C_LD];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4;    // 2 warp rows of 32 x rows
  const int wn = warp % 4;    // 4 warp columns of 32 output columns
  const long long row0 = static_cast<long long>(blockIdx.y) * TM;
  const int col0 = blockIdx.x * TN;
  const long long e = gids[row0 / bm];
  const __nv_bfloat16* xb = x + row0 * K;
  const __nv_bfloat16* wb = w + e * K * N + col0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += H_TK) {
    {  // x tile, TM x H_TK: one 16-byte vector per thread.
      const int m = tid / 4;
      const int q = (tid % 4) * 8;
      *reinterpret_cast<uint4*>(&As[m][q]) = *reinterpret_cast<const uint4*>(
          xb + static_cast<long long>(m) * K + k0 + q);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // w tile, H_TK x TN: two vectors each.
      const int i = tid + r * THREADS;
      const int kk = i / 16;
      const int q = (i % 16) * 8;
      *reinterpret_cast<uint4*>(&Bs[kk][q]) = *reinterpret_cast<const uint4*>(
          wb + static_cast<long long>(k0 + kk) * N + q);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < H_TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][kk], A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[kk][wn * 32 + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16],
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
#pragma unroll 4
  for (int i = tid; i < TM * TN; i += THREADS) {
    const int m = i / TN;
    const int n = i % TN;
    out[(row0 + m) * N + col0 + n] = __float2bfloat16_rn(Cs[m][n]);
  }
}

}  // namespace

extern "C" int grouped_matmul_launch(int value_type, const void* group_ids,
                                     const void* x, const void* w, void* out,
                                     long long T, int K, int N, int bm,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T < TM || T % TM || bm < TM || bm % TM || T % bm || K < H_TK ||
      K % H_TK || N < TN || N % TN || T / TM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(N / TN, static_cast<unsigned>(T / TM));
  if (value_type == repro::VALUE_F32) {
    gmm_f32_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const int*>(group_ids), static_cast<const float*>(x),
        static_cast<const float*>(w), static_cast<float*>(out), K, N, bm);
    return static_cast<int>(cudaGetLastError());
  }
  if (value_type == repro::VALUE_BF16) {
    gmm_bf16_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const int*>(group_ids),
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), K, N, bm);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
