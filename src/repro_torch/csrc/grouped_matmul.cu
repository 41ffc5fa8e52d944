// Grouped matmul: out[i*bm:(i+1)*bm] = x[i*bm:(i+1)*bm] @ w[group_ids[i]].
//
// Replaces the TPU kernel `grouped_matmul_pallas`
// (src/repro/kernels/grouped_matmul.py, body `_gmm_kernel`): the MoE
// expert FFN as a block-diagonal SpMM over expert-sorted, block-aligned
// token rows.  The TPU kernel walks (row block, n tile, k tile) in order
// and carries the output tile in VMEM across the k steps; here one thread
// block owns an output tile and loops over k itself.  A row tile never
// straddles two row blocks, so one expert serves the whole tile.
//
// What bounds it on the card: at fp32, operations (2 * T * K * N FLOPs on
// the CUDA cores, 67 TFLOP/s; no TF32, as the reference accumulates full
// fp32).  At bf16, at qwen3-moe-235b-a22b's expert widths (K = 4096, N =
// 1536, 128 experts), bytes: the expert weights are 1.61 GB, and at 989
// TFLOP/s the FLOPs of the padded rows take about as long as streaming
// them once, so the weights must stream at close to the memory rate while
// the tensor cores run.
//
// What the design does about it.  fp32 (gmm_f32_kernel): a register-tiled
// SGEMM, true fp32 FMA (no TF32, no tensor cores).  One block of 256
// threads per 128 x 128 output tile (64 x 128 where bm % 128 != 0); each
// thread keeps 8 x 8 fp32 accumulators and reads its operands for a k step
// as 4 LDS.128, so shared-memory reads stay off the FMA pipe's way.  The
// 8-deep k-slices are double-buffered in shared memory, with the next
// slice's float4 global loads in flight during this slice's FMAs.  The
// first version (64 x 128 tiles, 4 x 8 accumulators, one buffer) issued 9
// loads per 32 FMAs and exposed every slice's global-load latency.
// bf16 (gmm_bf16_kernel): one block per BM x 128 output tile (BM = 128
// where bm % 128 == 0: two consumer warpgroups, each `wgmma.m64n128k16`;
// BM = 64 otherwise: one).  A producer warp issues TMA loads of 64-deep k
// steps into a ring of STAGES shared-memory stages -- the x tile through a
// 2-D tensor map (K-major, 128-byte swizzle) and the w[e] tile through a
// 3-D map over [E, K, N] whose expert index is a coordinate (N contiguous:
// the MN-major B operand, `wgmma`'s transpose bit) -- with full / empty
// mbarriers per stage; it lowers its registers with `setmaxnreg`.
// Consumers keep one `wgmma` group in flight, so the copies of the next
// stages overlap the math of this one, and release a stage once the group
// that read it is done.  Sums stay in fp32 registers and are cast to bf16
// once (the reference's preferred_element_type = float32).  The grid runs
// column tiles fastest: the blocks resident at one time cover a few
// consecutive row tiles, so each expert's weight tiles are shared through
// L2 and read from HBM about once.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;

// ---- fp32: register-tiled SGEMM on the CUDA cores ---------------------
constexpr int F_BN = 128;     // output columns per block
constexpr int F_BK = 8;       // k-slice per stage
constexpr int F_THREADS = 256;
constexpr int F_PAD = 4;      // As row pad: conflict-free transposing stores

// One block per BM x 128 output tile (BM = 128 or 64, dividing bm, so one
// expert serves the tile).  Thread (tx, ty) = (tid % 16, tid / 16) owns
// rows ty * 4 + {0..3} (+ 64 for BM = 128) and columns tx * 4 + {0..3} and
// tx * 4 + 64 + {0..3}: per k it reads its x values and w values as float4
// (2 + 2 LDS.128 for 64 FMAs at BM = 128).  The 8-deep k-slices are
// double-buffered: while the FMAs of slice k run from one half of the
// shared tiles, the float4 global loads of slice k + 1 are in flight into
// registers, then stored -- x transposed to k-major -- into the other half.
// One __syncthreads per slice.
// Stores one k-slice from registers into a shared stage: x transposed to
// k-major (4 scalar stores; with the pad a warp's stores hit 32 banks),
// w as one float4.
template <int BM>
__device__ __forceinline__ void store_slice(float (&as)[F_BK][BM + F_PAD],
                                            float (&bs)[F_BK][F_BN],
                                            bool a_loader, int a_row, int a_k,
                                            int b_k, int b_col, float4 a,
                                            float4 b) {
  if (a_loader) {
    as[a_k + 0][a_row] = a.x;
    as[a_k + 1][a_row] = a.y;
    as[a_k + 2][a_row] = a.z;
    as[a_k + 3][a_row] = a.w;
  }
  *reinterpret_cast<float4*>(&bs[b_k][b_col]) = b;
}

template <int BM>
__global__ void __launch_bounds__(F_THREADS, 2)
    gmm_f32_kernel(const int* __restrict__ gids, const float* __restrict__ x,
                   const float* __restrict__ w, float* __restrict__ out,
                   int K, int N, int bm) {
  constexpr int RG = BM / 64;   // groups of 4 rows per thread, 64 apart
  constexpr int RM = 4 * RG;
  __shared__ __align__(16) float As[2][F_BK][BM + F_PAD];
  __shared__ __align__(16) float Bs[2][F_BK][F_BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long row0 = static_cast<long long>(blockIdx.y) * BM;
  const int col0 = blockIdx.x * F_BN;
  const long long e = gids[row0 / bm];
  // Global loads per slice: x row a_row, k a_k..a_k+3 (the first 2 * BM
  // threads); w k-row b_k, columns b_col..b_col+3 (every thread).
  const bool a_loader = tid < 2 * BM;
  const int a_row = (tid / 2) % BM;
  const int a_k = (tid % 2) * 4;
  const int b_k = tid / 32;
  const int b_col = (tid % 32) * 4;
  const float* xp = x + (row0 + a_row) * K + a_k;
  const float* wp = w + (e * K + b_k) * N + col0 + b_col;
  const long long w_step = static_cast<long long>(F_BK) * N;

  float acc[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 a_next = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 b_next = *reinterpret_cast<const float4*>(wp);
  if (a_loader) a_next = *reinterpret_cast<const float4*>(xp);
  store_slice<BM>(As[0], Bs[0], a_loader, a_row, a_k, b_k, b_col, a_next,
                  b_next);
  __syncthreads();

  const int steps = K / F_BK;
  for (int kt = 0; kt < steps; ++kt) {
    const int s = kt & 1;
    const bool more = kt + 1 < steps;
    if (more) {
      b_next = *reinterpret_cast<const float4*>(wp + (kt + 1) * w_step);
      if (a_loader)
        a_next = *reinterpret_cast<const float4*>(xp + (kt + 1) * F_BK);
    }
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[RM], bv[8];
#pragma unroll
      for (int g = 0; g < RG; ++g) {
        const float4 t =
            *reinterpret_cast<const float4*>(&As[s][kk][ty * 4 + 64 * g]);
        a[4 * g + 0] = t.x;
        a[4 * g + 1] = t.y;
        a[4 * g + 2] = t.z;
        a[4 * g + 3] = t.w;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 t =
            *reinterpret_cast<const float4*>(&Bs[s][kk][tx * 4 + 64 * h]);
        bv[4 * h + 0] = t.x;
        bv[4 * h + 1] = t.y;
        bv[4 * h + 2] = t.z;
        bv[4 * h + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    // The other half was last read in slice kt - 1, before the barrier
    // that ended it.
    if (more)
      store_slice<BM>(As[s ^ 1], Bs[s ^ 1], a_loader, a_row, a_k, b_k, b_col,
                      a_next, b_next);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float* o = out + (row0 + ty * 4 + 64 * (i / 4) + i % 4) * N + col0 +
               tx * 4;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(o + 64 * h) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                      acc[i][4 * h + 3]);
  }
}

template <int BM>
cudaError_t launch_f32(const int* gids, const void* x, const void* w,
                       void* out, long long T, int K, int N, int bm,
                       cudaStream_t stream) {
  const dim3 grid(N / F_BN, static_cast<unsigned>(T / BM));
  gmm_f32_kernel<BM><<<grid, F_THREADS, 0, stream>>>(
      gids, static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), K, N, bm);
  return cudaGetLastError();
}

// ---- bf16: TMA ring feeding wgmma ----------------------------------------
constexpr int BN = 128;           // output columns per block
constexpr int BK = 64;            // k step: one 128-byte swizzle row of bf16
constexpr int HALF_B_BYTES = BK * 64 * 2;  // one 64-column half of a w tile

template <int BM>
struct Tile {
  static constexpr int CONSUMERS = BM / 64;          // warpgroups on wgmma
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = BM == 128 ? 6 : 8;   // 192 KB of ring
  static constexpr size_t SMEM =
      static_cast<size_t>(STAGES) * STAGE_BYTES + 1024 + 2 * STAGES * 8;
};

template <int BM>
__global__ void __launch_bounds__(Tile<BM>::THREADS, 1)
    gmm_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const int* __restrict__ gids,
                    __nv_bfloat16* __restrict__ out, int K, int N, int bm) {
  using T = Tile<BM>;
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles need 1024-byte alignment.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sa = smem;
  unsigned char* sb = smem + T::STAGES * T::A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + T::STAGES * T::B_BYTES);
  uint64_t* empty = full + T::STAGES;
  const int n0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;
  const int steps = K / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer warpgroup: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int e = gids[row0 / bm];
      for (int kt = 0; kt < steps; ++kt) {
        const int s = kt % T::STAGES;
        mbar_wait(&empty[s], ((kt / T::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], T::STAGE_BYTES);
        unsigned char* b_tile = sb + s * T::B_BYTES;
        tma_load_2d(sa + s * T::A_BYTES, &xmap, &full[s], kt * BK, row0);
        tma_load_3d(b_tile, &wmap, &full[s], n0, kt * BK, e);
        tma_load_3d(b_tile + HALF_B_BYTES, &wmap, &full[s], n0 + 64, kt * BK,
                    e);
      }
    }
  } else {
    // Consumer warpgroup c owns rows [64 c, 64 c + 64) of the tile.
    const int c = wg - 1;
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    for (int kt = 0; kt < steps; ++kt) {
      const int s = kt % T::STAGES;
      mbar_wait(&full[s], (kt / T::STAGES) & 1);
      const uint32_t a0 = smem_addr(sa + s * T::A_BYTES + c * 64 * 128);
      const uint32_t b0 = smem_addr(sb + s * T::B_BYTES);
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_bf16<BN>(d, sw128_desc(a0 + kk * 32, 16, 1024),
                       sw128_desc(b0 + kk * 16 * 128, HALF_B_BYTES, 1024));
      wgmma_commit();
      fence_acc(d);
      // The group before this one is done: release its stage.
      wgmma_wait<1>();
      fence_acc(d);
      if (kt > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(&empty[(kt - 1) % T::STAGES]);
    }
    wgmma_wait<0>();
    fence_acc(d);
    // Accumulator layout of m64n128: warp w holds rows 16 w + lane / 4
    // (+ 8); register 4 j + {0, 1} covers columns 8 j + 2 (lane % 4) + {0,
    // 1} of the first row, 4 j + {2, 3} the same columns 8 rows down.
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const long long r = row0 + c * 64 + warp * 16 + lane / 4;
    __nv_bfloat16* o0 = out + r * N + n0 + 2 * (lane % 4);
    __nv_bfloat16* o1 = o0 + 8LL * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
          __floats2bfloat162_rn(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
          __floats2bfloat162_rn(d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

template <int BM>
cudaError_t launch_bf16(const int* gids, const void* x, const void* w,
                        void* out, long long T, int K, int N, int E, int bm,
                        cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(K),
                               static_cast<cuuint64_t>(T)};
  const cuuint64_t xstrides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t xbox[2] = {BK, BM};
  const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(N),
                               static_cast<cuuint64_t>(K),
                               static_cast<cuuint64_t>(E)};
  const cuuint64_t wstrides[2] = {static_cast<cuuint64_t>(N) * 2,
                                  static_cast<cuuint64_t>(K) * N * 2};
  const cuuint32_t wbox[3] = {64, BK, 1};
  if (!make_map(&xmap, x, 2, xdims, xstrides, xbox) ||
      !make_map(&wmap, w, 3, wdims, wstrides, wbox))
    return cudaErrorNotSupported;
  using Tl = Tile<BM>;
  cudaError_t err = cudaFuncSetAttribute(
      gmm_bf16_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tl::SMEM));
  if (err != cudaSuccess) return err;
  dim3 grid(N / BN, static_cast<unsigned>(T / BM));
  gmm_bf16_kernel<BM><<<grid, Tl::THREADS, Tl::SMEM, stream>>>(
      xmap, wmap, gids, static_cast<__nv_bfloat16*>(out), K, N, bm);
  return cudaGetLastError();
}

}  // namespace

extern "C" int grouped_matmul_launch(int value_type, const void* group_ids,
                                     const void* x, const void* w, void* out,
                                     long long T, int K, int N, int E, int bm,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T < 64 || bm < 64 || bm % 64 || T % bm || K < BK || K % BK ||
      N < BN || N % BN || E < 1 || T / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* gids = static_cast<const int*>(group_ids);
  if (value_type == VALUE_F32) {
    if (bm % 128 == 0)
      return static_cast<int>(launch_f32<128>(gids, x, w, out, T, K, N, bm,
                                              s));
    return static_cast<int>(launch_f32<64>(gids, x, w, out, T, K, N, bm, s));
  }
  if (value_type == VALUE_BF16) {
    if (bm % 128 == 0)
      return static_cast<int>(launch_bf16<128>(gids, x, w, out, T, K, N, E,
                                               bm, s));
    return static_cast<int>(launch_bf16<64>(gids, x, w, out, T, K, N, E, bm,
                                            s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
