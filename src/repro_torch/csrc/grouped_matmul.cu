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
// What the design does about it.  fp32 (gmm_f32_kernel): one block of 256
// threads per 64 x 128 tile; each thread keeps 4 x 8 fp32 accumulators and
// runs fp32 FMAs over 16-deep k slices staged in shared memory.
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
#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;

constexpr int TM = 64;        // x rows per fp32 block
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

// A wgmma shared-memory descriptor with 128-byte swizzle (layout type 1).
// K-major A: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO).
// MN-major B: 64-column atoms 8 KB apart (LBO), 8-k-row groups 1024 bytes
// apart (SBO).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// d[64] += A (64 x 16, K-major) @ B (16 x 128, MN-major), bf16 -> fp32.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

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
        wgmma_m64n128k16(d, sw128_desc(a0 + kk * 32, 16, 1024),
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

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query so the library links against nothing but cudart.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map with 128-byte swizzle: dims/box innermost first.
bool make_map(CUtensorMap* map, const void* base, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  if (value_type == VALUE_F32) {
    dim3 grid(N / TN, static_cast<unsigned>(T / TM));
    gmm_f32_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const int*>(group_ids), static_cast<const float*>(x),
        static_cast<const float*>(w), static_cast<float*>(out), K, N, bm);
    return static_cast<int>(cudaGetLastError());
  }
  if (value_type == VALUE_BF16) {
    const int* gids = static_cast<const int*>(group_ids);
    if (bm % 128 == 0)
      return static_cast<int>(launch_bf16<128>(gids, x, w, out, T, K, N, E,
                                               bm, s));
    return static_cast<int>(launch_bf16<64>(gids, x, w, out, T, K, N, E, bm,
                                            s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
