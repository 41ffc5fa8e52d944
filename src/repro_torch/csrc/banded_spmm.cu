// Banded SpMM as a walk over the stored diagonals:
//     C[r, :] = sum_j diags[j, r] * B[r + offsets[j], :]
//
// Replaces the TPU kernel `banded_spmm_pallas`
// (src/repro/kernels/banded_spmm.py, body `_banded_kernel`).  The TPU
// kernel multiplies the dense t x t blocks of the reference's band tensor
// on the matrix unit; this one walks DIA storage as the pack builds it,
// the k stored diagonals `diags[k, n]` and their sorted offsets, and no
// band is packed.
//
// What bounds it on the card: bytes -- B read once, C written once and
// the k * n diagonal values, 2 * k * n * d FMAs that the CUDA cores finish
// long before.  It no longer reads the band: at t = 128 that tensor stores
// ~47 slots per nonzero, and multiplying its blocks issued ~50x the useful
// FLOPs.
//
// What the design does about it: one block of 256 threads per tile of
// ROWS output rows by a COLS-wide column slice.  The block stages its
// diagonal values (k x ROWS) and the B window that the tile's rows reach,
// rows [r0 + offsets[0], r0 + ROWS + offsets[k-1]) clipped to [0, n), in
// shared memory with asynchronous copies: one `cp.async.bulk` on an
// mbarrier when the window's rows are contiguous (the slice is all of d),
// 16-byte `cp.async` otherwise, plain loads for widths that are not
// 16-byte multiples.  Neighbouring tiles share the window's few edge rows
// through L2, so B comes from HBM about once.  Each thread owns 8 rows x 4
// columns of C in fp32 registers and walks the k diagonals; a bf16 x bf16
// product is exact in fp32.  C is written once, cast to the operand dtype,
// with no atomics.  When the window would not fit the shared-memory budget
// (a wide offset span), the block reads B through L1 (`__ldg`) instead.
// The launch reports the mode it chose, so the caller can count them.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;

constexpr int ROWS = 128;                         // output rows per block
constexpr int COLS = 64;                          // C columns per block
constexpr int THREADS = 256;
constexpr int COL_GROUPS = COLS / 4;              // 16 threads x 4 columns
constexpr int ROW_GROUPS = THREADS / COL_GROUPS;  // 16
constexpr int ROWS_PER_THREAD = ROWS / ROW_GROUPS;  // 8
constexpr int MAX_DIAGS = 64;
// Shared memory a block may use for its B window (the walk keeps several
// blocks resident per SM below it).
constexpr size_t WINDOW_BUDGET = 96 * 1024;

// How a block stages its B window.
enum Window : int {
  WINDOW_BULK = 0,     // one cp.async.bulk: rows contiguous (the slice is d)
  WINDOW_ASYNC16 = 1,  // 16-byte cp.async per chunk of a row
  WINDOW_SCALAR = 2,   // plain loads (row bytes not a multiple of 16)
  WINDOW_NONE = 3,     // no window: B through L1
};

struct Offsets {
  int v[MAX_DIAGS];
};

template <typename V>
struct Vec4;
template <>
struct Vec4<float> {
  __device__ static float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static float4 ldg(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void store(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};
template <>
struct Vec4<__nv_bfloat16> {
  __device__ static float4 unpack(uint2 u) {
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    const float2 a = __bfloat1622float2(lo);
    const float2 b = __bfloat1622float2(hi);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  __device__ static float4 load(const __nv_bfloat16* p) {
    return unpack(*reinterpret_cast<const uint2*>(p));
  }
  __device__ static float4 ldg(const __nv_bfloat16* p) {
    return unpack(__ldg(reinterpret_cast<const uint2*>(p)));
  }
  __device__ static void store(__nv_bfloat16* p, float4 v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

// Four B values of one row from the window (always 4-aligned) or from
// global memory (vector when `vec`, else scalar with a column guard).
template <typename V, bool kWindow>
__device__ __forceinline__ float4 b_row4(const V* win, int ws, int win_row,
                                         const V* __restrict__ b,
                                         long long src, int d, int col,
                                         bool vec) {
  if (kWindow) return Vec4<V>::load(win + win_row * ws + col);
  const V* p = b + src * d + col;
  if (vec) return Vec4<V>::ldg(p);
  float x[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) x[q] = col + q < d ? to_f32(__ldg(p + q)) : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

template <typename V, bool kWindow>
__device__ __forceinline__ void walk(const V* s_diag, const V* win, int ws,
                                     long long lo, const V* __restrict__ b,
                                     const Offsets& off, int k, long long r0,
                                     int rows, long long n, int d, int col,
                                     bool interior, bool vec,
                                     float (&acc)[ROWS_PER_THREAD][4]) {
  const int rg = threadIdx.x / COL_GROUPS;
  for (int j = 0; j < k; ++j) {
    const int delta = off.v[j];
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i) {
      const int rl = rg + i * ROW_GROUPS;
      const long long src = r0 + rl + delta;
      if (!interior && (rl >= rows || src < 0 || src >= n)) continue;
      const float a = to_f32(s_diag[j * ROWS + rl]);
      const float4 v = b_row4<V, kWindow>(win, ws, static_cast<int>(src - lo),
                                          b, src, d, col, vec);
      acc[i][0] = fmaf(a, v.x, acc[i][0]);
      acc[i][1] = fmaf(a, v.y, acc[i][1]);
      acc[i][2] = fmaf(a, v.z, acc[i][2]);
      acc[i][3] = fmaf(a, v.w, acc[i][3]);
    }
  }
}

template <typename V>
__global__ void __launch_bounds__(THREADS)
    banded_walk_kernel(const V* __restrict__ diags, const V* __restrict__ b,
                       V* __restrict__ c, long long n, int d, int k,
                       const __grid_constant__ Offsets off, int mode,
                       bool diags16, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar;
  V* s_diag = reinterpret_cast<V*>(smem);
  V* win = reinterpret_cast<V*>(smem + static_cast<size_t>(k) * ROWS *
                                           sizeof(V));
  const long long r0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int col0 = blockIdx.y * COLS;
  const int rows = static_cast<int>(n - r0 < ROWS ? n - r0 : ROWS);
  const int ncols = d - col0 < COLS ? d - col0 : COLS;
  const int dmin = off.v[0];
  const int dmax = off.v[k - 1];
  long long lo = r0 + dmin;
  long long hi = r0 + rows + dmax;
  lo = lo < 0 ? 0 : lo;
  hi = hi > n ? n : hi;
  const int wrows = hi > lo ? static_cast<int>(hi - lo) : 0;
  const int ws = mode == WINDOW_BULK ? d : COLS;  // window row stride

  if (mode == WINDOW_BULK && threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (mode == WINDOW_BULK && threadIdx.x == 0) {
    const uint32_t bytes = static_cast<uint32_t>(wrows) * d * sizeof(V);
    mbar_expect_tx(&bar, bytes);
    if (bytes) bulk_load(win, b + lo * d, bytes, &bar);
  }
  // The diagonal values of the tile: k rows of ROWS values.
  if (diags16 && rows == ROWS) {
    constexpr int per_row = ROWS * sizeof(V) / 16;
    for (int i = threadIdx.x; i < k * per_row; i += THREADS) {
      const int j = i / per_row;
      const int q = i % per_row;
      cp_async16(reinterpret_cast<unsigned char*>(s_diag + j * ROWS) + 16 * q,
                 reinterpret_cast<const unsigned char*>(diags + j * n + r0) +
                     16 * q);
    }
  } else {
    for (int i = threadIdx.x; i < k * ROWS; i += THREADS) {
      const int j = i / ROWS;
      const int rl = i % ROWS;
      s_diag[i] = rl < rows ? diags[j * n + r0 + rl] : from_f32<V>(0.f);
    }
  }
  if (mode == WINDOW_ASYNC16) {
    const int per_row = ncols * static_cast<int>(sizeof(V)) / 16;
    for (int i = threadIdx.x; i < wrows * per_row; i += THREADS) {
      const int r = i / per_row;
      const int q = i % per_row;
      cp_async16(reinterpret_cast<unsigned char*>(win + r * ws) + 16 * q,
                 reinterpret_cast<const unsigned char*>(
                     b + (lo + r) * d + col0) + 16 * q);
    }
  } else if (mode == WINDOW_SCALAR) {
    for (int i = threadIdx.x; i < wrows * COLS; i += THREADS) {
      const int r = i / COLS;
      const int q = i % COLS;
      win[r * ws + q] = q < ncols ? b[(lo + r) * d + col0 + q]
                                  : from_f32<V>(0.f);
    }
  }
  cp_async_wait_all();
  if (mode == WINDOW_BULK) mbar_wait(&bar, 0);
  __syncthreads();

  const int cl = (threadIdx.x % COL_GROUPS) * 4;  // local column
  if (cl >= ncols) return;
  const bool interior = r0 + dmin >= 0 && r0 + ROWS + dmax <= n &&
                        rows == ROWS;
  float acc[ROWS_PER_THREAD][4];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  if (mode == WINDOW_NONE)
    walk<V, false>(s_diag, win, ws, lo, b, off, k, r0, rows, n, d,
                   col0 + cl, interior, vec, acc);
  else
    walk<V, true>(s_diag, win, ws, lo, b, off, k, r0, rows, n, d, cl,
                  interior, vec, acc);

  const int rg = threadIdx.x / COL_GROUPS;
  const int col = col0 + cl;
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int rl = rg + i * ROW_GROUPS;
    if (rl >= rows) continue;
    V* p = c + (r0 + rl) * d + col;
    if (vec) {
      Vec4<V>::store(p, make_float4(acc[i][0], acc[i][1], acc[i][2],
                                    acc[i][3]));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (col + q < d) p[q] = from_f32<V>(acc[i][q]);
    }
  }
}

template <typename V>
cudaError_t launch(const void* diags, const void* b, void* c, long long n,
                   int d, int k, const int* offsets, cudaStream_t stream,
                   int* mode_out) {
  Offsets off;
  for (int j = 0; j < k; ++j) off.v[j] = offsets[j];
  const size_t vs = sizeof(V);
  const int slices = (d + COLS - 1) / COLS;
  const bool row16 = d * vs % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const long long span = static_cast<long long>(off.v[k - 1]) - off.v[0];
  const long long win_rows = ROWS + span < n ? ROWS + span : n;
  int mode;
  size_t ws;
  if (slices == 1 && row16) {
    mode = WINDOW_BULK;
    ws = d;
  } else {
    mode = row16 ? WINDOW_ASYNC16 : WINDOW_SCALAR;
    ws = COLS;
  }
  size_t win_bytes = static_cast<size_t>(win_rows) * ws * vs;
  if (win_bytes > WINDOW_BUDGET) {
    mode = WINDOW_NONE;
    win_bytes = 0;
  }
  *mode_out = mode;
  const size_t smem = static_cast<size_t>(k) * ROWS * vs + win_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      banded_walk_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const bool diags16 = n * vs % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(diags) % 16 == 0;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  dim3 grid(static_cast<unsigned>((n + ROWS - 1) / ROWS), slices);
  banded_walk_kernel<V><<<grid, THREADS, smem, stream>>>(
      static_cast<const V*>(diags), static_cast<const V*>(b),
      static_cast<V*>(c), n, d, k, off, mode, diags16, vec);
  return cudaGetLastError();
}

}  // namespace

// offsets: k sorted diagonal offsets, in host memory (passed by value).
// mode_out: set to the window mode the launch chose (`Window`), -1 when it
// refuses its arguments.
extern "C" int banded_spmm_launch(int value_type, const void* diags,
                                  const void* b, void* c, long long n, int d,
                                  int k, const int* offsets, void* stream,
                                  int* mode_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *mode_out = -1;
  if (n < 1 || d < 1 || k < 1 || k > MAX_DIAGS || n / ROWS >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int j = 1; j < k; ++j)
    if (offsets[j] <= offsets[j - 1])
      return static_cast<int>(cudaErrorInvalidValue);
  if (value_type == repro::VALUE_F32)
    return launch<float>(diags, b, c, n, d, k, offsets, s, mode_out);
  if (value_type == repro::VALUE_BF16)
    return launch<__nv_bfloat16>(diags, b, c, n, d, k, offsets, s,
                                 mode_out);
  return static_cast<int>(cudaErrorInvalidValue);
}
