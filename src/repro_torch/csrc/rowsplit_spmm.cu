// Row-split SpMM: equal-nnz chunks, each row folded into C in the kernel.
//
// Replaces the TPU kernel `rowsplit_spmm_pallas`
// (src/repro/kernels/binned_spmm.py, body `_rowsplit_kernel`, epilogue
// `segment_sum`).  The layout is the reference's `pack_rowsplit_chunks`
// packing, unchanged: chunk c holds exactly `chunk` nonzeros of the
// row-major stream (global columns, zero padding at the end), and
// `slots[c, e]` is the nonzero's row within the chunk's window, global row
// `row_map[c, slot]`.  The TPU kernel reduces a chunk into a private fp32
// window with a one-hot matmul and a segment_sum folds the windows.
//
// What bounds it on the card: bytes.  Every nonzero gathers one B row (d
// values), and C is written once.  The first version wrote a fp32 window
// of window x d values per chunk (0.875 GB at n = 2**20, 3x C itself,
// mostly zeros) and an index_add_ read it back with fp32 atomics, in an
// order that changed from run to run.
//
// What the design does about it.  The stream is row-major and a chunk's
// slots never decrease, so only a chunk's first and last rows can be
// shared with its neighbours.  The host derives, once per layout
// (`rowsplit_carries`), each chunk's last slot and whether its first
// (HEAD) and last (TAIL) rows are shared, the rows that span chunks
// (carry rows, with their chunk range) and the rows with no entry.
// rowsplit_kernel: one warp per chunk, lanes across d (two adjacent
// columns per lane, one 8-byte load at fp32 when d is even).  The warp
// loads 32 entries' (column, slot, value) with one coalesced load per
// array and broadcasts them with __shfl_sync; it issues GATHERS B-row
// gathers before it uses any.  Each lane keeps one running fp32 sum per
// column and flushes it when the slot changes (the branch is the same for
// the whole warp): a row the chunk owns alone goes straight into C, cast
// once; a shared first or last row goes to the carry buffer [C, 2, d] as
// fp32.  Nothing is written for window slots past the chunk's last row.
// fixup_kernel (a second, small launch): one warp per carry row sums its
// carries in chunk order and writes the row; the same launch writes the
// rows with no entry as zeros.  Every sum runs in a fixed order, so C is
// the same bit for bit from run to run.  Products round at the operand
// dtype and sums run in fp32 (common.cuh).
#include "common.cuh"

namespace {

using namespace repro;

constexpr int WARP = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int WARP_COLS = 2 * WARP;  // two adjacent columns per lane
constexpr int WARPS = 4;             // chunks (or carry rows) per block
constexpr int GATHERS = 8;           // B rows in flight per warp
constexpr int CARRY_UNROLL = 8;      // carries in flight per fixup warp
// Bits of `shared[c]` (rowsplit_carries in kernels/rowsplit_spmm.py).
constexpr int HEAD_SHARED = 1;       // the first row continues chunk c - 1
constexpr int TAIL_SHARED = 2;       // the last row continues in chunk c + 1

// Columns c0 and c1 of one row as fp32, zero where `ok0` / `ok1` is false.
// The callers clamp c0 and c1 into the row, so every load is in bounds and
// needs no predicate.  PAIR: d is even and rows are 2-value aligned, so c1
// = c0 + 1 and both load as one vector.
template <bool PAIR>
__device__ __forceinline__ void load2(const float* p, int c0, int c1,
                                      bool ok0, bool ok1, float& x0,
                                      float& x1) {
  float v0, v1;
  if (PAIR) {
    const float2 t = *reinterpret_cast<const float2*>(p + c0);
    v0 = t.x;
    v1 = t.y;
  } else {
    const float* q = p + c0;  // one address per row (ptxas spilled two)
    v0 = q[0];
    v1 = q[c1 - c0];
  }
  x0 = ok0 ? v0 : 0.f;
  x1 = ok1 ? v1 : 0.f;
}

template <bool PAIR>
__device__ __forceinline__ void load2(const __nv_bfloat16* p, int c0, int c1,
                                      bool ok0, bool ok1, float& x0,
                                      float& x1) {
  float v0, v1;
  if (PAIR) {
    const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(p + c0);
    v0 = __low2float(t);
    v1 = __high2float(t);
  } else {
    const __nv_bfloat16* q = p + c0;
    v0 = __bfloat162float(q[0]);
    v1 = __bfloat162float(q[c1 - c0]);
  }
  x0 = ok0 ? v0 : 0.f;
  x1 = ok1 ? v1 : 0.f;
}

template <bool PAIR>
__device__ __forceinline__ void store2(float* p, bool ok0, bool ok1,
                                       float x0, float x1) {
  if (PAIR) {
    if (ok0) *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
  } else {
    if (ok0) p[0] = x0;
    if (ok1) p[1] = x1;
  }
}

template <bool PAIR>
__device__ __forceinline__ void store2(__nv_bfloat16* p, bool ok0, bool ok1,
                                       float x0, float x1) {
  if (PAIR) {
    if (ok0)
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
  } else {
    if (ok0) p[0] = __float2bfloat16_rn(x0);
    if (ok1) p[1] = __float2bfloat16_rn(x1);
  }
}

// The columns a lane reads, clamped into a row of d (>= 1) values.
template <bool PAIR>
__device__ __forceinline__ void clamp_cols(int col, int d, int* c0,
                                           int* c1) {
  *c0 = min(col, PAIR ? d - 2 : d - 1);
  *c1 = PAIR ? *c0 + 1 : min(col + 1, d - 1);
}

// Writes the finished row at `slot` of a chunk: a shared row to its carry
// slot (the first row's to 0, the last row's to 1; a chunk with one row
// uses 0), any other real row straight into C.
template <typename V, bool PAIR>
__device__ __forceinline__ void flush_row(int slot, int last, int flags,
                                          const int* rows, float* carry_c,
                                          V* out, int n, int d, int col,
                                          bool ok0, bool ok1, float s0,
                                          float s1) {
  const bool head =
      slot == 0 &&
      ((flags & HEAD_SHARED) || (last == 0 && (flags & TAIL_SHARED)));
  const bool tail = !head && slot == last && (flags & TAIL_SHARED);
  if (head || tail) {
    store2<PAIR>(carry_c + (tail ? d : 0) + col, ok0, ok1, s0, s1);
    return;
  }
  const int row = rows[slot];
  if (row < n)
    store2<PAIR>(out + static_cast<long long>(row) * d + col, ok0, ok1, s0,
                 s1);
}

template <typename V, typename I, bool PAIR>
__global__ void __launch_bounds__(WARPS* WARP) rowsplit_kernel(
    const int* __restrict__ row_map, const int* __restrict__ last_slot,
    const int* __restrict__ shared, const I* __restrict__ cols,
    const I* __restrict__ slots, const V* __restrict__ vals,
    const V* __restrict__ b, V* __restrict__ out, float* __restrict__ carry,
    long long num_chunks, int window, int d, int chunk, int n) {
  const long long c =
      static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / WARP;
  if (c >= num_chunks) return;  // the whole warp leaves together
  const int lane = threadIdx.x & (WARP - 1);
  const int col = blockIdx.y * WARP_COLS + 2 * lane;
  const bool ok0 = col < d;
  const bool ok1 = col + 1 < d;
  int c0, c1;
  clamp_cols<PAIR>(col, d, &c0, &c1);
  const int last = last_slot[c];
  const int flags = shared[c];
  const int* rows = row_map + c * window;
  float* carry_c = carry + c * 2 * d;
  const long long e_base = c * chunk;

  int cur = 0;
  float s0 = 0.f, s1 = 0.f;
  for (int e0 = 0; e0 < chunk; e0 += WARP) {
    // Lane e holds entry e0 + e; the walk reads it through shuffles.
    const int e = e0 + lane;
    int my_col = 0, my_slot = 0;
    float my_val = 0.f;
    if (e < chunk) {
      my_col = to_i32(cols[e_base + e]);
      my_slot = to_i32(slots[e_base + e]);
      my_val = to_f32(vals[e_base + e]);
    }
    const int count = min(WARP, chunk - e0);
    for (int i = 0; i < count; i += GATHERS) {
      // All gathers of the group first, then the arithmetic.
      float g[GATHERS][2];
#pragma unroll
      for (int u = 0; u < GATHERS; ++u) {
        const int src = i + u;
        // Lanes past `count` hold column 0 or a real column: the gather
        // stays in bounds, and its values are dropped below.
        const int row = __shfl_sync(FULL_MASK, my_col, src);
        load2<PAIR>(b + static_cast<long long>(row) * d, c0, c1, ok0, ok1,
                    g[u][0], g[u][1]);
      }
#pragma unroll
      for (int u = 0; u < GATHERS; ++u) {
        const int src = i + u;
        const float v = __shfl_sync(FULL_MASK, my_val, src);
        const int slot = __shfl_sync(FULL_MASK, my_slot, src);
        if (src < count) {
          if (slot != cur) {
            flush_row<V, PAIR>(cur, last, flags, rows, carry_c, out, n, d,
                               col, ok0, ok1, s0, s1);
            cur = slot;
            s0 = s1 = 0.f;
          }
          s0 += round_product<V>(g[u][0] * v);
          s1 += round_product<V>(g[u][1] * v);
        }
      }
    }
  }
  flush_row<V, PAIR>(cur, last, flags, rows, carry_c, out, n, d, col, ok0,
                     ok1, s0, s1);
}

// Items [0, num_carry) are carry rows: the sum of their carries in chunk
// order (the first chunk's carry is its last row's, slot 1, unless that
// chunk has one row; every later chunk's is its first row's, slot 0).
// Items [num_carry, num_carry + num_empty) are rows with no entry: zeros.
template <typename V, bool PAIR>
__global__ void __launch_bounds__(WARPS* WARP) fixup_kernel(
    const int* __restrict__ carry_rows, const int* __restrict__ carry_chunks,
    const int* __restrict__ last_slot, const int* __restrict__ empty_rows,
    const float* __restrict__ carry, V* __restrict__ out,
    long long num_carry, long long num_empty, int d) {
  const long long item =
      static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / WARP;
  if (item >= num_carry + num_empty) return;
  const int lane = threadIdx.x & (WARP - 1);
  const int col = blockIdx.y * WARP_COLS + 2 * lane;
  const bool ok0 = col < d;
  const bool ok1 = col + 1 < d;
  int k0, k1;
  clamp_cols<PAIR>(col, d, &k0, &k1);
  if (item >= num_carry) {
    const long long row = empty_rows[item - num_carry];
    store2<PAIR>(out + row * d + col, ok0, ok1, 0.f, 0.f);
    return;
  }
  const long long c0 = carry_chunks[2 * item];
  const long long c1 = carry_chunks[2 * item + 1];
  float s0, s1;
  load2<PAIR>(carry + (2 * c0 + (last_slot[c0] > 0 ? 1 : 0)) * d, k0, k1,
              ok0, ok1, s0, s1);
  for (long long c = c0 + 1; c <= c1; c += CARRY_UNROLL) {
    float v[CARRY_UNROLL][2];
#pragma unroll
    for (int u = 0; u < CARRY_UNROLL; ++u)  // past c1: read c1, dropped
      load2<PAIR>(carry + 2 * min(c + u, c1) * d, k0, k1, ok0, ok1, v[u][0],
                  v[u][1]);
#pragma unroll
    for (int u = 0; u < CARRY_UNROLL; ++u) {
      if (c + u <= c1) {
        s0 += v[u][0];
        s1 += v[u][1];
      }
    }
  }
  const long long row = carry_rows[item];
  store2<PAIR>(out + row * d + col, ok0, ok1, s0, s1);
}

template <typename V, typename I, bool PAIR>
cudaError_t launch(const void* row_map, const void* last_slot,
                   const void* shared, const void* cols, const void* slots,
                   const void* vals, const void* b, const void* carry_rows,
                   const void* carry_chunks, const void* empty_rows,
                   void* carry, void* out, long long num_chunks,
                   long long num_carry, long long num_empty, int window,
                   int d, int chunk, int n, cudaStream_t stream) {
  const unsigned slices = (d + WARP_COLS - 1) / WARP_COLS;
  const dim3 grid(static_cast<unsigned>((num_chunks + WARPS - 1) / WARPS),
                  slices);
  rowsplit_kernel<V, I, PAIR><<<grid, WARPS * WARP, 0, stream>>>(
      static_cast<const int*>(row_map), static_cast<const int*>(last_slot),
      static_cast<const int*>(shared), static_cast<const I*>(cols),
      static_cast<const I*>(slots), static_cast<const V*>(vals),
      static_cast<const V*>(b), static_cast<V*>(out),
      static_cast<float*>(carry), num_chunks, window, d, chunk, n);
  cudaError_t err = cudaGetLastError();
  const long long items = num_carry + num_empty;
  if (err != cudaSuccess || items == 0) return err;
  const dim3 fix_grid(static_cast<unsigned>((items + WARPS - 1) / WARPS),
                      slices);
  fixup_kernel<V, PAIR><<<fix_grid, WARPS * WARP, 0, stream>>>(
      static_cast<const int*>(carry_rows),
      static_cast<const int*>(carry_chunks),
      static_cast<const int*>(last_slot), static_cast<const int*>(empty_rows),
      static_cast<const float*>(carry), static_cast<V*>(out), num_carry,
      num_empty, d);
  return cudaGetLastError();
}

template <typename V, typename I>
cudaError_t launch_pair(bool pair, const void* row_map,
                        const void* last_slot, const void* shared,
                        const void* cols, const void* slots, const void* vals,
                        const void* b, const void* carry_rows,
                        const void* carry_chunks, const void* empty_rows,
                        void* carry, void* out, long long num_chunks,
                        long long num_carry, long long num_empty, int window,
                        int d, int chunk, int n, cudaStream_t stream) {
  if (pair)
    return launch<V, I, true>(row_map, last_slot, shared, cols, slots, vals,
                              b, carry_rows, carry_chunks, empty_rows, carry,
                              out, num_chunks, num_carry, num_empty, window,
                              d, chunk, n, stream);
  return launch<V, I, false>(row_map, last_slot, shared, cols, slots, vals,
                             b, carry_rows, carry_chunks, empty_rows, carry,
                             out, num_chunks, num_carry, num_empty, window, d,
                             chunk, n, stream);
}

}  // namespace

// Launches both kernels on `stream` (the fixup only when there are carry
// or empty rows).  `out` is [n, d] at the value dtype, `carry` [C, 2, d]
// fp32 scratch; neither needs to be initialised.
extern "C" int rowsplit_spmm_launch(
    int value_type, int index_type, const void* row_map,
    const void* last_slot, const void* shared, const void* cols,
    const void* slots, const void* vals, const void* b,
    const void* carry_rows, const void* carry_chunks, const void* empty_rows,
    void* carry, void* out, long long num_chunks, long long num_carry,
    long long num_empty, int window, int d, int chunk, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_chunks < 1 || (num_chunks + WARPS - 1) / WARPS > 0x7fffffffLL ||
      num_carry < 0 || num_empty < 0 ||
      (num_carry + num_empty + WARPS - 1) / WARPS > 0x7fffffffLL ||
      window < 1 || d < 1 || chunk < 1 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t vsize = value_type == VALUE_BF16 ? 2 : 4;
  // One vector per lane needs d even and B's and C's rows 2-value aligned.
  const bool pair = d % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(b) % (2 * vsize) == 0 &&
                    reinterpret_cast<uintptr_t>(out) % (2 * vsize) == 0 &&
                    reinterpret_cast<uintptr_t>(carry) % 8 == 0;
#define REPRO_ROWSPLIT(V, I)                                                \
  launch_pair<V, I>(pair, row_map, last_slot, shared, cols, slots, vals, b, \
                    carry_rows, carry_chunks, empty_rows, carry, out,       \
                    num_chunks, num_carry, num_empty, window, d, chunk, n, s)
  if (value_type == VALUE_F32 && index_type == INDEX_I32)
    return static_cast<int>(REPRO_ROWSPLIT(float, int32_t));
  if (value_type == VALUE_F32 && index_type == INDEX_I16)
    return static_cast<int>(REPRO_ROWSPLIT(float, int16_t));
  if (value_type == VALUE_BF16 && index_type == INDEX_I32)
    return static_cast<int>(REPRO_ROWSPLIT(__nv_bfloat16, int32_t));
  if (value_type == VALUE_BF16 && index_type == INDEX_I16)
    return static_cast<int>(REPRO_ROWSPLIT(__nv_bfloat16, int16_t));
#undef REPRO_ROWSPLIT
  return static_cast<int>(cudaErrorInvalidValue);
}
