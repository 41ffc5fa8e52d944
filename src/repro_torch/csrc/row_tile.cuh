// The piece walks shared by the CSR kernel (csr_spmm.cu) and the binned
// kernel (binned_spmm.cu).
//
// A layout is a list of chunks of `chunk` slots.  Each chunk belongs to
// one owner (a row tile for CSR, a (slab, row tile) visit for binned),
// gathers from one B row slab (`chunk_slabs`), and stores slab-local
// columns, row slots within the owner's ROW_TILE rows, and values.  Its
// real entries are a prefix of `chunk_len[c]` slots; the rest is padding
// and is never read.  The host cuts each owner's chunk range into pieces
// of a bounded number of real entries (`piece_ptr`, `piece_owner`), so a
// hub row's tile is walked by many warps at once.
//
// One warp walks one piece.  It takes up to 32 chunks at a time, one lane
// per chunk: each lane loads its chunk's length and slab, a warp scan
// turns the lengths into offsets, and the chunks' real entries become one
// list.  The warp then loads 32 entries' (column, slot, value) with one
// coalesced load per array, lane e finding its chunk by a binary search
// over the offsets (for_each_batch), and broadcasts them with __shfl_sync.
// It issues several steps of B gathers before it uses any (GATHER_UNROLL,
// NARROW_STEPS), so many round trips are in flight per warp.  Products
// round at the operand dtype, sums run in fp32 (common.cuh).  The
// accumulators stay in registers: the slot selects them through an
// unrolled compare, and a mask collects the rows the piece wrote.
//
// Two ways to spend the lanes on an entry:
// - walk_piece (d >= 33, and the binned kernel): every lane on each
//   entry, over a slice of WARP_COLS columns; lane l owns columns l and
//   l + 32, so each gathered B row is one coalesced request per 32
//   columns.  A step serves one entry.
// - walk_piece_narrow (CSR at d <= 32): L lanes per entry, L the smallest
//   power of two >= d, one column per lane, so the warp is 32 / L groups
//   and a step serves 32 / L entries at once.  At small d the wide walk
//   pays its shuffles, address arithmetic and 8-row select for 64 column
//   slots of which d are real; this one pays them once per 32 / L
//   entries.  At the end of a piece the groups' rows and masks are summed
//   across the warp.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int ROW_TILE = 8;
constexpr int WARP = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int COLS_PER_LANE = 2;
constexpr int WARP_COLS = WARP * COLS_PER_LANE;
// Warps (pieces) per block.
constexpr int PIECE_WARPS = 4;
// B gathers issued before any is used.  8 needs ~72 registers, past the
// 64 that ptxas aims for at this block size, and spilled; 4 fits in 64 and
// was faster on the H100 (repro_torch.launch.bench_row_tile).
constexpr int GATHER_UNROLL = 4;
// Steps of a batch whose gathers the narrow walk issues before it uses
// any (each step gathers 32 / L entries).  At d = 4, 2 ran 6-18 % faster
// than 4 on the H100 at the same 40 registers, and neither spilled; asking
// ptxas for 32 registers (a full SM of warps) spilled with either
// (repro_torch.launch.bench_row_tile --variant).
constexpr int NARROW_STEPS = 2;

// Adds `p` into the accumulator row `slot` (a runtime value) without
// indexing the register array dynamically.
__device__ __forceinline__ void add_to_row(
    float (&acc)[ROW_TILE][COLS_PER_LANE], int slot,
    const float (&p)[COLS_PER_LANE]) {
#pragma unroll
  for (int r = 0; r < ROW_TILE; ++r)
#pragma unroll
    for (int j = 0; j < COLS_PER_LANE; ++j)
      acc[r][j] += (slot == r) ? p[j] : 0.f;
}

// Walks the real entries of chunks [c0, c1), up to 32 at a time:
// consume(row, slot, val, count) sees entry e of the batch in lane e (the
// B row it gathers, its row slot in the owner's tile, its value) and the
// number of real entries, count <= 32.
template <typename V, typename I, typename F>
__device__ __forceinline__ void for_each_batch(
    int c0, int c1, const int* __restrict__ chunk_len,
    const int* __restrict__ chunk_slabs, const I* __restrict__ cols,
    const I* __restrict__ slots, const V* __restrict__ vals,
    long long b_tile, int chunk, F&& consume) {
  const int lane = threadIdx.x & (WARP - 1);
  for (int cb = c0; cb < c1; cb += WARP) {
    // One lane per chunk: length and slab base, then the offsets.
    const int c = cb + lane;
    const int len = c < c1 ? chunk_len[c] : 0;
    const int base = c < c1 ? static_cast<int>(chunk_slabs[c] * b_tile) : 0;
    int incl = len;
#pragma unroll
    for (int o = 1; o < WARP; o <<= 1) {
      const int t = __shfl_up_sync(FULL_MASK, incl, o);
      if (lane >= o) incl += t;
    }
    const int excl = incl - len;
    const int total = __shfl_sync(FULL_MASK, incl, WARP - 1);

    for (int e0 = 0; e0 < total; e0 += WARP) {
      // Lane e loads entry e0 + e: its chunk k is the last with offset
      // <= e0 + e (chunks of length 0 share the next one's offset).
      const int e = e0 + lane;
      int k = 0;
#pragma unroll
      for (int step = WARP / 2; step > 0; step >>= 1)
        if (__shfl_sync(FULL_MASK, excl, k + step) <= e) k += step;
      const int k_excl = __shfl_sync(FULL_MASK, excl, k);
      const int k_base = __shfl_sync(FULL_MASK, base, k);
      int my_row = 0, my_slot = 0;
      float my_val = 0.f;
      if (e < total) {
        const long long pos =
            static_cast<long long>(cb + k) * chunk + (e - k_excl);
        my_row = k_base + to_i32(cols[pos]);
        my_slot = to_i32(slots[pos]);
        my_val = to_f32(vals[pos]);
      }
      consume(my_row, my_slot, my_val, min(WARP, total - e0));
    }
  }
}

// Walks chunks [c0, c1) of one piece into `acc` (zeroed here) for the
// columns col0 + lane + 32 * j, and returns the mask of rows it touched.
// Every entry adds into its row directly, in any slot order.  (A running
// sum per column, flushed on a slot change, suits CSR's non-decreasing
// slots but was 3-6 % slower on the H100,
// repro_torch.launch.bench_row_tile.)
template <typename V, typename I>
__device__ __forceinline__ unsigned walk_piece(
    int c0, int c1, const int* __restrict__ chunk_len,
    const int* __restrict__ chunk_slabs, const I* __restrict__ cols,
    const I* __restrict__ slots, const V* __restrict__ vals,
    const V* __restrict__ b, int d, long long b_tile, int chunk, int col0,
    float (&acc)[ROW_TILE][COLS_PER_LANE]) {
  const int lane = threadIdx.x & (WARP - 1);
  bool col_ok[COLS_PER_LANE];
#pragma unroll
  for (int j = 0; j < COLS_PER_LANE; ++j)
    col_ok[j] = col0 + lane + WARP * j < d;
#pragma unroll
  for (int r = 0; r < ROW_TILE; ++r)
#pragma unroll
    for (int j = 0; j < COLS_PER_LANE; ++j) acc[r][j] = 0.f;
  unsigned mask = 0;

  for_each_batch<V, I>(
      c0, c1, chunk_len, chunk_slabs, cols, slots, vals, b_tile, chunk,
      [&](int my_row, int my_slot, float my_val, int count) {
        for (int i = 0; i < count; i += GATHER_UNROLL) {
          // All gathers of the group first, then the arithmetic.
          float g[GATHER_UNROLL][COLS_PER_LANE];
#pragma unroll
          for (int u = 0; u < GATHER_UNROLL; ++u) {
            const int src = i + u;
            const int row = __shfl_sync(FULL_MASK, my_row, src);
            const V* brow =
                b + static_cast<long long>(row) * d + col0 + lane;
#pragma unroll
            for (int j = 0; j < COLS_PER_LANE; ++j) {
              g[u][j] = 0.f;
              if (src < count && col_ok[j]) g[u][j] = to_f32(brow[WARP * j]);
            }
          }
#pragma unroll
          for (int u = 0; u < GATHER_UNROLL; ++u) {
            const int src = i + u;
            const float v = __shfl_sync(FULL_MASK, my_val, src);
            const int slot = __shfl_sync(FULL_MASK, my_slot, src);
            if (src < count) {
              float p[COLS_PER_LANE];
#pragma unroll
              for (int j = 0; j < COLS_PER_LANE; ++j)
                p[j] = round_product<V>(g[u][j] * v);
              mask |= 1u << slot;
              add_to_row(acc, slot, p);
            }
          }
        }
      });
  return mask;
}

// The narrow walk of chunks [c0, c1): L lanes per entry (a power of two,
// L >= d), lane l on column l % L of the entries of group l / L.  Step s
// of a batch gives group g entry i + s * G + g, so a step gathers G
// contiguous B rows of d values.  Returns the piece's rows summed over
// the groups in every lane's `acc` (its column), and the mask of rows the
// piece touched.
template <typename V, typename I, int L>
__device__ __forceinline__ unsigned walk_piece_narrow(
    int c0, int c1, const int* __restrict__ chunk_len,
    const int* __restrict__ chunk_slabs, const I* __restrict__ cols,
    const I* __restrict__ slots, const V* __restrict__ vals,
    const V* __restrict__ b, int d, long long b_tile, int chunk,
    float (&acc)[ROW_TILE]) {
  static_assert(L >= 1 && L <= WARP && (L & (L - 1)) == 0,
                "lanes per entry: a power of two up to a warp");
  constexpr int G = WARP / L;
  // Steps of a 32-entry batch in flight at once: G * STEPS divides 32.
  constexpr int STEPS = L < NARROW_STEPS ? L : NARROW_STEPS;
  const int lane = threadIdx.x & (WARP - 1);
  const int group = lane / L;
  const int col = lane % L;
  const bool col_ok = col < d;
#pragma unroll
  for (int r = 0; r < ROW_TILE; ++r) acc[r] = 0.f;
  unsigned mask = 0;

  for_each_batch<V, I>(
      c0, c1, chunk_len, chunk_slabs, cols, slots, vals, b_tile, chunk,
      [&](int my_row, int my_slot, float my_val, int count) {
        for (int i = 0; i < count; i += G * STEPS) {
          float g[STEPS];
#pragma unroll
          for (int s = 0; s < STEPS; ++s) {
            const int src = i + s * G + group;
            const int row = __shfl_sync(FULL_MASK, my_row, src);
            g[s] = 0.f;
            if (src < count && col_ok)
              g[s] = to_f32(b[static_cast<long long>(row) * d + col]);
          }
#pragma unroll
          for (int s = 0; s < STEPS; ++s) {
            const int src = i + s * G + group;
            const float v = __shfl_sync(FULL_MASK, my_val, src);
            const int slot = __shfl_sync(FULL_MASK, my_slot, src);
            if (src < count) {
              const float p = round_product<V>(g[s] * v);
              mask |= 1u << slot;
#pragma unroll
              for (int r = 0; r < ROW_TILE; ++r)
                if (slot == r) acc[r] += p;
            }
          }
        }
      });
  // Lanes l and l ^ (L * 2^k) hold the same column of other groups.
#pragma unroll
  for (int o = L; o < WARP; o <<= 1)
#pragma unroll
    for (int r = 0; r < ROW_TILE; ++r)
      acc[r] += __shfl_xor_sync(FULL_MASK, acc[r], o);
  return __reduce_or_sync(FULL_MASK, mask);
}

// Stores piece p's 8 accumulator rows at the lane's columns col + 32 * j
// (those below d): the whole tile into C for a piece that is its tile
// alone (piece_split[p] < 0), else the rows it touched added into the
// split tiles' fp32 buffer.  Rows outer, columns inner: at d = 64 storing
// column by column ran 1.7-1.9 % slower on the H100.
template <typename O, int N>
__device__ __forceinline__ void store_piece_rows(
    long long p, int col, const float (&acc)[ROW_TILE][N], unsigned touched,
    const int* __restrict__ piece_owner, const int* __restrict__ piece_split,
    O* __restrict__ out, float* __restrict__ split_acc, long long out_rows,
    int d) {
  const int split = piece_split[p];
  if (split < 0) {
    const long long r0 = static_cast<long long>(piece_owner[p]) * ROW_TILE;
#pragma unroll
    for (int r = 0; r < ROW_TILE; ++r) {
      if (r0 + r >= out_rows) continue;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (col + WARP * j < d)
          out[(r0 + r) * d + col + WARP * j] = from_f32<O>(acc[r][j]);
    }
  } else {
    float* dst = split_acc + static_cast<long long>(split) * ROW_TILE * d;
#pragma unroll
    for (int r = 0; r < ROW_TILE; ++r) {
      if (!((touched >> r) & 1u)) continue;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (col + WARP * j < d)
          atomicAdd(dst + static_cast<long long>(r) * d + col + WARP * j,
                    acc[r][j]);
    }
  }
}

// Launch shape of a piece walk: PIECE_WARPS pieces per block, one column
// slice of WARP_COLS per grid row.
inline void piece_launch_shape(long long pieces, int d, dim3* grid,
                               dim3* block) {
  *block = dim3(PIECE_WARPS * WARP);
  *grid = dim3(static_cast<unsigned>((pieces + PIECE_WARPS - 1) /
                                     PIECE_WARPS),
               (d + WARP_COLS - 1) / WARP_COLS);
}

// Stores fp32 accumulator rows into C at its dtype: acc row s * ROW_TILE
// + r goes to C row tiles[s] * ROW_TILE + r (tiles == nullptr: tile s).
template <typename O>
__global__ void store_rows_kernel(const float* __restrict__ acc,
                                  const int* __restrict__ tiles,
                                  O* __restrict__ out, long long out_rows,
                                  int d) {
  const long long s = blockIdx.x;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= d) return;
  const long long tile = tiles ? tiles[s] : s;
#pragma unroll
  for (int r = 0; r < ROW_TILE; ++r) {
    const long long row = tile * ROW_TILE + r;
    if (row < out_rows)
      out[row * d + col] = from_f32<O>(acc[(s * ROW_TILE + r) * d + col]);
  }
}

template <typename O>
cudaError_t store_rows(const float* acc, const int* tiles, O* out,
                       long long num, long long out_rows, int d,
                       cudaStream_t stream) {
  if (num == 0) return cudaSuccess;
  const int threads = d < 128 ? ((d + WARP - 1) / WARP) * WARP : 128;
  const dim3 grid(static_cast<unsigned>(num), (d + threads - 1) / threads);
  store_rows_kernel<O><<<grid, threads, 0, stream>>>(acc, tiles, out,
                                                     out_rows, d);
  return cudaGetLastError();
}

}  // namespace repro
