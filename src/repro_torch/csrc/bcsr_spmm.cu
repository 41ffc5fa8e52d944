// BCSR SpMM: C[block row i] = sum over the row's blocks of A_blk @ B[col].
//
// Replaces the TPU kernel `bcsr_spmm_pallas`
// (src/repro/kernels/bcsr_spmm.py, body `_bcsr_kernel`).  The layout is the
// reference's: dense t x t blocks sorted by (block row, block column), the
// block row pointer `block_ptr[nb + 1]`, and `pad_empty_block_rows`'s zero
// block for every block row that has none.  Products are exact in fp32 and
// sums run in fp32 (the reference's preferred_element_type = float32); C is
// cast once to B's dtype.
//
// What bounds it on the card depends on how full the stored blocks are.
// At t = 64, d = 64 a full block is 16 KB of fp32 (8 KB of bf16) and
// carries 2 * 64^3 FLOPs; on `moe-block` (one dense block per block row, B
// read once) that is 8.6 GFLOP against 268 MB of A plus B and C, 0.240 ms
// at 3.35 TB/s (0.120 ms at bf16).  At fp32 the same FLOPs take 0.128 ms at
// the 67 TFLOP/s CUDA-core FMA peak, so the FMAs must run at over half of
// peak and overlap the copies; at bf16 CUDA-core FMA alone would exceed the
// bytes bound, so bf16 runs on the tensor cores.  An operator of smaller
// blocks packed at t = 64 fills few of a tile's four 32 x 32 quadrants
// (`fem-n20`'s 32 x 32 blocks: 28 % of the quadrants of its stored tiles
// hold an entry), and a full tile's copies and 64^3 FMAs a pair, whatever
// d, are then mostly spent on zeros.  So at fp32 the kernel reads a mask of
// the quadrants each block holds, made once at pack time
// (kernels/bcsr_spmm.py, `quadrant_mask`), and copies and multiplies only
// those: its work follows the quadrants held, and a full block (mask 0xF)
// or a layout without a mask does the whole tile's.  Every quadrant it
// skips is zero, and fmaf(0, b, acc) == acc for finite b, so C is bitwise
// the same.
//
// What the design does about it: three variants, named by the wrapper's
// shape rule (kernels/bcsr_spmm.py, `bcsr_variant`) and checked here.
// * tile64_f32 (t = 64, fp32, d % 4 == 0): a persistent block of 128
//   threads owns a 64 x 64 C tile (the whole block row at d = 64, so each A
//   block is read once per 64-column slice) and walks block rows
//   blockIdx.x, + gridDim.x, ...; their blocks form one flat sequence of
//   (A block, B tile) pairs, staged by 16-byte `cp.async` into a two-stage
//   ring that crosses block rows: the next pair's copies are in flight
//   while this pair is multiplied, whether or not it starts a new row (on
//   `moe-block`, one block per row, that is the only overlap there is).
//   True fp32 FMA from registers: thread (tx, ty) = (lane % 8, 4 * warp +
//   lane / 8) holds rows ty + 16 r (r < 4) and columns 4 tx + {0..3} and
//   32 + 4 tx + {0..3}; per 4-deep k step it reads 4 LDS.128 of A (4 k of
//   one row, as stored) and 8 LDS.128 of B for 128 FMAs.  The A rows are
//   padded to 68 floats, so a warp's four rows (consecutive) fall on banks
//   0, 4, 8, 12: one wavefront per A load, and the eight lanes of a B load
//   read 128 contiguous bytes.  Padding (cp.async writes any destination)
//   was chosen over a thread layout that shares A rows across a warp
//   because the strided-row ownership keeps B reads conflict-free too.
//   At a block-row change the tile stores its accumulators to C (float4,
//   columns past d masked) and zeroes them.  The quadrant mask (bit
//   2 rh + kh: row half rh, column half kh) is read with the pair's block
//   column, a pair ahead: a pair copies its present quadrants of A (32
//   rows x 128 B each) and the 32 B rows of each k half a present quadrant
//   reads, and runs the k loop over those halves only, each for the row
//   pairs (r < 2: the top half, r >= 2: the bottom) whose quadrant is
//   present.  The mask is the same for the whole block, so no branch
//   diverges; a padded zero block (mask 0) copies and multiplies nothing.
// * wgmma_bf16 (t = 64, bf16, d % 8 == 0): the same persistent walk, with
//   a producer warp that issues two TMA loads per pair (the A block through
//   a 2-D map over blocks viewed as [N * 64, 64], K-major; the B tile
//   through a 2-D map over B [n, d] with a 64 x 64 box, MN-major, columns
//   past d zero-filled), 128-byte swizzle, into a ring of four 16 KB
//   stages with full / empty mbarriers, and one consumer warpgroup running
//   four `wgmma.m64n64k16` per pair with fp32 accumulators, releasing a
//   stage once the group that read it is done.  Once per block row the
//   fragment is cast to bf16 and staged in a padded shared tile, and C goes
//   out as 16-byte stores, 128 contiguous bytes per 8 lanes: storing the
//   fragment straight from registers (4 bytes a lane, 16 bytes a row) held
//   the first version well below the bytes bound, and a TMA store of the
//   staged tile was no faster than these stores.  A lost arrival traps
//   (`mbar_wait`).
// * generic (any other t <= 128 or d): one block per (block row, 32-column
//   slice) walks its row (block_tile.cuh), A and B staged as fp32 in
//   shared memory.
// Every C element has one owner and one fixed summation order: no atomics,
// and C is bitwise equal from one call to the next.
#include "block_tile.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;

// Variant codes passed from Python (kernels/bcsr_spmm.py, VARIANTS).
constexpr int VARIANT_GENERIC = 0;
constexpr int VARIANT_TILE64_F32 = 1;
constexpr int VARIANT_WGMMA_BF16 = 2;

// ---- generic: any t <= 128, any d ------------------------------------------
template <typename V>
__global__ void __launch_bounds__(BLOCK_THREADS)
    bcsr_kernel(const int* __restrict__ block_ptr,
                const int* __restrict__ block_cols,
                const V* __restrict__ blocks, const V* __restrict__ b,
                V* __restrict__ c, int t, int d) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = smem + t * t;
  const long long br = blockIdx.x;
  const int col0 = blockIdx.y * BLOCK_COLS;
  float acc[BLOCK_ACC];
#pragma unroll
  for (int j = 0; j < BLOCK_ACC; ++j) acc[j] = 0.f;
  const int i1 = block_ptr[br + 1];
  const long long tt = static_cast<long long>(t) * t;
  for (int i = block_ptr[br]; i < i1; ++i) {
    accumulate_block<V>(blocks + i * tt, b,
                        static_cast<long long>(block_cols[i]) * t, d, col0, t,
                        As, Bs, acc);
  }
  store_tile<V>(c, br * t, d, col0, t, acc);
}

template <typename V>
cudaError_t launch_generic(const void* block_ptr, const void* block_cols,
                           const void* blocks, const void* b, void* c,
                           long long nb, int t, int d, cudaStream_t stream) {
  const size_t smem = block_tile_smem(t);
  cudaError_t err = allow_smem(bcsr_kernel<V>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(static_cast<unsigned>(nb), (d + BLOCK_COLS - 1) / BLOCK_COLS);
  bcsr_kernel<V><<<grid, BLOCK_THREADS, smem, stream>>>(
      static_cast<const int*>(block_ptr), static_cast<const int*>(block_cols),
      static_cast<const V*>(blocks), static_cast<const V*>(b),
      static_cast<V*>(c), t, d);
  return cudaGetLastError();
}

// ---- the block ring of the t = 64 variants --------------------------------
constexpr int T64 = 64;

// A persistent block's block rows, blockIdx.x, + gridDim.x, ... below nb.
// The next row's block range is loaded one row ahead, so the loads of
// `block_ptr` overlap the row before instead of stalling the walk.
struct Rows {
  long long br;   // current block row
  int i0, i1;     // its blocks [i0, i1)
  int n0, n1;     // the next row's, loaded ahead
};

__device__ __forceinline__ Rows first_rows(const int* __restrict__ block_ptr,
                                           long long step) {
  const long long br = blockIdx.x;  // < nb: the grid is at most nb wide
  return Rows{br - step, 0, 0, block_ptr[br], block_ptr[br + 1]};
}

// Step to the next block row; false past the last.
__device__ __forceinline__ bool next_row(const int* __restrict__ block_ptr,
                                         long long nb, long long step,
                                         Rows& w) {
  w.br += step;
  if (w.br >= nb) return false;
  w.i0 = w.n0;
  w.i1 = w.n1;
  if (w.br + step < nb) {
    w.n0 = block_ptr[w.br + step];
    w.n1 = block_ptr[w.br + step + 1];
  }
  return true;
}

// The same walk as one flat sequence of (block row, block) pairs, empty
// rows skipped; the pair's block column and quadrant mask are loaded a pair
// ahead of their use.
struct Pairs {
  Rows row;
  int i;     // current block
  int col;   // its block column
  int mask;  // its quadrants held (0xF without a mask)
};

__device__ __forceinline__ Pairs first_pairs(const int* __restrict__ block_ptr,
                                             long long step) {
  return Pairs{first_rows(block_ptr, step), -1, 0, 0xF};
}

// Step to the next pair; false past the last.  `quadrants` may be null.
__device__ __forceinline__ bool next_pair(
    const int* __restrict__ block_ptr, const int* __restrict__ block_cols,
    const unsigned char* __restrict__ quadrants, long long nb,
    long long step, Pairs& p) {
  ++p.i;
  while (p.i >= p.row.i1) {
    if (!next_row(block_ptr, nb, step, p.row)) return false;
    p.i = p.row.i0;
  }
  p.col = block_cols[p.i];
  p.mask = quadrants ? quadrants[p.i] : 0xF;
  return true;
}

// Blocks that fit on the card at once for a kernel, its threads and its
// dynamic shared memory: the persistent grid.
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, size_t smem, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  *out = (per_sm > 0 ? per_sm : 1) * sms;
  return err;
}

// The persistent grid: (blocks over block rows, 64-column slices).
dim3 ring_grid(int resident, long long nb, int slices) {
  long long gx = (resident + slices - 1) / slices;
  if (gx > nb) gx = nb;
  if (gx < 1) gx = 1;
  return dim3(static_cast<unsigned>(gx), static_cast<unsigned>(slices));
}

// ---- tile64_f32: register-tiled fp32 FMA over a cp.async ring --------------
constexpr int F_THREADS = 128;
constexpr int F_STAGES = 2;
constexpr int F_HALF = T64 / 2;                  // quadrant edge
constexpr int F_A_LD = T64 + 4;                  // padded A row (floats)
constexpr int F_A_FLOATS = T64 * F_A_LD;
constexpr int F_STAGE_FLOATS = F_A_FLOATS + T64 * T64;
constexpr size_t F_SMEM = sizeof(float) * F_STAGES * F_STAGE_FLOATS;

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The row halves of k half kh that `mask` holds: bit 0 the top, bit 2 the
// bottom (0 when no present quadrant reads k half kh).
__device__ __forceinline__ int halves_of(int mask, int kh) {
  return (mask >> kh) & 5;
}

// Issue the copies of block i's quadrants that `mask` holds (A, 64 x 64
// contiguous; quadrant (rh, kh) is rows 32 rh .. + 32, columns 32 kh .. +
// 32) and of the rows of its B tile (rows col * 64 .. + 64, columns c0 ..
// c0 + 64, zero past d) that those quadrants read, into `stage`.
__device__ __forceinline__ void issue_f32(float* stage,
                                          const float* __restrict__ blocks,
                                          const float* __restrict__ b,
                                          int i, int col, int mask, int c0,
                                          int d) {
  const float* a = blocks + static_cast<long long>(i) * T64 * T64;
  const float* bt = b + static_cast<long long>(col) * T64 * d + c0;
  float* As = stage;
  float* Bs = stage + F_A_FLOATS;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    if (!((mask >> h) & 1)) continue;
    const int r0 = F_HALF * (h >> 1), k0 = F_HALF * (h & 1);
#pragma unroll
    for (int m = 0; m < F_HALF * F_HALF / 4 / F_THREADS; ++m) {
      const int j = threadIdx.x + F_THREADS * m;   // 16-byte chunk
      const int r = r0 + j / 8, k = k0 + 4 * (j % 8);
      cp_async16(As + r * F_A_LD + k, a + r * T64 + k);
    }
  }
#pragma unroll
  for (int kh = 0; kh < 2; ++kh) {
    if (!halves_of(mask, kh)) continue;
#pragma unroll
    for (int m = 0; m < F_HALF * T64 / 4 / F_THREADS; ++m) {
      const int j = threadIdx.x + F_THREADS * m;   // 16-byte chunk
      const int r = F_HALF * kh + j / 16, q = j % 16;
      const bool in = c0 + 4 * q < d;
      cp_async16_fill(Bs + r * T64 + 4 * q, in ? bt + r * d + 4 * q : bt,
                      in ? 16u : 0u);
    }
  }
}

// acc[r] += A[ty + 16 r, k0 .. k0 + 32) @ B[k0 .. k0 + 32, the thread's
// columns) for the row pairs r in [R0, R1): one k half of a pair.
template <int R0, int R1>
__device__ __forceinline__ void fma_half(const float* As, const float* Bs,
                                         int k0, int tx, int ty,
                                         float (&acc)[4][8]) {
#pragma unroll 4
  for (int kq = 0; kq < F_HALF; kq += 4) {
    const int k = k0 + kq;
    float4 a[4];
#pragma unroll
    for (int r = R0; r < R1; ++r)
      a[r] = *reinterpret_cast<const float4*>(As + (ty + 16 * r) * F_A_LD + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 =
          *reinterpret_cast<const float4*>(Bs + (k + kk) * T64 + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(
          Bs + (k + kk) * T64 + 32 + 4 * tx);
#pragma unroll
      for (int r = R0; r < R1; ++r) {
        const float av = lane_of(a[r], kk);
        acc[r][0] = fmaf(av, b0.x, acc[r][0]);
        acc[r][1] = fmaf(av, b0.y, acc[r][1]);
        acc[r][2] = fmaf(av, b0.z, acc[r][2]);
        acc[r][3] = fmaf(av, b0.w, acc[r][3]);
        acc[r][4] = fmaf(av, b1.x, acc[r][4]);
        acc[r][5] = fmaf(av, b1.y, acc[r][5]);
        acc[r][6] = fmaf(av, b1.z, acc[r][6]);
        acc[r][7] = fmaf(av, b1.w, acc[r][7]);
      }
    }
  }
}

__global__ void __launch_bounds__(F_THREADS, 3)
    bcsr_tile64_f32(const int* __restrict__ block_ptr,
                    const int* __restrict__ block_cols,
                    const float* __restrict__ blocks,
                    const float* __restrict__ b, float* __restrict__ c,
                    long long nb, int d,
                    const unsigned char* __restrict__ quadrants) {
  extern __shared__ __align__(16) float smem_f[];
  const int lane = threadIdx.x % 32;
  const int tx = lane % 8;
  const int ty = (threadIdx.x / 32) * 4 + lane / 8;
  const int c0 = blockIdx.y * T64;
  const long long step = gridDim.x;

  // The copy cursor runs one pair ahead of the multiply; `ahead` holds the
  // quadrant mask of the pair in flight.
  static_assert(F_STAGES == 2, "one pair in flight");
  Pairs copy = first_pairs(block_ptr, step);
  bool more = next_pair(block_ptr, block_cols, quadrants, nb, step, copy);
  int ahead = 0;
  if (more) {
    issue_f32(smem_f, blocks, b, copy.i, copy.col, copy.mask, c0, d);
    ahead = copy.mask;
    more = next_pair(block_ptr, block_cols, quadrants, nb, step, copy);
  }
  cp_async_commit();

  int q = 0;  // pairs multiplied so far
  Rows row = first_rows(block_ptr, step);
  while (next_row(block_ptr, nb, step, row)) {
    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
    for (int i = row.i0; i < row.i1; ++i, ++q) {
      // Pair q has landed, and every thread is done with pair q - 1's stage.
      cp_async_wait<F_STAGES - 2>();
      __syncthreads();
      const int mask = ahead;
      if (more) {
        issue_f32(smem_f + ((q + F_STAGES - 1) % F_STAGES) * F_STAGE_FLOATS,
                  blocks, b, copy.i, copy.col, copy.mask, c0, d);
        ahead = copy.mask;
        more = next_pair(block_ptr, block_cols, quadrants, nb, step, copy);
      }
      cp_async_commit();
      const float* As = smem_f + (q % F_STAGES) * F_STAGE_FLOATS;
      const float* Bs = As + F_A_FLOATS;
#pragma unroll 1
      for (int kh = 0; kh < 2; ++kh) {
        const int halves = halves_of(mask, kh);
        if (halves == 5)
          fma_half<0, 4>(As, Bs, F_HALF * kh, tx, ty, acc);
        else if (halves == 1)
          fma_half<0, 2>(As, Bs, F_HALF * kh, tx, ty, acc);
        else if (halves == 4)
          fma_half<2, 4>(As, Bs, F_HALF * kh, tx, ty, acc);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float* o = c + (row.br * T64 + ty + 16 * r) * d + c0 + 4 * tx;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (c0 + 4 * tx + 32 * h < d)
          *reinterpret_cast<float4*>(o + 32 * h) =
              make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                          acc[r][4 * h + 3]);
    }
  }
}

cudaError_t launch_tile64_f32(const void* block_ptr, const void* block_cols,
                              const void* quadrants, const void* blocks,
                              const void* b, void* c, long long nb, int d,
                              cudaStream_t stream) {
  cudaError_t err = allow_smem(bcsr_tile64_f32, F_SMEM);
  int resident = 0;
  if (err == cudaSuccess)
    err = resident_blocks(bcsr_tile64_f32, F_THREADS, F_SMEM, &resident);
  if (err != cudaSuccess) return err;
  const dim3 grid = ring_grid(resident, nb, (d + T64 - 1) / T64);
  bcsr_tile64_f32<<<grid, F_THREADS, F_SMEM, stream>>>(
      static_cast<const int*>(block_ptr), static_cast<const int*>(block_cols),
      static_cast<const float*>(blocks), static_cast<const float*>(b),
      static_cast<float*>(c), nb, d,
      static_cast<const unsigned char*>(quadrants));
  return cudaGetLastError();
}

// ---- wgmma_bf16: TMA ring feeding wgmma.m64n64k16 --------------------------
constexpr int W_STAGES = 4;
constexpr int W_TILE_BYTES = T64 * T64 * 2;      // one 64 x 64 bf16 tile
constexpr int W_THREADS = 128 + 32;  // consumer warpgroup + producer warp
constexpr int W_C_LD = 144;  // padded C staging row (bytes)
constexpr size_t W_SMEM = static_cast<size_t>(W_STAGES) * 2 * W_TILE_BYTES +
                          T64 * W_C_LD + 1024 + 2 * W_STAGES * 8;

__global__ void __launch_bounds__(W_THREADS, 3)
    bcsr_wgmma_bf16(const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap bmap,
                    const int* __restrict__ block_ptr,
                    const int* __restrict__ block_cols,
                    __nv_bfloat16* __restrict__ c, long long nb, int d) {
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles need 1024-byte alignment.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sa = smem;
  unsigned char* sb = smem + W_STAGES * W_TILE_BYTES;
  unsigned char* sc = sb + W_STAGES * W_TILE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sc + T64 * W_C_LD);
  uint64_t* empty = full + W_STAGES;
  const int c0 = blockIdx.y * T64;
  const long long step = gridDim.x;

  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // Producer warp: one thread keeps the ring full, across block rows.
    if (threadIdx.x == 128) {
      Pairs p = first_pairs(block_ptr, step);
      for (int q = 0; next_pair(block_ptr, block_cols, nullptr, nb, step, p);
           ++q) {
        const int s = q % W_STAGES;
        mbar_wait(&empty[s], ((q / W_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * W_TILE_BYTES);
        tma_load_2d(sa + s * W_TILE_BYTES, &amap, &full[s], 0, p.i * T64);
        tma_load_2d(sb + s * W_TILE_BYTES, &bmap, &full[s], c0, p.col * T64);
      }
    }
    return;
  }

  // Consumer warpgroup: C rows br * 64 .. + 64, columns c0 .. c0 + 64.
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int q = 0;
  Rows row = first_rows(block_ptr, step);
  while (next_row(block_ptr, nb, step, row)) {
    float acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.f;
    int prev = -1;
    for (int i = row.i0; i < row.i1; ++i, ++q) {
      const int s = q % W_STAGES;
      mbar_wait(&full[s], (q / W_STAGES) & 1);
      const uint32_t a0 = smem_addr(sa + s * W_TILE_BYTES);
      const uint32_t b0 = smem_addr(sb + s * W_TILE_BYTES);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T64 / 16; ++kk)
        wgmma_bf16<64>(acc, sw128_desc(a0 + kk * 32, 16, 1024),
                       sw128_desc(b0 + kk * 16 * 128, W_TILE_BYTES, 1024));
      wgmma_commit();
      fence_acc(acc);
      // The group before this one is done: release its stage.
      wgmma_wait<1>();
      fence_acc(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    // Stage the fragment in shared memory (rows padded to 144 bytes: the
    // fragment's eight rows per store fall on distinct banks), then write
    // each C row as 16-byte stores, 128 contiguous bytes per 8 lanes.  The
    // first barrier waits for the last row's reads of the staging tile.
    named_barrier(1, 128);
    {
      const int r = warp * 16 + lane / 4;
      unsigned char* s0 = sc + r * W_C_LD + 4 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(s0 + 16 * j) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(s0 + 8 * W_C_LD + 16 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    named_barrier(1, 128);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int id = threadIdx.x + 128 * m;
      const int r = id / 8, ch = id % 8;
      if (c0 + 8 * ch < d)
        *reinterpret_cast<uint4*>(c + (row.br * T64 + r) * d + c0 + 8 * ch) =
            *reinterpret_cast<const uint4*>(sc + r * W_C_LD + 16 * ch);
    }
  }
}

cudaError_t launch_wgmma_bf16(const void* block_ptr, const void* block_cols,
                              const void* blocks, const void* b, void* c,
                              long long nb, long long num_blocks, int d,
                              cudaStream_t stream) {
  CUtensorMap amap, bmap;
  const cuuint64_t adims[2] = {T64, static_cast<cuuint64_t>(num_blocks) * T64};
  const cuuint64_t astrides[1] = {T64 * 2};
  const cuuint64_t bdims[2] = {static_cast<cuuint64_t>(d),
                               static_cast<cuuint64_t>(nb) * T64};
  const cuuint64_t bstrides[1] = {static_cast<cuuint64_t>(d) * 2};
  const cuuint32_t box[2] = {T64, T64};
  if (!make_map(&amap, blocks, 2, adims, astrides, box) ||
      !make_map(&bmap, b, 2, bdims, bstrides, box))
    return cudaErrorNotSupported;
  cudaError_t err = cudaFuncSetAttribute(
      bcsr_wgmma_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(W_SMEM));
  int resident = 0;
  if (err == cudaSuccess)
    err = resident_blocks(bcsr_wgmma_bf16, W_THREADS, W_SMEM, &resident);
  if (err != cudaSuccess) return err;
  const dim3 grid = ring_grid(resident, nb, (d + T64 - 1) / T64);
  bcsr_wgmma_bf16<<<grid, W_THREADS, W_SMEM, stream>>>(
      amap, bmap, static_cast<const int*>(block_ptr),
      static_cast<const int*>(block_cols), static_cast<__nv_bfloat16*>(c),
      nb, d);
  return cudaGetLastError();
}

}  // namespace

// `quadrants` (uint8 [num_blocks], or null: every quadrant present) is
// read by tile64_f32 alone.
extern "C" int bcsr_spmm_launch(int variant, int value_type,
                                const void* block_ptr, const void* block_cols,
                                const void* quadrants, const void* blocks,
                                const void* b, void* c, long long nb,
                                long long num_blocks, int t, int d,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (nb < 1 || d < 1) return bad;
  const long long slices = (d + T64 - 1) / T64;
  if (variant == VARIANT_TILE64_F32) {
    if (value_type != VALUE_F32 || t != T64 || d % 4 || slices > 65535)
      return bad;
    return static_cast<int>(launch_tile64_f32(block_ptr, block_cols,
                                              quadrants, blocks, b, c, nb, d,
                                              s));
  }
  if (variant == VARIANT_WGMMA_BF16) {
    // TMA coordinates are int32: block rows of A and of B.
    if (value_type != VALUE_BF16 || t != T64 || d % 8 || slices > 65535 ||
        num_blocks < 1 || num_blocks * T64 > 0x7FFFFFFFLL ||
        nb * T64 > 0x7FFFFFFFLL)
      return bad;
    return static_cast<int>(launch_wgmma_bf16(block_ptr, block_cols, blocks,
                                              b, c, nb, num_blocks, d, s));
  }
  if (variant != VARIANT_GENERIC || t < 1 || t > BLOCK_MAX_T) return bad;
  if (value_type == VALUE_F32)
    return static_cast<int>(
        launch_generic<float>(block_ptr, block_cols, blocks, b, c, nb, t, d,
                              s));
  if (value_type == VALUE_BF16)
    return static_cast<int>(launch_generic<__nv_bfloat16>(
        block_ptr, block_cols, blocks, b, c, nb, t, d, s));
  return bad;
}
