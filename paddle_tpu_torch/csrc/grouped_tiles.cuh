// K2's dense tiled body (norm_matmul.cu), and the walk K13 and K14 share:
// the (tile, group) walk over expert-sorted rows (walk_step, clamp_off),
// the 128 x 128 block tile (8 warps of 64 x 32, bf16 ldmatrix + mma.sync
// m16n8k16 with f32 accumulators in registers), the cp.async ring that
// feeds it 16-byte vectors, the register epilogue, and the block-order
// swizzle that keeps one operand's band resident in L2 (K13's items use it
// too). K13 (grouped_matmul.cu) and K14 (segment_dw.cu) run
// wgmma_tiles.cuh's body instead.
//
// K2 is bound by tensor-core operations at the train and prefill shapes.
// It stages 64-deep slices with cp.async, three in flight, so the loads of
// slice k+2 overlap the MMAs of slice k, and passes one block barrier per
// slice.
#pragma once

#include "mma_sync.cuh"

namespace pt {
namespace gt {
namespace {  // each including source gets its own copy

constexpr int BM = 128, BN = 128, BK = 64;  // block tile; BK = the reduction slice
constexpr int WM = 64, WN = 32;             // warp tile: 2 x 4 warps
constexpr int WARPS_N = BN / WN;
constexpr int NT = (BM / WM) * WARPS_N * 32;  // 256 threads
constexpr int FM = WM / 16;
constexpr int STAGES = 3;
constexpr int LD_ROW = BN + 8;  // a [BK][BN] or [BK][BM] slice, bf16 (272-byte rows)
constexpr int LD_COL = BK + 8;  // a [BM][BK] or [BN][BK] slice, bf16 (144-byte rows)
constexpr int SLICE_BYTES = BM * LD_COL * 2 > BK * LD_ROW * 2 ? BM * LD_COL * 2 : BK * LD_ROW * 2;
constexpr int STAGE_BYTES = 2 * SLICE_BYTES;  // A slice + B slice
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
static_assert(BM == BN, "one slice size serves both operands");

constexpr int NI = WN / 8;  // 8-column mma tiles of a warp
// a warp's f32 accumulators: [16-row tile][8-column tile][4] in the
// mma.m16n8k16 layout (c0, c1: row g, columns 2t, 2t+1; c2, c3: row g + 8).
// The body below also runs with fewer 16-row tiles a warp (FM_ < FM: a
// block tile of 2 x 16 FM_ rows in the same stages), deduced from the
// accumulator the caller passes.
typedef float Acc[FM][NI][4];

// One step of the walk (paddle_tpu/ops/pallas/grouped_matmul.py
// group_tile_walk, the same integers): step i of n_tiles + E - 1 covers rows
// [lo, hi) of row tile `tile` against group `group`; a group owns its
// intersecting tiles in order, so a tile that straddles a boundary is two
// steps with disjoint rows. Steps past the walk are parked on the last
// tile with an empty range. min_one_step gives an empty group one empty
// step. Offsets are clamped into [0, T] so that bad offsets cannot address
// past x.
struct Step {
  int tile, group, lo, hi;
};

__device__ __forceinline__ int clamp_off(const int* off, int g, int T) {
  return min(max(off[g], 0), T);
}

__device__ Step walk_step(const int* __restrict__ off, int E, int T, int bm, int n_tiles,
                          bool min_one_step, int i) {
  int cum = 0;
  for (int g = 0; g < E; ++g) {
    const int lo = clamp_off(off, g, T), hi = clamp_off(off, g + 1, T);
    const int start = lo / bm;
    const int count = hi > lo ? (hi - 1) / bm - start + 1 : (min_one_step ? 1 : 0);
    if (i < cum + count) {
      const int tile = min(start + (i - cum), n_tiles - 1);
      return {tile, g, max(lo, tile * bm), min(hi, (tile + 1) * bm)};
    }
    cum += count;
  }
  return {n_tiles - 1, E - 1, 0, 0};  // parked
}

// Block order: the linear block id walks `band` consecutive indices of
// the banded axis (n_band long) fastest, then the other axis — so the
// blocks in flight share a band of the banded axis's operand and a run of
// the other's, and both stay in L2.
__device__ __forceinline__ void swizzle(int bid, int n_band, int n_other, int band, int* banded,
                                        int* other) {
  const int first = (bid / (band * n_other)) * band;
  const int width = min(band, n_band - first);
  const int local = bid - first * n_other;
  *banded = first + local % width;
  *other = local / width;
}

// Multiply one staged slice pair with ldmatrix + mma.sync: A is a
// [BM][LD_COL] row-major slice (A_COL: a [BK][LD_ROW] slice of x rows,
// whose transpose is A: K14's x^T), B a [BK][LD_ROW] row-major slice
// (B_COL: a [BN][LD_COL] slice of w[g] rows, whose transpose is B: K13's
// dX form). Padded rows (144 or 272 bytes) keep every ldmatrix phase on
// distinct banks.
template <bool A_COL, bool B_COL, int FM_>
__device__ __forceinline__ void mma_slice(const bf16* As, const bf16* Bs, int wm, int wn,
                                          float (&acc)[FM_][NI][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    unsigned a[FM_][4], b[NI][2];
#pragma unroll
    for (int i = 0; i < FM_; ++i) {
      const int m = wm * 16 * FM_ + i * 16;
      if constexpr (A_COL)
        ldsm4_t(a[i], As + (kk + lane % 8 + (lane / 16) * 8) * LD_ROW + m + ((lane / 8) % 2) * 8);
      else
        ldsm4(a[i], As + (m + lane % 16) * LD_COL + kk + (lane / 16) * 8);
    }
#pragma unroll
    for (int j = 0; j < NI; j += 2) {
      const int n = wn * WN + j * 8;
      unsigned r[4];
      if constexpr (B_COL)
        ldsm4(r, Bs + (n + lane % 8 + (lane / 16) * 8) * LD_COL + kk + ((lane / 8) % 2) * 8);
      else
        ldsm4_t(r, Bs + (kk + lane % 16) * LD_ROW + n + (lane / 16) * 8);
      b[j][0] = r[0];
      b[j][1] = r[1];
      b[j + 1][0] = r[2];
      b[j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < FM_; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) mma16816(acc[i][j], a[i], b[j][0], b[j][1]);
  }
}

// The cp.async ring over n_k slices: load(stage, k) stages slice k. Slice
// k + STAGES - 1 is requested while slice k is multiplied. prep(stage, k)
// runs in each thread once its own copies of slice k have landed, before
// the barrier that hands the slice to every warp: it may rewrite the
// 16-byte vectors this thread copied (K2 normalizes its x rows there).
struct NoPrep {
  __device__ __forceinline__ void operator()(unsigned char*, int) const {}
};

template <bool A_COL, bool B_COL, typename Load, int FM_, typename Prep = NoPrep>
__device__ __forceinline__ void run_ring(unsigned char* smem, int n_k, Load load,
                                         float (&acc)[FM_][NI][4], Prep prep = Prep()) {
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
#pragma unroll
  for (int i = 0; i < FM_; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load(smem + s * STAGE_BYTES, s);
    cp_async_commit();
  }
  for (int k = 0; k < n_k; ++k) {
    cp_async_wait<STAGES - 2>();
    prep(smem + (k % STAGES) * STAGE_BYTES, k);
    __syncthreads();  // slice k landed for every thread; slice k - 1's stage is free
    const int next = k + STAGES - 1;
    if (next < n_k) load(smem + (next % STAGES) * STAGE_BYTES, next);
    cp_async_commit();
    const unsigned char* st = smem + (k % STAGES) * STAGE_BYTES;
    mma_slice<A_COL, B_COL>(reinterpret_cast<const bf16*>(st),
                            reinterpret_cast<const bf16*>(st + SLICE_BYTES), wm, wn, acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // no copy in flight, no thread still reading a slice
}

// The epilogue, straight from the registers: store(row, col, v0, v1) for
// each pair of adjacent columns a thread holds (row, col relative to the
// block tile); the caller masks and writes.
template <int FM_, typename Store>
__device__ __forceinline__ void epilogue(const float (&acc)[FM_][NI][4], Store store) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
#pragma unroll
  for (int i = 0; i < FM_; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int r = wm * 16 * FM_ + i * 16 + lane / 4, c = wn * WN + j * 8 + (lane % 4) * 2;
      store(r, c, acc[i][j][0], acc[i][j][1]);
      store(r + 8, c, acc[i][j][2], acc[i][j][3]);
    }
}

}  // namespace
}  // namespace gt
}  // namespace pt
