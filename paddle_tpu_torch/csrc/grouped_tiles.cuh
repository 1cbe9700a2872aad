// The walks the persistent wgmma bodies share: K13's and K14's (tile,
// group) walk over expert-sorted rows (walk_step, clamp_off), the
// block-order swizzle that keeps one operand's band resident in L2 (K13's
// items and the output tiles of wgmma_quant_tiles.cuh, K2's and K4's tiled
// body, use it), and K13's items (group_item), which its bf16 forms
// (wgmma_tiles.cuh) and its int8/int4 forms (wgmma_quant_tiles.cuh) both
// walk. The bodies themselves are wgmma_tiles.cuh (K13 bf16, K14) and
// wgmma_quant_tiles.cuh (K2, K4, K13 int8/int4).
#pragma once

#include "common.cuh"

namespace pt {
namespace gt {
namespace {  // each including source gets its own copy

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

// K13's work item i (every form): a (step, column tile) pair of the step
// walk over T rows in row tiles of bm, column tiles of bn, the steps
// banded (swizzle) `band` at a time; a parked step has lo == hi
struct GroupItem {
  int tile, group, lo, hi, nt;
};

__device__ __forceinline__ GroupItem group_item(const int* __restrict__ off, int E, int T, int N,
                                                int bm, int bn, int band, int i) {
  const int n_tiles = (T + bm - 1) / bm;
  int step, nt;
  swizzle(i, n_tiles + E - 1, (N + bn - 1) / bn, band, &step, &nt);
  const Step s = walk_step(off, E, T, bm, n_tiles, false, step);
  return {s.tile, s.group, s.lo, s.hi, nt};
}

}  // namespace
}  // namespace gt
}  // namespace pt
