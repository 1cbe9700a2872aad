// K13 grouped_matmul: y[r] = x[r] @ w[group(r)] over expert-sorted rows,
// with no per-group padding.
//
// Replaces paddle_tpu/ops/pallas/grouped_matmul.py:_pallas_grouped_matmul
// (_gmm_kernel :156). The TPU kernel walks (n-block, step, k-block) over
// the in-graph group_tile_walk, carrying an f32 accumulator across the two
// steps of a row tile that straddles a group boundary and overwriting the
// partial on flush. Here a work item is one (step, n-tile): a step is one
// (row tile, group) intersection, computed on the card from the offsets
// (walk_step, the same integers as group_tile_walk), and an item writes
// only rows [lo, hi) of its tile. Two steps that share a tile write
// disjoint rows, so nothing is carried and nothing is overwritten. The
// number of steps is fixed at n_tiles + E - 1, as on the TPU; parked steps
// cost no slice, so no count ever returns to the host.
//
// TRANS reads w as (E, N, K) and multiplies by w[g]^T: the dX form of the
// backward (dx = dy @ w[g]^T). TMA stages each weight slice as it lies and
// wgmma reads it K-major — no transposed copy of the stacked weight.
//
// Bound on an H100: operations at the MoE train shapes (T = 16,384 rows,
// 4096 x 14336: 1.92 TFLOP against 1.5 GB, ~1.95 ms at the bf16 peak).
// The body is wgmma_tiles.cuh's: 128 x 256 tiles, wgmma from TMA-fed
// stages, a producer warp and two consumer warpgroups, a persistent grid.
// x's map is 2-D (rows past T read as zeros); w's is 3-D (E, K, N) or
// (E, N, K), so a K or N edge reads zeros, never the next expert's rows.
// Items run in bands of row tiles (grouped_tiles.cuh group_item), so a
// band's x rows stay in L2 while the n-tiles stream past. The epilogue
// writes 16-byte vectors of rows [lo, hi) only: a TMA store of the whole
// tile would overwrite the other step's rows at a group boundary.
#include "grouped_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace pt {
namespace k13 {

using wg::BK;
using wg::BM;
using wg::BN;

struct Item {
  bool live;
  int n_k, tile, group, lo, hi, nt;
};

// the row tiles whose x rows fill ~16 MB of L2 together
inline int band_for(int K) {
  const int rows_fit = (16 << 20) / (BM * K * 2);
  return rows_fit < 1 ? 1 : (rows_fit > 16 ? 16 : rows_fit);
}

// (n_tiles + E - 1) steps x the n-tiles of bn columns
__host__ __device__ inline long item_count(int T, int N, int E, int bn = BN) {
  return (long)((T + BM - 1) / BM + E - 1) * ((N + bn - 1) / bn);
}

// Item i: a (step, n-tile) pair in banded order, n-tiles of bn columns;
// a parked step is not live
__device__ __forceinline__ Item gmm_item(const int* __restrict__ off, int E, int T, int K, int N,
                                         int bn, int band, int i) {
  const gt::GroupItem s = gt::group_item(off, E, T, N, BM, bn, band, i);
  const bool live = s.lo < s.hi;
  return {live, live ? (K + BK - 1) / BK : 0, s.tile, s.group, s.lo, s.hi, s.nt};
}

template <bool TRANS>
struct Gmm {
  static constexpr bool A_MN = false, B_MN = !TRANS;
  const CUtensorMap *tx, *tw;
  const int* off;
  bf16* y;
  int T, K, N, E, band;

  __device__ void setup(unsigned char*) {}
  __device__ int n_items() const { return (int)item_count(T, N, E); }
  __device__ Item item(int i) const { return gmm_item(off, E, T, K, N, BN, band, i); }
  __device__ void load(unsigned char* st, uint64_t* bar, const Item& it, int kt) const {
    const int k0 = kt * BK, n0 = it.nt * BN;
    wg::tma_load_2d(st, tx, bar, k0, it.tile * BM);  // x rows: 128 x 64
    if constexpr (TRANS) {
      wg::tma_load_3d(st + wg::A_BYTES, tw, bar, k0, n0, it.group);  // w[g] rows n: 256 x 64
    } else {
#pragma unroll
      for (int b = 0; b < BN / 64; ++b)  // w[g] rows k: 64 x 64 columns, 4 boxes
        wg::tma_load_3d(st + wg::A_BYTES + b * wg::BOX_BYTES, tw, bar, n0 + 64 * b, k0, it.group);
    }
  }
  __device__ void prep(unsigned char*, const Item&, int) const {}
  __device__ void store(const float (&acc)[128], const Item& it, int c) const {
    const int r0 = it.tile * BM + 64 * c, c0 = it.nt * BN;
    wg::store_bf16(acc, wg::Uniform{1.f}, [&](int r, int col, uint4 v) {
      const int row = r0 + r, cc = c0 + col;
      if (row >= it.lo && row < it.hi && cc < N)
        *reinterpret_cast<uint4*>(y + (size_t)row * N + cc) = v;
    });
  }
};

template <bool TRANS>
__global__ void __launch_bounds__(wg::NT, 1)
grouped_matmul_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                      const int* __restrict__ offsets, bf16* __restrict__ y, int T, int K, int N,
                      int E, int band) {
  wg::run(Gmm<TRANS>{&tx, &tw, offsets, y, T, K, N, E, band});
}

__global__ void walk_kernel(const int* __restrict__ offsets, int E, int T, int bm, int n_tiles,
                            int min_one_step, int n_steps, int* tile, int* group, int* lo,
                            int* hi) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_steps) return;
  const gt::Step s = gt::walk_step(offsets, E, T, bm, n_tiles, min_one_step != 0, i);
  tile[i] = s.tile;
  group[i] = s.group;
  lo[i] = s.lo;
  hi[i] = s.hi;
}

__global__ void items_kernel(const int* __restrict__ offsets, int E, int T, int K, int N, int bn,
                             int band, int n, int* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Item it = gmm_item(offsets, E, T, K, N, bn, band, i);
  int* o = out + 6 * i;
  o[0] = it.tile, o[1] = it.group, o[2] = it.lo, o[3] = it.hi, o[4] = it.nt, o[5] = it.n_k;
}

template <bool TRANS>
cudaError_t launch(const void* x, const void* offsets, const void* w, void* y, int T, int K,
                   int N, int E, cudaStream_t stream) {
  CUtensorMap tx, tw;
  const cuuint64_t dx[2] = {(cuuint64_t)K, (cuuint64_t)T};
  const cuuint32_t bx[2] = {64, BM};
  cudaError_t err = wg::bf16_map(&tx, x, 2, dx, bx);
  if (err != cudaSuccess) return err;
  if (TRANS) {
    const cuuint64_t dw[3] = {(cuuint64_t)K, (cuuint64_t)N, (cuuint64_t)E};
    const cuuint32_t bw[3] = {64, BN, 1};
    err = wg::bf16_map(&tw, w, 3, dw, bw);
  } else {
    const cuuint64_t dw[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
    const cuuint32_t bw[3] = {64, 64, 1};
    err = wg::bf16_map(&tw, w, 3, dw, bw);
  }
  if (err != cudaSuccess) return err;
  return wg::launch_persistent(grouped_matmul_kernel<TRANS>, item_count(T, N, E), wg::SMEM_BYTES,
                               stream, tx, tw, static_cast<const int*>(offsets),
                               static_cast<bf16*>(y), T, K, N, E, band_for(K));
}

}  // namespace k13
}  // namespace pt

using namespace pt::k13;

// x (T, K) bf16; offsets (E + 1,) int32, offsets[0] = 0, offsets[E] = T,
// non-decreasing; w (E, K, N) bf16 (trans = 0) or (E, N, K) (trans = 1,
// y = x @ w[g]^T); y (T, N) bf16. Requires T >= 1, K % 8 == 0, N % 8 == 0
// and 16-byte-aligned x and w (checked by the Python wrapper).
PT_EXPORT int pt_grouped_matmul(const void* x, const void* offsets, const void* w, void* y,
                                int T, int K, int N, int E, int trans, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return trans ? launch<true>(x, offsets, w, y, T, K, N, E, s)
               : launch<false>(x, offsets, w, y, T, K, N, E, s);
}

// The walk the kernels run, written out: n_steps int32 entries each of
// tile, group, lo, hi for row tiles of bm rows (the card tests hold it to
// group_tile_walk).
PT_EXPORT int pt_group_tile_walk(const void* offsets, int E, int T, int bm, int n_tiles,
                                 int min_one_step, int n_steps, void* tile, void* group, void* lo,
                                 void* hi, void* stream) {
  walk_kernel<<<(n_steps + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(offsets), E, T, bm, n_tiles, min_one_step, n_steps,
      static_cast<int*>(tile), static_cast<int*>(group), static_cast<int*>(lo),
      static_cast<int*>(hi));
  return cudaGetLastError();
}

// K13's work items as its forms decode them, in walk order, for n-tiles
// of block_n columns (256: the bf16 forms and the per-channel int8/int4
// forms; 128: the group-wise ones): out holds item_count(T, N, E,
// block_n) rows of (tile, group, lo, hi, n-tile, slices) int32 (the card
// tests hold it to grouped_matmul.gmm_items).
PT_EXPORT int pt_grouped_matmul_items(const void* offsets, int T, int K, int N, int E, int block_n,
                                      void* out, void* stream) {
  const long n = item_count(T, N, E, block_n);
  if (n <= 0) return cudaSuccess;
  items_kernel<<<(int)((n + 127) / 128), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(offsets), E, T, K, N, block_n, band_for(K), (int)n,
      static_cast<int*>(out));
  return cudaGetLastError();
}
