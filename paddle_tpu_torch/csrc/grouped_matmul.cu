// K13 grouped_matmul: y[r] = x[r] @ w[group(r)] over expert-sorted rows,
// with no per-group padding.
//
// Replaces paddle_tpu/ops/pallas/grouped_matmul.py:_pallas_grouped_matmul
// (_gmm_kernel :156). The TPU kernel walks (n-block, step, k-block) over
// the in-graph group_tile_walk, carrying an f32 accumulator across the two
// steps of a row tile that straddles a group boundary and overwriting the
// partial on flush. Here one block owns one (step, n-tile): a step is one
// (row tile, group) intersection, computed by the block itself from the
// offsets (walk_step, the same integers as group_tile_walk), and writes
// only rows [lo, hi) of its tile. Two steps that share a tile write
// disjoint rows, so nothing is carried and nothing is overwritten. The
// number of steps is fixed at n_tiles + E - 1, as on the TPU; parked steps
// exit at once, so no count ever returns to the host.
//
// TRANS reads w as (E, N, K) and multiplies by w[g]^T: the dX form of the
// backward (dx = dy @ w[g]^T), which stages each weight slice as it lies
// and reads it as B fragments with a non-transposing ldmatrix — no
// transposed copy of the stacked weight.
//
// Bound on an H100: operations at the MoE train shapes (T = 16,384 rows,
// 4096 x 14336: 1.92 TFLOP against 1.5 GB, ~1.95 ms at the bf16 peak).
// The tiles, ring and epilogue are grouped_tiles.cuh's (128 x 128 blocks,
// bf16 mma.sync with f32 accumulators, three cp.async slices in flight);
// blocks run
// in bands of row tiles so a band's x rows stay in L2 while the n-tiles
// stream past.
#include "grouped_tiles.cuh"

namespace pt {
namespace k13 {

using namespace pt::gt;

template <bool TRANS>
__global__ void __launch_bounds__(NT, 2)
grouped_matmul_kernel(const bf16* __restrict__ x, const int* __restrict__ offsets,
                      const bf16* __restrict__ w, bf16* __restrict__ y, int T, int K, int N,
                      int E, int band) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Step st;
  const int n_tiles = (T + BM - 1) / BM;
  int step, nt;
  swizzle(blockIdx.x, n_tiles + E - 1, (N + BN - 1) / BN, band, &step, &nt);
  if (threadIdx.x == 0) st = walk_step(offsets, E, T, BM, n_tiles, false, step);
  __syncthreads();
  const Step s = st;
  if (s.lo >= s.hi) return;  // a parked step
  const int m0 = s.tile * BM, n0 = nt * BN, tid = threadIdx.x;
  const bf16* wg = w + (size_t)s.group * K * N;

  auto load = [&](unsigned char* stage, int kt) {
    const int k0 = kt * BK;
    bf16* As = reinterpret_cast<bf16*>(stage);
    bf16* Bs = reinterpret_cast<bf16*>(stage + SLICE_BYTES);
    for (int v = tid; v < BM * (BK / 8); v += NT) {  // rows outside [lo, hi) stage zeros
      const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      const int row = m0 + r, col = k0 + c;
      const bool ok = row >= s.lo && row < s.hi && col < K;
      cp_async16(As + r * LD_COL + c, ok ? x + (size_t)row * K + col : x, ok);
    }
    if constexpr (TRANS) {  // Bs[n][k] = w[g][n0 + n][k0 + k]
      for (int v = tid; v < BN * (BK / 8); v += NT) {
        const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
        const bool ok = n0 + r < N && k0 + c < K;
        cp_async16(Bs + r * LD_COL + c, ok ? wg + (size_t)(n0 + r) * K + k0 + c : w, ok);
      }
    } else {  // Bs[k][n] = w[g][k0 + k][n0 + n]
      for (int v = tid; v < BK * (BN / 8); v += NT) {
        const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
        const bool ok = k0 + r < K && n0 + c < N;
        cp_async16(Bs + r * LD_ROW + c, ok ? wg + (size_t)(k0 + r) * N + n0 + c : w, ok);
      }
    }
  };
  Acc acc;
  run_ring<false, TRANS>(smem, (K + BK - 1) / BK, load, acc);
  epilogue(acc, [&](int r, int c, float v0, float v1) {
    const int row = m0 + r, col = n0 + c;
    if (row >= s.lo && row < s.hi && col < N)
      *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * N + col) = __floats2bfloat162_rn(v0, v1);
  });
}

__global__ void walk_kernel(const int* __restrict__ offsets, int E, int T, int bm, int n_tiles,
                            int min_one_step, int n_steps, int* tile, int* group, int* lo,
                            int* hi) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_steps) return;
  const Step s = walk_step(offsets, E, T, bm, n_tiles, min_one_step != 0, i);
  tile[i] = s.tile;
  group[i] = s.group;
  lo[i] = s.lo;
  hi[i] = s.hi;
}

template <bool TRANS>
cudaError_t launch(const void* x, const void* offsets, const void* w, void* y, int T, int K,
                   int N, int E, cudaStream_t stream) {
  auto kern = grouped_matmul_kernel<TRANS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int n_steps = (T + BM - 1) / BM + E - 1;
  const int n_nt = (N + BN - 1) / BN;
  // the row tiles whose x rows fill ~16 MB of L2 together
  const int rows_fit = (16 << 20) / (BM * K * 2);
  const int band = rows_fit < 1 ? 1 : (rows_fit > 16 ? 16 : rows_fit);
  kern<<<n_steps * n_nt, NT, SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(offsets),
      static_cast<const bf16*>(w), static_cast<bf16*>(y), T, K, N, E, band);
  return cudaGetLastError();
}

}  // namespace k13
}  // namespace pt

using namespace pt::k13;

// x (T, K) bf16; offsets (E + 1,) int32, offsets[0] = 0, offsets[E] = T,
// non-decreasing; w (E, K, N) bf16 (trans = 0) or (E, N, K) (trans = 1,
// y = x @ w[g]^T); y (T, N) bf16. Requires T >= 1, K % 8 == 0 and
// N % 8 == 0 (checked by the Python wrapper).
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
