// K14 segment_dw: dw[e] = scale * (x_e^T @ dy_e), cast to the output type,
// for each group e of expert-sorted rows (x_e = rows offsets[e] ..
// offsets[e+1] of x); an empty group writes zeros.
//
// Replaces paddle_tpu/ops/pallas/grouped_matmul.py:_pallas_segment_dw
// (_sdw_kernel :433), whose grid walks (k-block, n-block, step) over the
// group_tile_walk with min_one_step and carries the accumulator across a
// group's steps. Here a work item is one (group, k-tile, n-tile) output
// tile, which walks its group's rows in 64-row slices and accumulates
// x_slice^T @ dy_slice in f32; at the end it applies the scale and casts
// (the ("scale", s), ("cast", dtype) epilogue of segment_dw_pure). No
// atomics, fixed summation order: deterministic. An item of an empty group
// runs no slice and writes its zero accumulator — the reason the TPU walk
// needs min_one_step.
//
// x and dy are read as bf16: the TPU wrapper upcasts both to f32 first,
// which is exact, so only the summation order differs.
//
// Bound on an H100: operations at the MoE train shapes (2 * T * K * N,
// 1.92 TFLOP for T = 16,384 routed rows at 4096 x 14336). The body is
// wgmma_tiles.cuh's (128 x 256 tiles, both operands MN-major: TMA boxes
// of 64 rows of x and dy, read transposed by wgmma). A group's first slice
// starts at row lo (TMA takes any row); its last slice reaches past hi into
// the next group, so before that slice's wgmmas the consumers zero rows
// >= hi of both operands in shared memory and fence them to the async
// proxy. Items run longest group first (the order is ranked on the card
// from the offsets), so each round of the persistent grid walks slices of
// one length; within a group the smaller output axis runs fastest, so the
// smaller operand's group rows stay in L2 while the other streams. Every
// output tile is whole: edges past K or N are masked in the epilogue.
#include "grouped_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace pt {
namespace k14 {

using wg::BK;
using wg::BM;
using wg::BN;

struct Item {
  bool live;
  int n_k, group, mt, nt, lo, hi;
};

__device__ __forceinline__ int group_rows(const int* __restrict__ off, int g, int T) {
  return max(0, gt::clamp_off(off, g + 1, T) - gt::clamp_off(off, g, T));
}

// order[rank] = group: groups by rows, most first, ties by index
__device__ __forceinline__ void rank_groups(int* order, const int* __restrict__ off, int E, int T) {
  for (int g = threadIdx.x; g < E; g += blockDim.x) {
    const int n = group_rows(off, g, T);
    int rank = 0;
    for (int h = 0; h < E; ++h) {
      const int m = group_rows(off, h, T);
      rank += m > n || (m == n && h < g);
    }
    order[rank] = g;
  }
}

__host__ __device__ inline long item_count(int K, int N, int E) {
  return (long)E * ((K + BM - 1) / BM) * ((N + BN - 1) / BN);
}

// Item i: the group of rank i / (tiles a group), then its (k-tile, n-tile)
__device__ __forceinline__ Item sdw_item(const int* order, const int* __restrict__ off, int T,
                                         int K, int N, int i) {
  const int n_mt = (K + BM - 1) / BM, n_nt = (N + BN - 1) / BN;
  const int g = order[i / (n_mt * n_nt)], local = i % (n_mt * n_nt);
  const int mt = K <= N ? local % n_mt : local / n_nt;
  const int nt = K <= N ? local / n_mt : local % n_nt;
  const int lo = gt::clamp_off(off, g, T), hi = max(lo, gt::clamp_off(off, g + 1, T));
  return {true, (hi - lo + BK - 1) / BK, g, mt, nt, lo, hi};
}

template <bool OUT_F32>
struct Sdw {
  static constexpr bool A_MN = true, B_MN = true;
  const CUtensorMap *tx, *tdy;
  const int* off;
  void* dw;
  int T, K, N, E;
  float scale;
  int* order;

  __device__ void setup(unsigned char* extra) {
    order = reinterpret_cast<int*>(extra);
    rank_groups(order, off, E, T);
  }
  __device__ int n_items() const { return (int)item_count(K, N, E); }
  __device__ Item item(int i) const { return sdw_item(order, off, T, K, N, i); }
  __device__ void load(unsigned char* st, uint64_t* bar, const Item& it, int kt) const {
    const int r0 = it.lo + kt * BK;
#pragma unroll
    for (int b = 0; b < BM / 64; ++b)  // x rows r0..r0+63, 64 columns of K each
      wg::tma_load_2d(st + b * wg::BOX_BYTES, tx, bar, it.mt * BM + 64 * b, r0);
#pragma unroll
    for (int b = 0; b < BN / 64; ++b)  // dy rows r0..r0+63, 64 columns of N each
      wg::tma_load_2d(st + wg::A_BYTES + b * wg::BOX_BYTES, tdy, bar, it.nt * BN + 64 * b, r0);
  }
  // the last slice: zero rows >= hi in all six boxes (A's 2, B's 4: 8 KB
  // apart from the stage's start), then hand them to wgmma
  __device__ void prep(unsigned char* st, const Item& it, int kt) const {
    const int valid = it.hi - (it.lo + kt * BK);
    if (kt != it.n_k - 1 || valid >= BK) return;
    const int cut = (BK - valid) * 8;  // 16-byte vectors of a box past hi
    for (int v = threadIdx.x - 128; v < 6 * cut; v += 256) {
      const int box = v / cut, r = valid + v % cut / 8;
      *reinterpret_cast<uint4*>(st + box * wg::BOX_BYTES + r * 128 + v % 8 * 16) =
          make_uint4(0, 0, 0, 0);
    }
    wg::fence_proxy_async();
    wg::named_barrier(1, 256);
  }
  __device__ void store(const float (&acc)[128], const Item& it, int c) const {
    const int r0 = it.mt * BM + 64 * c, c0 = it.nt * BN;
    auto put = [&](int r, int col, uint4 v) {
      const int row = r0 + r, cc = c0 + col;
      if (row >= K || cc >= N) return;
      const size_t at = ((size_t)it.group * K + row) * N + cc;
      if constexpr (OUT_F32)
        *reinterpret_cast<uint4*>(static_cast<float*>(dw) + at) = v;
      else
        *reinterpret_cast<uint4*>(static_cast<bf16*>(dw) + at) = v;
    };
    if constexpr (OUT_F32)
      wg::store_f32(acc, scale, put);
    else
      wg::store_bf16(acc, wg::Uniform{scale}, put);
  }
};

template <bool OUT_F32>
__global__ void __launch_bounds__(wg::NT, 1)
segment_dw_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
                  const int* __restrict__ offsets, void* __restrict__ dw, int T, int K, int N,
                  int E, float scale) {
  wg::run(Sdw<OUT_F32>{&tx, &tdy, offsets, dw, T, K, N, E, scale, nullptr});
}

__global__ void items_kernel(const int* __restrict__ offsets, int E, int T, int K, int N, int n,
                             int* out) {
  extern __shared__ int order[];
  rank_groups(order, offsets, E, T);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const Item it = sdw_item(order, offsets, T, K, N, i);
    int* o = out + 6 * i;
    o[0] = it.group, o[1] = it.mt, o[2] = it.nt, o[3] = it.lo, o[4] = it.hi, o[5] = it.n_k;
  }
}

template <bool OUT_F32>
cudaError_t launch(const void* x, const void* dy, const void* offsets, void* dw, int T, int K,
                   int N, int E, float scale, cudaStream_t stream) {
  CUtensorMap tx{}, tdy{};  // T = 0: every group is empty and no slice is loaded
  if (T > 0) {
    const cuuint32_t box[2] = {64, BK};
    const cuuint64_t dx[2] = {(cuuint64_t)K, (cuuint64_t)T};
    cudaError_t err = wg::bf16_map(&tx, x, 2, dx, box);
    if (err != cudaSuccess) return err;
    const cuuint64_t dd[2] = {(cuuint64_t)N, (cuuint64_t)T};
    err = wg::bf16_map(&tdy, dy, 2, dd, box);
    if (err != cudaSuccess) return err;
  }
  return wg::launch_persistent(segment_dw_kernel<OUT_F32>, item_count(K, N, E),
                               wg::SMEM_BYTES + 4 * E, stream, tx, tdy,
                               static_cast<const int*>(offsets), dw, T, K, N, E, scale);
}

}  // namespace k14
}  // namespace pt

using namespace pt::k14;

// x (T, K) bf16, dy (T, N) bf16, offsets (E + 1,) int32 as K13 takes them;
// dw (E, K, N) f32 (out_f32 = 1) or bf16. scale multiplies each f32 sum
// before the cast (1 for none). Requires K % 8 == 0, N % 8 == 0 and
// 16-byte-aligned x and dy.
PT_EXPORT int pt_segment_dw(const void* x, const void* dy, const void* offsets, void* dw, int T,
                            int K, int N, int E, float scale, int out_f32, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch<true>(x, dy, offsets, dw, T, K, N, E, scale, s)
                 : launch<false>(x, dy, offsets, dw, T, K, N, E, scale, s);
}

// K14's work items as the kernel decodes them, in walk order: out holds
// item_count(K, N, E) rows of (group, k-tile, n-tile, lo, hi, slices)
// int32 (the card tests hold it to grouped_matmul.sdw_items).
PT_EXPORT int pt_segment_dw_items(const void* offsets, int T, int K, int N, int E, void* out,
                                  void* stream) {
  const long n = item_count(K, N, E);
  if (n <= 0) return cudaSuccess;
  items_kernel<<<1, 256, 4 * E, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(offsets), E, T, K, N, (int)n, static_cast<int*>(out));
  return cudaGetLastError();
}
