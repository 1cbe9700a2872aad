// K14 segment_dw: dw[e] = scale * (x_e^T @ dy_e), cast to the output type,
// for each group e of expert-sorted rows (x_e = rows offsets[e] ..
// offsets[e+1] of x); an empty group writes zeros.
//
// Replaces paddle_tpu/ops/pallas/grouped_matmul.py:_pallas_segment_dw
// (_sdw_kernel :433), whose grid walks (k-block, n-block, step) over the
// group_tile_walk with min_one_step and carries the accumulator across a
// group's steps. Here one block owns one (group, k-tile, n-tile) output
// tile and walks its group's rows in 64-row slices itself, accumulating
// x_slice^T @ dy_slice in f32; at the end it applies the scale and casts
// (the ("scale", s), ("cast", dtype) epilogue of segment_dw_pure). No
// atomics, fixed summation order: deterministic. A block of an empty group
// runs no slice and writes its zero accumulator — the reason the TPU walk
// needs min_one_step.
//
// x and dy are read as bf16: the TPU wrapper upcasts both to f32 first,
// which is exact, so only the summation order differs.
//
// Bound on an H100: operations at the MoE train shapes (2 * T * K * N,
// 1.92 TFLOP for T = 16,384 routed rows at 4096 x 14336). The tiles, ring
// and epilogue are grouped_tiles.cuh's; the block order walks the smaller
// of the two output axes fastest, so the smaller operand's group rows
// (x_e when K <= N, dy_e otherwise) stay in L2 while the other streams.
#include "grouped_tiles.cuh"

namespace pt {
namespace k14 {

using namespace pt::gt;

template <bool OUT_F32>
__global__ void __launch_bounds__(NT, 2)
segment_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                  const int* __restrict__ offsets, void* __restrict__ dw, int T, int K, int N,
                  float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_mt = (K + BM - 1) / BM, n_nt = (N + BN - 1) / BN;
  const int g = blockIdx.x / (n_mt * n_nt);
  const int local = blockIdx.x % (n_mt * n_nt);
  const int mt = K <= N ? local % n_mt : local / n_nt;
  const int nt = K <= N ? local / n_mt : local % n_nt;
  const int lo = clamp_off(offsets, g, T), hi = max(lo, clamp_off(offsets, g + 1, T));
  const int m0 = mt * BM, n0 = nt * BN, tid = threadIdx.x;

  auto load = [&](unsigned char* stage, int kt) {
    const int r0 = lo + kt * BK;
    bf16* As = reinterpret_cast<bf16*>(stage);  // As[r][m] = x[r0 + r][m0 + m]
    bf16* Bs = reinterpret_cast<bf16*>(stage + SLICE_BYTES);  // Bs[r][n] = dy[r0 + r][n0 + n]
    for (int v = tid; v < BK * (BM / 8); v += NT) {  // rows past the group stage zeros
      const int r = v / (BM / 8), c = (v % (BM / 8)) * 8;
      const bool ok = r0 + r < hi && m0 + c < K;
      cp_async16(As + r * LD_ROW + c, ok ? x + (size_t)(r0 + r) * K + m0 + c : x, ok);
    }
    for (int v = tid; v < BK * (BN / 8); v += NT) {
      const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
      const bool ok = r0 + r < hi && n0 + c < N;
      cp_async16(Bs + r * LD_ROW + c, ok ? dy + (size_t)(r0 + r) * N + n0 + c : dy, ok);
    }
  };
  Acc acc;
  run_ring<true, false>(smem, (hi - lo + BK - 1) / BK, load, acc);
  epilogue(acc, [&](int r, int c, float v0, float v1) {
    const int row = m0 + r, col = n0 + c;
    if (row >= K || col >= N) return;
    const size_t at = ((size_t)g * K + row) * N + col;
    if constexpr (OUT_F32)
      *reinterpret_cast<float2*>(static_cast<float*>(dw) + at) = make_float2(v0 * scale, v1 * scale);
    else
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(dw) + at) =
          __floats2bfloat162_rn(v0 * scale, v1 * scale);
  });
}

template <bool OUT_F32>
cudaError_t launch(const void* x, const void* dy, const void* offsets, void* dw, int T, int K,
                   int N, int E, float scale, cudaStream_t stream) {
  auto kern = segment_dw_kernel<OUT_F32>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int blocks = E * ((K + BM - 1) / BM) * ((N + BN - 1) / BN);
  kern<<<blocks, NT, SMEM_BYTES, stream>>>(static_cast<const bf16*>(x),
                                           static_cast<const bf16*>(dy),
                                           static_cast<const int*>(offsets), dw, T, K, N, scale);
  return cudaGetLastError();
}

}  // namespace k14
}  // namespace pt

using namespace pt::k14;

// x (T, K) bf16, dy (T, N) bf16, offsets (E + 1,) int32 as K13 takes them;
// dw (E, K, N) f32 (out_f32 = 1) or bf16. scale multiplies each f32 sum
// before the cast (1 for none). Requires K % 8 == 0 and N % 8 == 0.
PT_EXPORT int pt_segment_dw(const void* x, const void* dy, const void* offsets, void* dw, int T,
                            int K, int N, int E, float scale, int out_f32, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch<true>(x, dy, offsets, dw, T, K, N, E, scale, s)
                 : launch<false>(x, dy, offsets, dw, T, K, N, E, scale, s);
}
