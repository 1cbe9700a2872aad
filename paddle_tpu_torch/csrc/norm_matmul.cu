// K2 norm_matmul: y = ((x32 * rsqrt(mean(x32^2) + eps)).to(bf16) * w_norm) @ W
//
// Replaces paddle_tpu/ops/pallas/fused_norm_matmul.py:_pallas_fnm (resident,
// M <= 1024; _fnm_kernel :79) and :_pallas_fnm_streamed (M > 1024;
// _fnm_stream_kernel :189) with ONE entry point that takes any M. The
// normalized activations never touch device memory — the point of the TPU
// fusion; only rstd (M floats, M > 16) does. W is dense bf16 or
// weight-only int8 / packed int4 with per-channel or group-wise scales,
// dequantized into a bf16 tile in shared memory as _fnm_kernel does
// (bf16(code) * bf16(scale), rounded to bf16).
//
// Numerics follow _pure_rms / _fnm_kernel: rstd = 1 / sqrtf(mean(x32^2) +
// eps) in f32; bf16(x32 * rstd), times w_norm, rounded to bf16 (the exact
// product of two bf16 values rounded once, which __hmul2 computes); then
// a dot with f32 accumulation and one bf16 rounding of the output.
//
// Two bodies:
//   M > 16 (prefill, train, the batcher's waves), any W: two kernels.
//     norm_rstd_kernel writes each row's rstd once (one warp a row, the
//     summation order of matmul_tiles.cuh rows_rstd), then
//     quant_wgmma_kernel (wgmma_quant_tiles.cuh, shared with K4) runs the
//     Hopper body: a persistent banded grid, a producer thread keeping a
//     4-stage TMA ring of x slices and W slices in flight, three warps of
//     the producer warpgroup normalizing each landed x slice in place, two
//     consumer warpgroups on wgmma with f32 accumulators in registers,
//     128 x 256 tiles (128 x 128 where 256-wide ones would fill at most
//     half the SMs). A dense W reaches wgmma straight from the ring, as
//     K13's forward B operand; quantized codes are dequantized into a bf16
//     B tile first. No split-K: two calls give the same bits
//     (quant_matmul.quant_tiles and block_n model the walk).
//   M <= 16 (decode), any W: one kernel, skinny_wgmma_kernel
//     (skinny_tiles.cuh, shared with K4), bound by the bytes of W: a TMA
//     ring of W slices on every SM, operands swapped (W^T . x^T, no MMA row
//     of padding), rstd computed in the block in rows_rstd's order while W
//     streams, K split across a thread-block cluster and summed in rank
//     order (deterministic).
//
// Bound on an H100: at M = 8192, K = 4096, N = 14336 (the train step's
// gate/up projections) 0.96 TFLOP of bf16 products, 0.97 ms at the 989
// TFLOP/s peak, against 0.42 GB of bytes (0.12 ms): operations; so at
// prefill (M = 1024: 0.12 ms at N = 14336). At the batcher's M = 264 the
// bytes of W bound it (0.038 ms at N = 14336).
#include "skinny_tiles.cuh"

namespace pt {
namespace k2 {

constexpr int RSTD_ROWS = 8;  // rows a norm_rstd_kernel block (a warp each)

__global__ void __launch_bounds__(RSTD_ROWS * 32)
norm_rstd_kernel(const bf16* __restrict__ x, float* __restrict__ rstd, int M, int K, float eps) {
  __shared__ float r[RSTD_ROWS];
  const int m0 = blockIdx.x * RSTD_ROWS;
  pt::mm::rows_rstd(x, r, m0, RSTD_ROWS, M, K, eps, threadIdx.x / 32, RSTD_ROWS);
  __syncthreads();
  if (threadIdx.x < RSTD_ROWS && m0 + threadIdx.x < M) rstd[m0 + threadIdx.x] = r[threadIdx.x];
}

// each row's rstd into rstd[0, M): the tiled body's first kernel
cudaError_t launch_rstd(const void* x, float* rstd, int M, int K, float eps, cudaStream_t stream) {
  norm_rstd_kernel<<<(M + RSTD_ROWS - 1) / RSTD_ROWS, RSTD_ROWS * 32, 0, stream>>>(
      static_cast<const bf16*>(x), rstd, M, K, eps);
  return cudaGetLastError();
}

}  // namespace k2
}  // namespace pt

using namespace pt::mm;

// x (M, K) bf16, nw (K,) bf16, w (K, N) bf16 row-major, y (M, N) bf16;
// rstd: M f32 of scratch when M > 16 (unused, may be null, when M <= 16).
// Requires K % 128 == 0, N % 8 == 0 and 16-byte-aligned x and w (checked by
// the Python wrapper).
PT_EXPORT int pt_norm_matmul(const void* x, const void* nw, const void* w, void* rstd, void* y,
                             int M, int K, int N, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 16) return pt::sk::launch<true, kBf16, kTile>(x, nw, w, nullptr, y, M, K, N, 0, eps, s);
  auto rp = static_cast<float*>(rstd);
  const cudaError_t err = pt::k2::launch_rstd(x, rp, M, K, eps, s);
  if (err != cudaSuccess) return err;
  return pt::wq::launch<true, kBf16, kTile>(x, nw, rp, w, nullptr, y, M, K, N, 0, s);
}

// The same with a weight-only quantized W: codes int8 (K, N) (wt = 1) or
// packed int4 (K/2, N) (wt = 2); scales f32 (N,) (group_size -1) or
// (K/group_size, N); rstd as above. Requires K % 128 == 0,
// K % group_size == 0, N % 16 == 0.
PT_EXPORT int pt_norm_matmul_quant(const void* x, const void* nw, const void* codes,
                                   const void* scales, void* rstd, void* y, int M, int K, int N,
                                   int wt, int group_size, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int gs = group_size > 0 ? group_size : 0;
  if (wt != kInt8 && wt != kInt4) return cudaErrorInvalidValue;
  if (M <= 16)
    return wt == kInt8
               ? pt::sk::launch<true, kInt8, kTile>(x, nw, codes, scales, y, M, K, N, gs, eps, s)
               : pt::sk::launch<true, kInt4, kTile>(x, nw, codes, scales, y, M, K, N, gs, eps, s);
  auto rp = static_cast<float*>(rstd);
  const cudaError_t err = pt::k2::launch_rstd(x, rp, M, K, eps, s);
  if (err != cudaSuccess) return err;
  return wt == kInt8
             ? pt::wq::launch<true, kInt8, kTile>(x, nw, rp, codes, scales, y, M, K, N, gs, s)
             : pt::wq::launch<true, kInt4, kTile>(x, nw, rp, codes, scales, y, M, K, N, gs, s);
}
