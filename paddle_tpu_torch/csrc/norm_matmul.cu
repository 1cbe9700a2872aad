// K2 norm_matmul: y = ((x32 * rsqrt(mean(x32^2) + eps)).to(bf16) * w_norm) @ W
//
// Replaces paddle_tpu/ops/pallas/fused_norm_matmul.py:_pallas_fnm (resident,
// M <= 1024) and :_pallas_fnm_streamed (M > 1024) with ONE entry point that
// takes any M: a block owns an output tile, computes its rows' rstd once (a
// full-K pass over x, which stays in L2), then walks K in slices,
// normalizing each x slice into shared memory as it lands and feeding bf16
// tensor-core tiles (nvcuda::wmma, f32 accumulate) from there. The
// normalized activations never touch device memory — the point of the TPU
// fusion. W is dense bf16 or weight-only int8 / packed int4 with per-channel
// or group-wise scales, dequantized into the bf16 B tile as _fnm_kernel
// does (bf16(code) * bf16(scale), rounded to bf16). The bodies live in
// matmul_tiles.cuh, shared with K4.
//
// Numerics follow _pure_rms / _fnm_kernel: f32 statistics, cast back to
// bf16 BEFORE the norm-weight multiply, that multiply rounded to bf16, then
// a dot with f32 accumulation and one bf16 rounding of the output.
//
// Bound on an H100: at decode (M = batch <= 16) the kernel is bound by the
// bytes of W (2*K*N dense, K*N int8, K*N/2 int4). The small-M kernel
// therefore keeps W loads in flight: 16x32 output tiles spread W over >= 128
// blocks at N = 4096, the block's 4 warps split K among themselves with no
// block barrier in the K loop, and each warp prefetches its next W slice
// into registers while its tensor cores work on the current one. At
// prefill (M = 1024) the kernel is bound by tensor-core operations; 64x128
// tiles keep 8 accumulator fragments per warp.
#include "matmul_tiles.cuh"

using namespace pt::mm;

// x (M, K) bf16, nw (K,) bf16, w (K, N) bf16 row-major, y (M, N) bf16.
// Requires K % 128 == 0 and N % 8 == 0 (checked by the Python wrapper).
PT_EXPORT int pt_norm_matmul(const void* x, const void* nw, const void* w, void* y, int M,
                             int K, int N, float eps, void* stream) {
  return launch<true, kBf16, kTile>(x, nw, w, nullptr, y, M, K, N, 0, eps,
                                    static_cast<cudaStream_t>(stream));
}

// The same with a weight-only quantized W: codes int8 (K, N) (wt = 1) or
// packed int4 (K/2, N) (wt = 2); scales f32 (N,) (group_size -1) or
// (K/group_size, N). Requires K % 128 == 0, K % group_size == 0, N % 16 == 0.
PT_EXPORT int pt_norm_matmul_quant(const void* x, const void* nw, const void* codes,
                                   const void* scales, void* y, int M, int K, int N, int wt,
                                   int group_size, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int gs = group_size > 0 ? group_size : 0;
  if (wt == kInt8)
    return launch<true, kInt8, kTile>(x, nw, codes, scales, y, M, K, N, gs, eps, s);
  if (wt == kInt4)
    return launch<true, kInt4, kTile>(x, nw, codes, scales, y, M, K, N, gs, eps, s);
  return cudaErrorInvalidValue;
}
