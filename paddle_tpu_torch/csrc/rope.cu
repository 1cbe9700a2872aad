// K12 rope: rotate-half rotary position embedding over (B, S, H, D) rows.
//
// Replaces paddle_tpu/ops/pallas/fused_norm_rope.py:_pallas_rope
// (_rope_kernel): out = x * cos + concat(-x2, x1) * sin in f32, cast back
// to x's dtype, with the (S, D) f32 tables of the row's position. Its VJP
// (_rope_bwd) is the same kernel on the gradient with
// sin' = -swap_halves(sin), which the wrapper builds; that is exact for any
// table, not only half-duplicated ones.
//
// Each thread owns one (row, c) pair of columns c and c + D/2 for c < D/2,
// the two outputs that read the same two inputs:
//   out[c]       = x[c] * cos[c] + (-x[c + D/2]) * sin[c]
//   out[c + D/2] = x[c + D/2] * cos[c + D/2] + x[c] * sin[c + D/2]
// Each product and the sum are separately rounded f32 ops (no fused
// multiply-add), as the plain version's, so the two agree bit for bit.
// Any even D works; neighbouring threads read neighbouring columns.
//
// Bound on an H100: bytes (x read and out written once, the tables once
// per position from L2), ~0.04 ms for a (4, 2048, 32, 128) bf16 q.
#include "common.cuh"

namespace pt {
namespace k12 {

constexpr int NT = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, bf16* dst) { *dst = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(NT)
rope_kernel(const T* __restrict__ x, const float* __restrict__ cos_t,
            const float* __restrict__ sin_t,
            T* __restrict__ out, long long rows, int S, int H, int D) {
  const int half = D / 2;
  const long long n = rows * half;
  for (long long i = blockIdx.x * (long long)NT + threadIdx.x; i < n;
       i += (long long)gridDim.x * NT) {
    const long long row = i / half;
    const int c = static_cast<int>(i % half);
    const int s = static_cast<int>((row / H) % S);
    const T* xr = x + row * D;
    const float* cr = cos_t + (size_t)s * D;
    const float* sr = sin_t + (size_t)s * D;
    const float x1 = to_f32(xr[c]), x2 = to_f32(xr[c + half]);
    const float lo = __fadd_rn(__fmul_rn(x1, cr[c]), __fmul_rn(-x2, sr[c]));
    const float hi = __fadd_rn(__fmul_rn(x2, cr[c + half]), __fmul_rn(x1, sr[c + half]));
    from_f32(lo, out + row * D + c);
    from_f32(hi, out + row * D + c + half);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* cos_t, const void* sin_t, void* out, int B, int S,
                   int H, int D, cudaStream_t stream) {
  const long long rows = (long long)B * S * H;
  const long long n = rows * (D / 2);
  if (n == 0) return cudaSuccess;
  const long long blocks = (n + NT - 1) / NT;
  const int grid = static_cast<int>(blocks < 132LL * 16 ? blocks : 132LL * 16);
  rope_kernel<T><<<grid, NT, 0, stream>>>(static_cast<const T*>(x),
                                          static_cast<const float*>(cos_t),
                                          static_cast<const float*>(sin_t), static_cast<T*>(out),
                                          rows, S, H, D);
  return cudaGetLastError();
}

}  // namespace k12
}  // namespace pt

// x (B, S, H, D) contiguous, bf16 (is_bf16 = 1) or f32, D even; cos/sin
// (S, D) f32 contiguous -> out like x.
PT_EXPORT int pt_rope(const void* x, const void* cos_t, const void* sin_t, void* out, int B,
                      int S, int H, int D, int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? pt::k12::launch<pt::bf16>(x, cos_t, sin_t, out, B, S, H, D, s)
                 : pt::k12::launch<float>(x, cos_t, sin_t, out, B, S, H, D, s);
}
