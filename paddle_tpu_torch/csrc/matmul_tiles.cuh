// The helpers every K2 (norm_matmul.cu) and K4 (quant_matmul.cu) body
// shares:
//
//   y = A @ B,  A = rms_norm(x) (NORM, K2) or x (K4),  B = W (K, N)
//
// W is dense bf16 or weight-only int8 / nibble-packed int4 codes with f32
// scales, per output channel (gs = 0) or per K-group of gs rows. The scale
// mode says where a quantized W's scales apply:
//   K2 (kTile) dequantizes W as _fnm_kernel does: bf16(code) *
//      bf16(scale), rounded to bf16 (the exact f32 product of two bf16
//      values, then one rounding), then the bf16 MMA;
//   K4 (kEnd, kGroup) keeps the raw codes, exact in bf16, so each MMA
//      product x * code is exact in f32 (the TPU's _qmm_kernel); the scale
//      multiplies the f32 sum once at the end per channel (kEnd), each
//      K-group's partial sum group-wise (kGroup).
// The bodies: M <= 16 (decode) skinny_tiles.cuh, M > 16
// wgmma_quant_tiles.cuh. Both normalize with rows_rstd's rstd and norm8.
#pragma once

#include "common.cuh"

namespace pt {
namespace mm {
namespace {  // each including source gets its own copy

enum WType { kBf16 = 0, kInt8 = 1, kInt4 = 2 };

// where a quantized W's scales apply
enum ScaleMode {
  kTile = 0,   // K2: in the dequantized bf16 W tile (dense W: no scales)
  kEnd = 1,    // K4 per channel: the f32 sum times its column's scale, once
  kGroup = 2,  // K4 group-wise: each K-group's partial sum times its scales
};

// rstd of rows [m0, m0 + rows) into rstd[]: warp `warp` of `nwarps` takes
// rows warp, warp + nwarps, ... A row's sum runs in the same order whoever
// takes it (lane l adds the squares of columns 8 l + 256 i, i ascending, by
// fma, then a butterfly), so every caller gets the same bits for a row. A
// lane keeps up to 16 loads (a 4096-column chunk of the row) in flight.
__device__ __forceinline__ void rows_rstd(const bf16* __restrict__ x, float* rstd, int m0,
                                          int rows, int M, int K, float eps, int warp,
                                          int nwarps) {
  constexpr int CHUNK = 16;  // loads a lane keeps in flight
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += nwarps) {
    const int row = m0 + r;
    float s = 0.f;
    if (row < M) {
      const bf16* xr = x + (size_t)row * K;
      for (int k0 = lane * 8; k0 < K; k0 += CHUNK * 256) {
        uint4 v[CHUNK];
#pragma unroll
        for (int i = 0; i < CHUNK; ++i)
          if (k0 + 256 * i < K) v[i] = *reinterpret_cast<const uint4*>(xr + k0 + 256 * i);
#pragma unroll
        for (int i = 0; i < CHUNK; ++i)
          if (k0 + 256 * i < K) {
            float f[8];
            unpack8(v[i], f);
#pragma unroll
            for (int j = 0; j < 8; ++j) s = __fmaf_rn(f[j], f[j], s);
          }
      }
    }
    s = warp_sum(s);
    if (lane == 0) rstd[r] = row < M ? 1.f / sqrtf(s / (float)K + eps) : 0.f;
  }
}

// 8 normalized values: bf16(x * rs) * w_norm, rounded to bf16 (the exact
// product of two bf16 values rounded once, which __hmul2 computes)
__device__ __forceinline__ uint4 norm8(const uint4& xv, const uint4& wv, float rs) {
  const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&xv);
  const __nv_bfloat162* wh = reinterpret_cast<const __nv_bfloat162*>(&wv);
  uint4 o;
  __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(xh[j]);
    oh[j] = __hmul2(__floats2bfloat162_rn(f.x * rs, f.y * rs), wh[j]);
  }
  return o;
}

}  // namespace
}  // namespace mm
}  // namespace pt
