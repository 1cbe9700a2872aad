// The small-M body shared by K2 (norm_matmul.cu) and K4 (quant_matmul.cu),
// and the helpers of every K2/K4 body:
//
//   y = A @ B,  A = rms_norm(x) (NORM, K2) or x (K4),  B = W (K, N)
//
// W is dense bf16 or weight-only int8 / nibble-packed int4 codes with f32
// scales, per output channel (gs = 0) or per K-group of gs rows. Its tile
// reaches shared memory as bf16 in one of two ways:
//   K2 (kTile) dequantizes it there as _fnm_kernel does:
//      bf16(code) * bf16(scale), rounded to bf16 (the exact f32 product of
//      two bf16 values, then one rounding), then the bf16 MMA;
//   K4 (kEnd, kGroup) keeps the raw codes, exact in bf16, so each MMA
//      product x * code is exact in f32 (the TPU's _qmm_kernel); the scale
//      multiplies the f32 sum once at the end per channel (kEnd), each
//      K-group's partial sum group-wise (kGroup).
// One 16-byte global vector holds 8 bf16 columns of one K row, 16 int8
// columns of one row, or 16 int4 columns of two rows (packed byte i: row
// 2i in the low nibble, row 2i+1 in the high one, sign-extended).
//
// matmul_small_kernel (M <= 16, decode): one 16x32 output tile per block;
// the 4 warps split K with no block barrier in the K loop, each keeping its
// next W slices in flight in registers during its MMAs (4 KB dense, 8 KB
// of codes quantized); partials meet in shared memory in a fixed order
// (deterministic). Bound by the bytes of W. Larger M runs
// wgmma_quant_tiles.cuh's body (K2, dense or quantized W, and K4).
#pragma once

#include <mma.h>

#include "common.cuh"

namespace pt {
namespace mm {
namespace {  // each including source gets its own copy

using namespace nvcuda;

enum WType { kBf16 = 0, kInt8 = 1, kInt4 = 2 };

// where a quantized W's scales apply
enum ScaleMode {
  kTile = 0,   // K2: dequantized into the bf16 B tile (dense W: no scales)
  kEnd = 1,    // K4 per channel: the f32 sum times its column's scale, once
  kGroup = 2,  // K4 group-wise: each K-group's partial sum times its scales
};

// geometry of one 16-byte global vector of W
template <int WT>
struct WVec {
  static constexpr int kCols = WT == kBf16 ? 8 : 16;   // columns it covers
  static constexpr int kRows = WT == kInt4 ? 2 : 1;    // K rows it covers
  static constexpr int kColBytes = WT == kBf16 ? 2 : 1;
};

// rstd of rows [m0, m0 + rows) into rstd[]: warp w takes rows w, w+nwarps..
__device__ __forceinline__ void rows_rstd(const bf16* __restrict__ x, float* rstd, int m0,
                                          int rows, int M, int K, float eps, int nwarps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += nwarps) {
    const int row = m0 + r;
    float s = 0.f;
    if (row < M) {
      const bf16* xr = x + (size_t)row * K;
#pragma unroll 4
      for (int k = lane * 8; k < K; k += 256) {
        float f[8];
        unpack8(*reinterpret_cast<const uint4*>(xr + k), f);
#pragma unroll
        for (int j = 0; j < 8; ++j) s += f[j] * f[j];
      }
    }
    s = warp_sum(s);
    if (lane == 0) rstd[r] = row < M ? 1.f / sqrtf(s / (float)K + eps) : 0.f;
  }
}

// 8 A values of row `row` at column k (zeros past M): with NORM,
// bf16(x * rstd) * w_norm rounded to bf16 (_pure_rms's op order), else x.
template <bool NORM>
__device__ __forceinline__ uint4 a8(const bf16* __restrict__ x, const bf16* __restrict__ nw,
                                    int row, int M, int K, int k, float rs) {
  if (row >= M) return make_uint4(0u, 0u, 0u, 0u);
  const uint4 xv = *reinterpret_cast<const uint4*>(x + (size_t)row * K + k);
  if (!NORM) return xv;
  float xf[8], wf[8], o[8];
  unpack8(xv, xf);
  unpack8(*reinterpret_cast<const uint4*>(nw + k), wf);
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = __bfloat162float(__float2bfloat16(xf[j] * rs)) * wf[j];
  return pack8(o);
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

// the 16-byte vector of W at packed row `prow` of the K slice starting at
// k0 and column n (zeros past N)
template <int WT>
__device__ __forceinline__ uint4 load_w(const unsigned char* __restrict__ w, int k0, int prow,
                                        int n, int N) {
  using V = WVec<WT>;
  if (n >= N) return make_uint4(0u, 0u, 0u, 0u);
  return *reinterpret_cast<const uint4*>(
      w + ((size_t)(k0 / V::kRows + prow) * N + n) * V::kColBytes);
}

// the scales of columns [n, n + 16) in scale row srow, rounded to bf16 as
// the dequant rule reads them (zeros past N)
__device__ __forceinline__ void scales16(const float* __restrict__ scales, int srow, int n,
                                         int N, float* s) {
  if (n >= N) {
#pragma unroll
    for (int j = 0; j < 16; ++j) s[j] = 0.f;
    return;
  }
  const float4* p = reinterpret_cast<const float4*>(scales + (size_t)srow * N + n);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 f = p[q];
    s[4 * q] = __bfloat162float(__float2bfloat16(f.x));
    s[4 * q + 1] = __bfloat162float(__float2bfloat16(f.y));
    s[4 * q + 2] = __bfloat162float(__float2bfloat16(f.z));
    s[4 * q + 3] = __bfloat162float(__float2bfloat16(f.w));
  }
}

// one W vector into the bf16 B tile at (packed row prow, column c); with
// SCALE (K2, quantized W) each code is multiplied by its column's scale
// s[j] (already bf16) — exact in f32 — and pack8 rounds once to bf16
template <int WT, bool SCALE>
__device__ __forceinline__ void put_w(bf16* Bs, int ldb, int prow, int c, const uint4& v,
                                      const float* s) {
  using V = WVec<WT>;
  if constexpr (WT == kBf16) {
    *reinterpret_cast<uint4*>(Bs + prow * ldb + c) = v;
  } else {
    const signed char* b = reinterpret_cast<const signed char*>(&v);
    float lo[16], hi[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int q = b[j];
      if (WT == kInt8) {
        lo[j] = (float)q;
      } else {
        lo[j] = (float)(((q & 0xF) ^ 8) - 8);  // row 2i: sign-extended low nibble
        hi[j] = (float)(q >> 4);               // row 2i+1: arithmetic shift
      }
      if (SCALE) {
        lo[j] *= s[j];
        if (WT == kInt4) hi[j] *= s[j];
      }
    }
    bf16* dst = Bs + prow * V::kRows * ldb + c;
    *reinterpret_cast<uint4*>(dst) = pack8(lo);
    *reinterpret_cast<uint4*>(dst + 8) = pack8(lo + 8);
    if (WT == kInt4) {
      *reinterpret_cast<uint4*>(dst + ldb) = pack8(hi);
      *reinterpret_cast<uint4*>(dst + ldb + 8) = pack8(hi + 8);
    }
  }
}

// ---- small M (decode): one 16x32 tile per block, K split over 4 warps
namespace small {
constexpr int BM = 16, BN = 32, BK = 64, NWARPS = 4, NT = NWARPS * 32;
constexpr int STRIDE = NWARPS * BK;  // K distance between one warp's slices
constexpr int LDA = BK + 8;  // bf16
constexpr int LDB = BN + 8;  // bf16
constexpr int LDC = BN + 4;  // f32
constexpr int A_BYTES = BM * LDA * 2;
constexpr int WARP_BYTES = A_BYTES + BK * LDB * 2;
static_assert(NWARPS * BM * LDC * 4 <= NWARPS * WARP_BYTES, "epilogue reuse");
static_assert(BM * LDC * 4 <= A_BYTES, "a warp's scale flush fits its A tile");
}  // namespace small

template <bool NORM, int WT, int SM>
__global__ void __launch_bounds__(small::NT)
matmul_small_kernel(const bf16* __restrict__ x, const bf16* __restrict__ nw,
                    const unsigned char* __restrict__ w, const float* __restrict__ scales,
                    bf16* __restrict__ y, int M, int K, int N, int gs, float eps) {
  using namespace small;
  using V = WVec<WT>;
  constexpr int PER_ROW = BN / V::kCols;                 // vectors per packed tile row
  constexpr int B_VECS = (BK / V::kRows) * PER_ROW / 32;  // per lane per slice
  // W slices a warp keeps in flight in registers: one for dense W (4 KB),
  // 8 KB of codes for quantized W (4 int8 slices, 8 int4 slices)
  constexpr int DEPTH = WT == kBf16 ? 1 : 16 / B_VECS;
  constexpr bool TILE_SCALE = WT != kBf16 && SM == kTile;
  static_assert(32 % PER_ROW == 0, "a lane's W columns are the same in every slice");
  __shared__ __align__(128) unsigned char smem[NWARPS * WARP_BYTES];
  __shared__ float rstd[BM];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * BN;
  const int c_lane = (lane % PER_ROW) * V::kCols;  // this lane's W columns
  bf16* As = reinterpret_cast<bf16*>(smem + warp * WARP_BYTES);
  bf16* Bs = reinterpret_cast<bf16*>(smem + warp * WARP_BYTES + A_BYTES);
  float* Cw = reinterpret_cast<float*>(smem + warp * WARP_BYTES);  // group flush

  if (NORM) rows_rstd(x, rstd, 0, BM, M, K, eps, NWARPS);
  __syncthreads();

  float sreg[16];  // TILE_SCALE: this lane's column scales (per channel: once)
  if (TILE_SCALE && !gs) scales16(scales, 0, n0 + c_lane, N, sreg);

  uint4 breg[DEPTH][B_VECS];
  auto load_b = [&](uint4(&r)[B_VECS], int k0) {
#pragma unroll
    for (int t = 0; t < B_VECS; ++t)
      r[t] = load_w<WT>(w, k0, (lane + t * 32) / PER_ROW, n0 + c_lane, N);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
  float tot[BM];  // kGroup: scaled sums of this lane's column n0 + lane
#pragma unroll
  for (int r = 0; r < BM; ++r) tot[r] = 0.f;

  // kGroup: acc * scale[srow][n0 + lane] into tot, acc back to 0
  auto flush = [&](int srow) {
    __syncwarp();
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      wmma::store_matrix_sync(Cw + j * 16, acc[j], LDC, wmma::mem_row_major);
      wmma::fill_fragment(acc[j], 0.f);
    }
    __syncwarp();
    const float s = n0 + lane < N ? scales[(size_t)srow * N + n0 + lane] : 0.f;
#pragma unroll
    for (int r = 0; r < BM; ++r) tot[r] += Cw[r * LDC + lane] * s;
    __syncwarp();
  };

#pragma unroll
  for (int d = 0; d < DEPTH; ++d)
    if (warp * BK + d * STRIDE < K) load_b(breg[d], warp * BK + d * STRIDE);
  for (int kb = warp * BK; kb < K; kb += DEPTH * STRIDE) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int k0 = kb + d * STRIDE;
      if (k0 < K) {  // warp-uniform
        for (int i = lane; i < BM * (BK / 8); i += 32) {
          const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
          *reinterpret_cast<uint4*>(As + r * LDA + c) =
              a8<NORM>(x, nw, r, M, K, k0 + c, NORM ? rstd[r] : 0.f);
        }
        if (TILE_SCALE && gs) scales16(scales, k0 / gs, n0 + c_lane, N, sreg);
#pragma unroll
        for (int t = 0; t < B_VECS; ++t)
          put_w<WT, TILE_SCALE>(Bs, LDB, (lane + t * 32) / PER_ROW, c_lane, breg[d][t], sreg);
        __syncwarp();
        // the slice DEPTH ahead is in flight during these MMAs
        if (k0 + DEPTH * STRIDE < K) load_b(breg[d], k0 + DEPTH * STRIDE);
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, As + kk, LDA);
#pragma unroll
          for (int j = 0; j < BN / 16; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
            wmma::load_matrix_sync(b, Bs + kk * LDB + j * 16, LDB);
            wmma::mma_sync(acc[j], a, b, acc[j]);
          }
        }
        __syncwarp();
        // group-wise: a warp's slices (STRIDE >= gs apart) each lie in a group
        // of their own, so every slice ends one
        if (SM == kGroup) flush(k0 / gs);
      }
    }
  }

  __syncthreads();  // every warp is done with its A/B slices
  float* Cs = reinterpret_cast<float*>(smem);
  if constexpr (SM == kGroup) {
#pragma unroll
    for (int r = 0; r < BM; ++r) Cs[warp * BM * LDC + r * LDC + lane] = tot[r];
  } else {
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
      wmma::store_matrix_sync(Cs + warp * BM * LDC + j * 16, acc[j], LDC, wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = tid; i < BM * (BN / 8); i += NT) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    if (r < M && n0 + c < N) {
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < NWARPS; ++q) s += Cs[q * BM * LDC + r * LDC + c + e];
        // kEnd: the per-channel scale multiplies the f32 sum once
        f[e] = SM == kEnd ? s * scales[n0 + c + e] : s;
      }
      *reinterpret_cast<uint4*>(y + (size_t)r * N + n0 + c) = pack8(f);
    }
  }
}

// y (M, N) bf16 = A @ W for M <= 16. Requires K % 128 == 0 (and % gs),
// N % 8 (bf16) or % 16.
template <bool NORM, int WT, int SM>
cudaError_t launch_small(const void* x, const void* nw, const void* w, const void* scales,
                         void* y, int M, int K, int N, int gs, float eps, cudaStream_t stream) {
  matmul_small_kernel<NORM, WT, SM><<<(N + small::BN - 1) / small::BN, small::NT, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(nw),
      static_cast<const unsigned char*>(w), static_cast<const float*>(scales),
      static_cast<bf16*>(y), M, K, N, gs, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mm
}  // namespace pt
