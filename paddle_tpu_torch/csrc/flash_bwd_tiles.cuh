// The pieces shared by the two flash backward kernels, K5 (split: dq and
// dkv kernels, flash_attention_bwd.cu) and K9 (one pass,
// flash_attention_bwd_fused.cu), whose tiles, swizzle, staging and
// key-tile liveness K1 (flash_attention.cu) uses too: 64-row tiles of Q,
// K, V and dO staged by cp.async, the bf16 ldmatrix + mma.sync.m16n8k16
// products with f32
// accumulators in registers, the per-tile P = exp(S * scale + bias - lse),
// dS = P * (dP - delta) rule applied to the score fragments in registers,
// the causal tile liveness and the key-tile liveness under a key bias.
//
// Numerics follow the TPU kernels (paddle_tpu/ops/pallas/flash_attention.py
// _dq_kernel, _dkv_kernel, _bwd_fused_kernel): the logit is S * scale
// rounded, plus the key bias (0 without a mask) rounded, minus lse; P is
// cast to dO's dtype before dV += P^T dO and dS to Q's/K's dtype before the
// dK and dQ products. A masked-out position (past the causal diagonal or
// past Sk) gives P = 0 exactly, as exp(-1e30 - lse) does.
//
// A query row that sees no key (a left-pad query under a key-padding mask)
// has lse = -1e30 from K1. exp(S + bias - lse) would give each of its
// masked keys P = exp(0) = 1, as the TPU kernels do, which is no gradient
// of any forward: wherever such a row's dO is not 0 (its position has a
// label, or an MoE aux loss reads it) dK and dV would take wrong terms. So
// these kernels give such rows P = 0 (no dQ, dK or dV term), and the
// wrapper adds their share of the JAX package's reference lowering: P =
// 1/Sk on every key for dV, no dQ or dK (the logits are constants there).
//
// A key tile whose biases are all <= -1e30 for batch row b (tile_live[b,
// tile] == 0, computed by the wrapper on the device) gives P = 0 and dS = 0
// on every row: exp(-1e30 + s - lse) is 0 in f32 for every finite s and
// live lse. The kernels skip it, which changes no bit: its dK/dV are the
// zeros it would sum, and its dQ terms are zeros.
//
// Block shape: 8 warps (256 threads). The score products (S = A B^T over
// D = 128, 64 x 64) give each warp a 16-row x 32-column fragment (warp w:
// rows 16 (w % 4), columns 32 (w / 4)); the accumulating products (64 x
// 128 outputs over 64-deep P, dS tiles) give each warp 32 x 32 (rows
// 32 (w / 4), columns 32 (w % 4)): 32 f32 registers a thread for each
// 64 x 128 accumulator. Tiles in shared memory are unpadded, their
// 16-byte chunks XOR-swizzled by row (sw): the 8 rows of every ldmatrix
// phase and of each bf16x2 fragment store fall on distinct banks, and a
// dkv or K9 block fits 113 KB, so two blocks (16 warps) share an SM.
#pragma once

#include "mma_sync.cuh"

namespace pt {
namespace fb {
namespace {  // each including source gets its own copy

constexpr int D = 128;
constexpr int BT = 64;  // rows of every tile (queries or keys)
constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;
constexpr int TILE = BT * D * 2;    // a bf16 row tile, [64][128]
constexpr int PTILE = BT * BT * 2;  // a bf16 P or dS tile, [64][64]
constexpr int VEC = BT * 4;  // 64 f32: lse, delta or bias of a tile

// the element offset of (row, col) in a [rows][COLS] bf16 tile whose
// 16-byte chunks are XOR-swizzled by row % 8: the 8 rows that one
// ldmatrix phase or one fragment store touches land on distinct banks,
// with no padding
template <int COLS>
__device__ __forceinline__ int sw(int row, int col) {
  return row * COLS + ((((col >> 3) ^ row) & 7) | ((col >> 3) & ~7)) * 8 + (col & 7);
}

// a warp's score fragment: 4 8-column mma tiles of its 16 x 32
typedef float Score[4][4];
// a warp's 32 x 32 share of a 64 x 128 f32 accumulator
typedef float Acc[2][4][4];

// cp.async rows [row0, row0 + 64) of a (B, S, heads, D) bf16 tensor at
// (b, head) into a [64][D] tile; rows past S are zeros
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int b, int head,
                                           int row0, int S, int heads) {
  for (int i = threadIdx.x; i < BT * (D / 8); i += NT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int s = row0 + r;
    const bool ok = s < S;
    cp_async16(dst + sw<D>(r, c), ok ? src + (((size_t)b * S + s) * heads + head) * D + c : src,
               ok);
  }
}

// cp.async 64 f32 from src[i0 .. i0 + 64) (n valid, zeros past it) into dst;
// all zeros when src is null (no key bias)
__device__ __forceinline__ void stage_vec(float* dst, const float* src, size_t i0, size_t n) {
  for (int i = threadIdx.x; i < BT; i += NT) {
    if (src == nullptr) {
      dst[i] = 0.f;
    } else {
      const bool ok = i0 + i < n;
      cp_async4(dst + i, ok ? src + i0 + i : src, ok);
    }
  }
}

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// s = this warp's 16 x 32 fragment of A . B^T over D: A a [64][D] tile
// of query rows, B a [64][D] tile of key rows
__device__ __forceinline__ void score(const bf16* A, const bf16* B, Score& s) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  const int ar = 16 * (w % 4) + lane % 16;
  const int br = 32 * (w / 4) + lane % 8 + (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    unsigned a[4];
    ldsm4(a, A + sw<D>(ar, kk + (lane / 16) * 8));
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      unsigned r[4];
      ldsm4(r, B + sw<D>(br + j * 8, kk + ((lane / 8) % 2) * 8));
      mma16816(s[j], a, r[0], r[1]);
      mma16816(s[j + 1], a, r[2], r[3]);
    }
  }
}

// acc += op(T) . M over the 64 rows of M: T a [64][64] P or dS tile, read
// transposed (TRANS_T: dV += P^T dO, dK += dS^T Q) or as it lies (dQ += dS
// K); M a [64][D] row tile
template <bool TRANS_T>
__device__ __forceinline__ void accumulate(const bf16* T, const bf16* M, Acc& acc) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = 32 * (w / 4), n0 = 32 * (w % 4);
#pragma unroll
  for (int kk = 0; kk < BT; kk += 16) {
    unsigned a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if constexpr (TRANS_T)
        ldsm4_t(a[i], T + sw<BT>(kk + lane % 8 + (lane / 16) * 8,
                                 m0 + 16 * i + ((lane / 8) % 2) * 8));
      else
        ldsm4(a[i], T + sw<BT>(m0 + 16 * i + lane % 16, kk + (lane / 16) * 8));
    }
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      unsigned r[4];
      ldsm4_t(r, M + sw<D>(kk + lane % 16, n0 + j * 8 + (lane / 16) * 8));
      b[j][0] = r[0];
      b[j][1] = r[1];
      b[j + 1][0] = r[2];
      b[j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma16816(acc[i][j], a[i], b[j][0], b[j][1]);
  }
}

// P and dS of one (query tile q0, key tile k0) pair from this warp's S and
// dP fragments, cast to bf16 into [64][64] tiles (Pb may be null: the dq
// direction needs dS only). lse_s, dl_s: the query tile's rows; bias_s:
// the key tile's 64 biases, in shared or global memory (read only where
// has_bias and the key is < Sk).
__device__ __forceinline__ void p_and_ds(const Score& s, const Score& dp, bf16* Pb, bf16* dSb,
                                         const float* lse_s, const float* dl_s,
                                         const float* bias_s, bool has_bias, int q0, int k0,
                                         int Sq, int Sk, int offset, int causal, float scale) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * (w % 4) + lane / 4 + 8 * h;
    const int q_row = q0 + r;
    const int q_pos = q_row + offset;
    const float lse_r = lse_s[r], dl_r = dl_s[r];
    // a row that sees no key (lse -1e30) takes no term
    const bool row_live = q_row < Sq && lse_r > 0.5f * kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 32 * (w / 4) + 8 * j + 2 * (lane % 4);
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + c + e;
        const bool live = row_live && kpos < Sk && !(causal && kpos > q_pos);
        const float sv = s[j][2 * h + e];
        p[e] = 0.f;
        if (live) {
          // with a bias, s * scale and + bias each rounded (no fused
          // multiply-add), as the TPU kernels' separate ops
          p[e] = has_bias ? expf(__fadd_rn(sv * scale, bias_s[c + e]) - lse_r)
                          : expf(sv * scale - lse_r);
        }
        ds[e] = p[e] * (dp[j][2 * h + e] - dl_r);
      }
      if (Pb != nullptr)
        *reinterpret_cast<__nv_bfloat162*>(Pb + sw<BT>(r, c)) = __floats2bfloat162_rn(p[0], p[1]);
      *reinterpret_cast<__nv_bfloat162*>(dSb + sw<BT>(r, c)) = __floats2bfloat162_rn(ds[0], ds[1]);
    }
  }
}

// the 4 warps that form and read one half of the P and dS columns (keys
// 32 (w / 4) ..) meet here: the score fragments of warps with the same
// w / 4 cover those columns for all 64 query rows, and the transposed
// products of the same warps read only them
__device__ __forceinline__ void sync_key_half() {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + threadIdx.x / 128));
}

// rows [row0, row0 + 64) of acc * factor -> bf16 (B, S, heads, D) at
// (b, head), straight from the registers
__device__ __forceinline__ void store_acc(bf16* dst, const Acc& acc, float factor, int b,
                                          int head, int row0, int S, int heads) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = row0 + 32 * (w / 4) + 16 * i + lane / 4 + 8 * h;
      if (s >= S) continue;
      bf16* row = dst + (((size_t)b * S + s) * heads + head) * D;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 32 * (w % 4) + 8 * j + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(row + c) =
            __floats2bfloat162_rn(acc[i][j][2 * h] * factor, acc[i][j][2 * h + 1] * factor);
      }
    }
}

// delta = rowsum(dO * O) in f32 for each of the `rows` (b, s, h) rows of
// out/dout (B, Sq, H, D), written (B, H, Sq): 16 threads a row, 8
// products each, then a shuffle sum; the first pass of K5 and of K9 (it
// replaces four elementwise and reduction passes over f32 copies)
__global__ void __launch_bounds__(256)
flash_delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                   float* __restrict__ delta, int rows, int Sq, int H) {
  const int r = blockIdx.x * 16 + threadIdx.x / 16, c = (threadIdx.x % 16) * 8;
  float acc = 0.f;
  if (r < rows) {
    float o[8], d[8];
    unpack8(*reinterpret_cast<const uint4*>(out + (size_t)r * D + c), o);
    unpack8(*reinterpret_cast<const uint4*>(dout + (size_t)r * D + c), d);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += d[j] * o[j];
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && threadIdx.x % 16 == 0) {
    const int h = r % H, s = (r / H) % Sq, b = r / (H * Sq);
    delta[((size_t)b * H + h) * Sq + s] = acc;
  }
}

// the number of key tiles query tile qt reads: all of them, or under the
// causal mask those up to its last row's diagonal (K1's liveness)
__device__ __forceinline__ int live_key_tiles(int qt, int Sq, int Sk, int causal) {
  const int nk = (Sk + BT - 1) / BT;
  if (!causal) return nk;
  const int last = min(qt * BT + BT - 1, Sq - 1) + (Sk - Sq);  // last visible key
  return last < 0 ? 0 : min(nk, last / BT + 1);
}

// the first query tile whose rows see key k0 under the causal mask
__device__ __forceinline__ int first_query_tile(int k0, int Sq, int Sk, int causal) {
  if (!causal) return 0;
  const int first = k0 - (Sk - Sq);
  return first <= 0 ? 0 : first / BT;
}

// whether key tile t of batch row b has a key the bias does not mask
// (tile_live: (B, nk) int32 from the wrapper, or null: every tile)
__device__ __forceinline__ bool tile_is_live(const int* tile_live, int b, int nk, int t) {
  return tile_live == nullptr || tile_live[(size_t)b * nk + t] != 0;
}

// the first key tile >= t of batch row b that is live, or n
__device__ __forceinline__ int next_live_tile(const int* tile_live, int b, int nk, int t, int n) {
  while (t < n && !tile_is_live(tile_live, b, nk, t)) ++t;
  return t;
}

}  // namespace
}  // namespace fb
}  // namespace pt
