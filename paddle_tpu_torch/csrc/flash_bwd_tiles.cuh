// The pieces shared by the two flash backward kernels, K5 (split: dq and
// dkv kernels, flash_attention_bwd.cu) and K9 (one pass,
// flash_attention_bwd_fused.cu): 64-row tiles of Q, K, V and dO in shared
// memory, nvcuda::wmma bf16 products with f32 accumulation, and the
// per-tile P = exp(S * scale + bias - lse), dS = P * (dP - delta) rule.
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
#pragma once

#include <mma.h>

#include "common.cuh"

namespace pt {
namespace fb {
namespace {  // each including source gets its own copy

using namespace nvcuda;

constexpr int D = 128;
constexpr int BT = 64;  // rows of every tile (queries or keys)
constexpr int NWARPS = BT / 16;
constexpr int NT = NWARPS * 32;
constexpr int LDQ = D + 8;    // bf16 row tiles
constexpr int LDS = BT + 4;   // f32 score tiles
constexpr int LDP = BT + 8;   // bf16 P / dS tiles
constexpr int LDO = D + 4;    // f32 accumulators
constexpr int TILE = BT * LDQ * 2;
constexpr int SF = BT * LDS * 4;
constexpr int PB = BT * LDP * 2;
constexpr int ACC = BT * LDO * 4;
constexpr int STATS = 3 * BT * 4;  // lse, delta (query rows), bias (keys)
// K, V, Q, dO tiles; S and dP; P and dS; the dK and dV accumulators; stats
constexpr int KV_SMEM = 4 * TILE + 2 * SF + 2 * PB + 2 * ACC + STATS;

// rows [row0, row0 + 64) of a (B, S, heads, D) tensor at (b, head) -> smem
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int b, int head, int row0,
                                          int S, int heads) {
  for (int i = threadIdx.x; i < BT * (D / 8); i += NT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int s = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (s < S) v = *reinterpret_cast<const uint4*>(src + (((size_t)b * S + s) * heads + head) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LDQ + c) = v;
  }
}

// lse and delta of rows [row0, row0 + 64) at (b, h): (B, H, S) f32
__device__ __forceinline__ void load_stats(float* lse_s, float* dl_s, const float* lse,
                                           const float* delta, int b, int h, int H, int row0,
                                           int S) {
  for (int i = threadIdx.x; i < BT; i += NT) {
    const int s = row0 + i;
    const size_t off = ((size_t)b * H + h) * S + s;
    lse_s[i] = s < S ? lse[off] : 0.f;
    dl_s[i] = s < S ? delta[off] : 0.f;
  }
}

// the key bias of keys [k0, k0 + 64) of batch row b: (B, Sk) f32, or 0
// everywhere when there is no mask (bias == nullptr)
__device__ __forceinline__ void load_bias(float* bias_s, const float* bias, int b, int k0,
                                          int Sk) {
  for (int i = threadIdx.x; i < BT; i += NT) {
    const int kpos = k0 + i;
    bias_s[i] = (bias != nullptr && kpos < Sk) ? bias[(size_t)b * Sk + kpos] : 0.f;
  }
}

// dst (16 x 64, f32) = A (16 x 128 rows, bf16) . Bk^T, Bk = 64 rows x 128
__device__ __forceinline__ void warp_abt(const bf16* A, const bf16* Bk, float* dst) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> s[BT / 16];
#pragma unroll
  for (int j = 0; j < BT / 16; ++j) wmma::fill_fragment(s[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + kk, LDQ);
#pragma unroll
    for (int j = 0; j < BT / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, Bk + j * 16 * LDQ + kk, LDQ);
      wmma::mma_sync(s[j], a, b, s[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BT / 16; ++j)
    wmma::store_matrix_sync(dst + j * 16, s[j], LDS, wmma::mem_row_major);
}

// acc rows [16 w, 16 w + 16) (f32, 64 x 128) += T^T . M: T (64 q x 64 k,
// bf16, ld LDP) read transposed, M (64 q x 128, bf16 rows)
__device__ __forceinline__ void warp_acc_atb(const bf16* T, const bf16* M, float* acc, int w) {
#pragma unroll 1
  for (int j = 0; j < D / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
    wmma::load_matrix_sync(o, acc + w * 16 * LDO + j * 16, LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BT; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, T + kk * LDP + w * 16, LDP);
      wmma::load_matrix_sync(b, M + kk * LDQ + j * 16, LDQ);
      wmma::mma_sync(o, a, b, o);
    }
    wmma::store_matrix_sync(acc + w * 16 * LDO + j * 16, o, LDO, wmma::mem_row_major);
  }
}

// the warp's 16 query rows of one (query tile, key tile) pair: P and dS
// from the score and dP tiles. Lane pair (2r, 2r+1) owns row r, 32 columns
// each. Pb may be null (the dq kernel needs dS only).
__device__ __forceinline__ void p_and_ds(const float* Sf, const float* dPf, bf16* Pb, bf16* dSb,
                                         const float* lse_s, const float* dl_s,
                                         const float* bias_s, bool has_bias, int q0, int k0,
                                         int Sq, int Sk, int offset, int causal, float scale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp * 16 + lane / 2, half = lane % 2;
  const int q_row = q0 + r;
  const int q_pos = q_row + offset;
  const float lse_r = lse_s[r], dl_r = dl_s[r];
  // a row that sees no key (lse -1e30) takes no term
  const bool row_live = q_row < Sq && lse_r > 0.5f * kNegInf;
#pragma unroll 8
  for (int c = 0; c < 32; ++c) {
    const int col = half * 32 + c;
    const int kpos = k0 + col;
    const bool live = row_live && kpos < Sk && !(causal && kpos > q_pos);
    float p = 0.f;
    if (live) {
      // with a bias, s * scale and + bias each rounded (no fused
      // multiply-add), as the TPU kernels' separate ops
      p = has_bias ? expf(__fadd_rn(Sf[r * LDS + col] * scale, bias_s[col]) - lse_r)
                   : expf(Sf[r * LDS + col] * scale - lse_r);
    }
    const float ds = p * (dPf[r * LDS + col] - dl_r);
    if (Pb != nullptr) Pb[r * LDP + col] = __float2bfloat16(p);
    dSb[r * LDP + col] = __float2bfloat16(ds);
  }
}

// rows [row0, row0 + 64) of acc * factor -> bf16 (B, S, heads, D) at (b, head)
__device__ __forceinline__ void store_rows(bf16* dst, const float* acc, float factor, int b,
                                           int head, int row0, int S, int heads) {
  for (int i = threadIdx.x; i < BT * (D / 8); i += NT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int s = row0 + r;
    if (s >= S) continue;
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = acc[r * LDO + c + j] * factor;
    *reinterpret_cast<uint4*>(dst + (((size_t)b * S + s) * heads + head) * D + c) = pt::pack8(f);
  }
}

__device__ __forceinline__ void zero_acc(float* acc) {
  for (int i = threadIdx.x; i < BT * LDO; i += NT) acc[i] = 0.f;
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

}  // namespace
}  // namespace fb
}  // namespace pt
