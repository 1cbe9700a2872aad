// K1 flash_attention_fwd: causal GQA online-softmax attention, out + lse,
// with an optional key bias.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:_pallas_fwd (_fwd_kernel).
// The TPU walks a sequential (bh, q_block, k_block) grid carrying m/l/acc in
// VMEM scratch; here one block owns (b*h, 64-row q tile) and a loop over
// 64-key tiles takes the place of the sequential grid dimension, stopping
// at the last causally live tile. Query head h reads KV head h / (H/Hk), so
// the repeated K/V are never materialized (the TPU's index-map gather).
//
// Numerics follow _fwd_kernel: Q.K^T in bf16 with f32 accumulation, times
// sm_scale, plus the (B, Sk) f32 key bias of a key-padding mask (b_ref at
// _fwd_kernel :125; a null pointer without a mask), each rounded; then
// causally masked logits set to -1e30; p = exp(s - m) in f32, summed in
// f32, and CAST TO V's DTYPE before P.V; out = acc / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)). A query that sees no key (every logit
// -1e30: a left-pad query under a key-padding mask, or a query before the
// first key when Sq > Sk) writes zeros and lse = -1e30; the wrapper then
// gives such rows the mean of V over all keys, the JAX package's reference
// lowering (a softmax over equal logits). The TPU kernel instead averages
// over its live tiles' keys, an answer that depends on its tile size.
//
// Bound on an H100: at prefill (S = 128..2048, D = 128) the work is
// tensor-core operations, ~4*S^2*D/2 per head causal. This first version
// keeps Q, K, V, S, P and the f32 accumulator in shared memory (110 KB per
// block) and uses nvcuda::wmma bf16 tiles; the accumulator is rescaled in
// shared memory per tile, which is simple but moves the O tile through
// shared memory twice per key tile (wgmma with a register accumulator is a
// later PR's work).
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using pt::bf16;

namespace {

constexpr int D = 128;
constexpr int BQ = 64;   // query rows per block (16 per warp)
constexpr int BKV = 64;  // keys per tile
constexpr int NWARPS = BQ / 16;
constexpr int NT = NWARPS * 32;
constexpr int LDQ = D + 8;     // bf16
constexpr int LDS = BKV + 4;   // f32
constexpr int LDP = BKV + 8;   // bf16
constexpr int LDO = D + 4;     // f32
constexpr int Q_BYTES = BQ * LDQ * 2;
constexpr int KV_BYTES = BKV * LDQ * 2;
constexpr int S_BYTES = BQ * LDS * 4;
constexpr int P_BYTES = BQ * LDP * 2;
constexpr int O_BYTES = BQ * LDO * 4;
constexpr int SMEM = Q_BYTES + 2 * KV_BYTES + S_BYTES + P_BYTES + O_BYTES;

// rows [row0, row0+nrows) of a (B, S, heads, D) tensor at (b, head) -> smem
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int b, int head, int row0,
                                          int S, int heads) {
  for (int i = threadIdx.x; i < BQ * (D / 8); i += NT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int s = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (s < S) v = *reinterpret_cast<const uint4*>(src + (((size_t)b * S + s) * heads + head) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LDQ + c) = v;
  }
}

__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 bf16* __restrict__ out, float* __restrict__ lse, int B, int Sq, int Sk, int H,
                 int Hk, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + Q_BYTES);
  bf16* Vs = reinterpret_cast<bf16*>(smem + Q_BYTES + KV_BYTES);
  float* Ss = reinterpret_cast<float*>(smem + Q_BYTES + 2 * KV_BYTES);
  bf16* Ps = reinterpret_cast<bf16*>(smem + Q_BYTES + 2 * KV_BYTES + S_BYTES);
  float* Os = reinterpret_cast<float*>(smem + Q_BYTES + 2 * KV_BYTES + S_BYTES + P_BYTES);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hk = h / (H / Hk);
  const int q0 = blockIdx.x * BQ;
  const int offset = Sk - Sq;

  float* Sw = Ss + warp * 16 * LDS;
  bf16* Pw = Ps + warp * 16 * LDP;
  float* Ow = Os + warp * 16 * LDO;
  // softmax ownership: lane pair (2r, 2r+1) holds row r of the warp's 16,
  // each lane half of its columns
  const int r = lane / 2, half = lane % 2;
  const int q_row = q0 + warp * 16 + r;
  const int q_pos = q_row + offset;

  load_rows(Qs, q, b, h, q0, Sq, H);
  for (int i = lane; i < 16 * D; i += 32) Ow[(i / D) * LDO + i % D] = 0.f;

  int n_tiles = (Sk + BKV - 1) / BKV;
  if (causal) {
    const int last = min(q0 + BQ - 1, Sq - 1) + offset;  // last visible key
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BKV + 1);
  }
  float m = pt::kNegInf, l = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // previous tile's K/V reads are done
    load_rows(Ks, k, b, hk, k0, Sk, Hk);
    load_rows(Vs, v, b, hk, k0, Sk, Hk);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s[BKV / 16];
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) wmma::fill_fragment(s[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + warp * 16 * LDQ + kk, LDQ);
#pragma unroll
        for (int j = 0; j < BKV / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
          wmma::load_matrix_sync(kb, Ks + j * 16 * LDQ + kk, LDQ);
          wmma::mma_sync(s[j], a, kb, s[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j)
        wmma::store_matrix_sync(Sw + j * 16, s[j], LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax on row r, columns [half*32, half*32+32)
    float* srow = Sw + r * LDS + half * 32;
    float mx = pt::kNegInf;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int kpos = k0 + half * 32 + c;
      float sv = srow[c] * scale;
      if (bias != nullptr && kpos < Sk) sv = __fadd_rn(sv, bias[(size_t)b * Sk + kpos]);
      if (kpos >= Sk || (causal && kpos > q_pos)) sv = pt::kNegInf;
      srow[c] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.f;
    bf16* prow = Pw + r * LDP + half * 32;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float p = expf(srow[c] - m_new);
      sum += p;
      prow[c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * corr + sum;
    m = m_new;
    float* orow = Ow + r * LDO + half * (D / 2);
#pragma unroll 8
    for (int c = 0; c < D / 2; ++c) orow[c] *= corr;
    __syncwarp();

    // O += P V
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::load_matrix_sync(o, Ow + j * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, Pw + kk, LDP);
        wmma::load_matrix_sync(vb, Vs + kk * LDQ + j * 16, LDQ);
        wmma::mma_sync(o, pa, vb, o);
      }
      wmma::store_matrix_sync(Ow + j * 16, o, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (q_row < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    const bool dead = m <= 0.5f * pt::kNegInf;  // the row sees no key
    const float* orow = Ow + r * LDO + half * (D / 2);
    bf16* dst = out + (((size_t)b * Sq + q_row) * H + h) * D + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; c += 8) {
      float f[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = dead ? 0.f : orow[c + j] / denom;
      *reinterpret_cast<uint4*>(dst + c) = pt::pack8(f);
    }
    if (half == 0) lse[((size_t)b * H + h) * Sq + q_row] = m + logf(denom);
  }
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Sk, Hk, D) bf16 contiguous, D = 128; bias
// (B, Sk) f32 or null (no mask); out (B, Sq, H, D) bf16, lse (B, H, Sq) f32.
PT_EXPORT int pt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                     const void* bias, void* out, void* lse, int B, int Sq,
                                     int Sk, int H, int Hk, int causal, float scale,
                                     void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<<<grid, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(out), static_cast<float*>(lse), B,
      Sq, Sk, H, Hk, causal, scale);
  return cudaGetLastError();
}
