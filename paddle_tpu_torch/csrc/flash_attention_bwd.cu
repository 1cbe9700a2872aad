// K5 flash_attention_bwd: causal GQA attention backward, split in two
// kernels as the TPU's: dQ (flash_dq_kernel) and dK, dV (flash_dkv_kernel).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:_pallas_bwd
// (_dq_kernel, _dkv_kernel). Both recompute each live tile's
//   P = exp(S * scale + bias - lse),  dP = dO V^T,  dS = P * (dP - delta)
// from the forward's lse (K1 writes it) and delta = rowsum(dO * O), which
// the wrapper computes in f32 outside the kernels, as _pallas_bwd does.
// bias is the (B, Sk) f32 key bias of a key-padding mask (b_ref at
// _dq_kernel :178 and _dkv_kernel :286), or null without a mask; the mask
// gets no gradient. The tile pieces are shared with K9
// (flash_bwd_tiles.cuh), which also says how a query that sees no key is
// treated.
//
//   dq kernel:  one block per (b*h, 64-row query tile); a loop over the
//               causally live 64-key tiles takes the place of the TPU's
//               sequential k grid dimension; dQ += dS K accumulates in f32.
//   dkv kernel: one block per (b*hk, 64-key tile); it walks the g query
//               heads of its KV group and, for each, the live query tiles,
//               accumulating dV += P^T dO and dK += dS^T Q in f32. The TPU
//               computes dK/dV per QUERY head and group-sums them outside;
//               summing the group inside the block keeps dK/dV
//               deterministic with no atomics and no (B, S, H, D) f32
//               intermediates.
//
// Numerics follow the TPU kernels: bf16 products with f32 accumulation; P
// cast to dO's dtype before dV += P^T dO, dS cast to Q's/K's dtype before
// the dK and dQ products; the group sum in f32; one bf16 rounding of dQ, dK
// and dV at the end (sm_scale applied to the f32 sums there). Masked logits
// give P = 0, exactly as exp(-1e30 - lse). Tile liveness is K1's: a query
// tile reads no key tile past its last row's diagonal.
//
// Bound on an H100: tensor-core operations (5 products of 2*S*S*D/2 per
// query head, causal). This first version uses nvcuda::wmma bf16 tiles with
// Q/K/V/dO tiles, score tiles and the f32 accumulators in shared memory
// (~187 KB for the dkv kernel, ~146 KB for dq: one block per SM); wgmma with
// register accumulators is a later PR's work.
#include "flash_bwd_tiles.cuh"

using pt::bf16;

namespace pt {
namespace k5 {

using namespace pt::fb;

constexpr int DQ_SMEM = 4 * TILE + 2 * SF + PB + ACC + STATS;
constexpr int DKV_SMEM = KV_SMEM;

__global__ void __launch_bounds__(NT)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ bias,
                const bf16* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Sk, int H,
                int Hk, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = reinterpret_cast<bf16*>(smem + TILE);
  bf16* Ks = reinterpret_cast<bf16*>(smem + 2 * TILE);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 3 * TILE);
  float* Sf = reinterpret_cast<float*>(smem + 4 * TILE);
  float* dPf = reinterpret_cast<float*>(smem + 4 * TILE + SF);
  bf16* dSb = reinterpret_cast<bf16*>(smem + 4 * TILE + 2 * SF);
  float* acc = reinterpret_cast<float*>(smem + 4 * TILE + 2 * SF + PB);
  float* lse_s = reinterpret_cast<float*>(smem + 4 * TILE + 2 * SF + PB + ACC);
  float* dl_s = lse_s + BT;
  float* bias_s = lse_s + 2 * BT;

  const int w = threadIdx.x / 32;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hk = h / (H / Hk);
  const int qt = blockIdx.x, q0 = qt * BT;
  const int offset = Sk - Sq;

  load_rows(Qs, q, b, h, q0, Sq, H);
  load_rows(dOs, dout, b, h, q0, Sq, H);
  load_stats(lse_s, dl_s, lse, delta, b, h, H, q0, Sq);
  zero_acc(acc);

  const int n_tiles = live_key_tiles(qt, Sq, Sk, causal);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BT;
    __syncthreads();  // previous tile's K/V/bias reads are done
    load_rows(Ks, k, b, hk, k0, Sk, Hk);
    load_rows(Vs, v, b, hk, k0, Sk, Hk);
    load_bias(bias_s, bias, b, k0, Sk);
    __syncthreads();
    warp_abt(Qs + w * 16 * LDQ, Ks, Sf + w * 16 * LDS);
    warp_abt(dOs + w * 16 * LDQ, Vs, dPf + w * 16 * LDS);
    __syncwarp();
    p_and_ds(Sf, dPf, nullptr, dSb, lse_s, dl_s, bias_s, bias != nullptr, q0,
             k0, Sq, Sk, offset, causal, scale);
    __syncwarp();
    // dQ rows of this warp += dS (16 x 64) . K (64 x 128)
#pragma unroll 1
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::load_matrix_sync(o, acc + w * 16 * LDO + j * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BT; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(a, dSb + w * 16 * LDP + kk, LDP);
        wmma::load_matrix_sync(bm, Ks + kk * LDQ + j * 16, LDQ);
        wmma::mma_sync(o, a, bm, o);
      }
      wmma::store_matrix_sync(acc + w * 16 * LDO + j * 16, o, LDO, wmma::mem_row_major);
    }
  }
  __syncthreads();
  store_rows(dq, acc, scale, b, h, q0, Sq, H);
}

__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 const bf16* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 int Sq, int Sk, int H, int Hk, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + TILE);
  bf16* Qs = reinterpret_cast<bf16*>(smem + 2 * TILE);
  bf16* dOs = reinterpret_cast<bf16*>(smem + 3 * TILE);
  float* Sf = reinterpret_cast<float*>(smem + 4 * TILE);
  float* dPf = reinterpret_cast<float*>(smem + 4 * TILE + SF);
  bf16* Pb = reinterpret_cast<bf16*>(smem + 4 * TILE + 2 * SF);
  bf16* dSb = reinterpret_cast<bf16*>(smem + 4 * TILE + 2 * SF + PB);
  float* dKacc = reinterpret_cast<float*>(smem + 4 * TILE + 2 * SF + 2 * PB);
  float* dVacc = reinterpret_cast<float*>(smem + 4 * TILE + 2 * SF + 2 * PB + ACC);
  float* lse_s = reinterpret_cast<float*>(smem + 4 * TILE + 2 * SF + 2 * PB + 2 * ACC);
  float* dl_s = lse_s + BT;
  float* bias_s = lse_s + 2 * BT;

  const int w = threadIdx.x / 32;
  const int bhk = blockIdx.y, b = bhk / Hk, hk = bhk % Hk;
  const int g = H / Hk;
  const int k0 = blockIdx.x * BT;
  const int offset = Sk - Sq;

  load_rows(Ks, k, b, hk, k0, Sk, Hk);
  load_rows(Vs, v, b, hk, k0, Sk, Hk);
  load_bias(bias_s, bias, b, k0, Sk);
  zero_acc(dKacc);
  zero_acc(dVacc);

  const int nq = (Sq + BT - 1) / BT;
  const int qt0 = first_query_tile(k0, Sq, Sk, causal);
  for (int hh = 0; hh < g; ++hh) {
    const int h = hk * g + hh;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();  // the previous tile's reads of Q, dO, P, dS are done
      load_rows(Qs, q, b, h, q0, Sq, H);
      load_rows(dOs, dout, b, h, q0, Sq, H);
      load_stats(lse_s, dl_s, lse, delta, b, h, H, q0, Sq);
      __syncthreads();
      warp_abt(Qs + w * 16 * LDQ, Ks, Sf + w * 16 * LDS);
      warp_abt(dOs + w * 16 * LDQ, Vs, dPf + w * 16 * LDS);
      __syncwarp();
      p_and_ds(Sf, dPf, Pb, dSb, lse_s, dl_s, bias_s, bias != nullptr, q0,
               k0, Sq, Sk, offset, causal, scale);
      __syncthreads();  // every query row's P and dS are in place
      warp_acc_atb(Pb, dOs, dVacc, w);
      warp_acc_atb(dSb, Qs, dKacc, w);
    }
  }
  __syncthreads();
  store_rows(dk, dKacc, scale, b, hk, k0, Sk, Hk);
  store_rows(dv, dVacc, 1.f, b, hk, k0, Sk, Hk);
}

}  // namespace k5
}  // namespace pt

using namespace pt::k5;

// q, dout (B, Sq, H, D), k/v (B, Sk, Hk, D) bf16 contiguous, D = 128; bias
// (B, Sk) f32 or null (no mask); lse, delta (B, H, Sq) f32 -> dq
// (B, Sq, H, D), dk/dv (B, Sk, Hk, D) bf16.
PT_EXPORT int pt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                     const void* bias, const void* dout, const void* lse,
                                     const void* delta, void* dq, void* dk, void* dv, int B,
                                     int Sq, int Sk, int H, int Hk, int causal, float scale,
                                     void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DKV_SMEM);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *dop = static_cast<const bf16*>(dout);
  const float *bp = static_cast<const float*>(bias), *lp = static_cast<const float*>(lse),
              *dp = static_cast<const float*>(delta);
  if (Sq > 0) {
    flash_dq_kernel<<<dim3((Sq + BT - 1) / BT, B * H), NT, DQ_SMEM, s>>>(
        qp, kp, vp, bp, dop, lp, dp, static_cast<bf16*>(dq), Sq, Sk, H, Hk, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (Sk > 0)
    flash_dkv_kernel<<<dim3((Sk + BT - 1) / BT, B * Hk), NT, DKV_SMEM, s>>>(
        qp, kp, vp, bp, dop, lp, dp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, H,
        Hk, causal, scale);
  return cudaGetLastError();
}
