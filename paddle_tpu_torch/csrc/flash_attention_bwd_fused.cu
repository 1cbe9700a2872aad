// K9 flash_attention_bwd_fused: the one-pass causal GQA attention backward,
// with an optional key bias.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:_pallas_bwd_fused
// (_bwd_fused_kernel), which the JAX package runs under
// flags.flash_bwd_impl == "fused" when its dQ partials fit 512 MiB
// (_bwd_prologue). Each live (query tile, key tile) pair computes
//   P = exp(S * scale + bias - lse) once,  dV += P^T dO,
//   dS = P * (dO V^T - delta),            dK += dS^T Q,
//   dQ partial = dS K
// that is five tile products, where K5's two kernels recompute S and dP in
// each and take seven.
//
// Design (the TPU's own order, deterministic): one block per (b*hk, 64-key
// tile) walks the g query heads of its KV group and, for each, the live
// query tiles, accumulating dK and dV in f32 shared memory as K5's dkv
// kernel does (the group sum inside the block). Blocks run in parallel, so
// dQ cannot accumulate across key tiles inside one; each live pair writes
// its 64 x 128 f32 dQ partial straight from the MMA fragments into a
// buffer, and a second kernel (flash_dq_reduce_kernel) sums each query
// tile's partials in ascending key-tile order, scales and casts once, as
// _pallas_bwd_fused sums its partials outside (dqp.sum(axis=0)). No
// atomics: the result does not depend on the block order. Only causally
// live pairs are written and summed: the buffer holds, for each (b, h),
// the pairs in query-tile order, sum_qt live_key_tiles(qt) of them
// (528 at S = 2048 causal: 2.06 GiB f32 at B=4, H=32), transient.
//
// Numerics: those of K5 (flash_bwd_tiles.cuh): bf16 products with f32
// accumulation, P cast to dO's dtype before the dV product and dS to
// Q's/K's dtype before the dK and dQ products; dK and dQ scaled once at
// the end; a query that sees no key takes no term (flash_bwd_tiles.cuh
// says why, and what the wrapper adds for it).
//
// Bound on an H100: tensor-core operations (5 products of 2*S*S*D/2 per
// query head, causal), plus the partials' write and read (2 x 2.06 GiB at
// the Llama-3-8B train shape, ~1.3 ms at 3.35 TB/s). nvcuda::wmma bf16
// tiles as in K5 (~187 KB of shared memory, one block per SM); wgmma with
// register accumulators is a later PR's work.
#include "flash_bwd_tiles.cuh"

using pt::bf16;

namespace pt {
namespace k9 {

using namespace pt::fb;

constexpr int RT = 256;  // threads of the reduce kernel

// index of the first partial of query tile qt among its (b, h)'s pairs
__device__ __forceinline__ int pair_base(int qt, int Sq, int Sk, int causal) {
  int base = 0;
  for (int t = 0; t < qt; ++t) base += live_key_tiles(t, Sq, Sk, causal);
  return base;
}

__global__ void __launch_bounds__(NT)
flash_bwd_fused_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ bias,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, float* __restrict__ dq_part, int n_pairs, int Sq,
                       int Sk, int H, int Hk, int causal, float scale) {
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
  const int kt = blockIdx.x, k0 = kt * BT;
  const int offset = Sk - Sq;

  load_rows(Ks, k, b, hk, k0, Sk, Hk);
  load_rows(Vs, v, b, hk, k0, Sk, Hk);
  load_bias(bias_s, bias, b, k0, Sk);
  zero_acc(dKacc);
  zero_acc(dVacc);

  const int nq = (Sq + BT - 1) / BT;
  const int qt0 = first_query_tile(k0, Sq, Sk, causal);
  const int base0 = pair_base(qt0, Sq, Sk, causal);
  for (int hh = 0; hh < g; ++hh) {
    const int h = hk * g + hh;
    float* part = dq_part + ((size_t)b * H + h) * n_pairs * (BT * D);
    int base = base0;
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
      // this pair's dQ partial, the warp's 16 query rows: dS (16 x 64) . K
      float* dst = part + ((size_t)(base + kt) * BT + w * 16) * D;
#pragma unroll 1
      for (int j = 0; j < D / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
        wmma::fill_fragment(o, 0.f);
#pragma unroll
        for (int kk = 0; kk < BT; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
          wmma::load_matrix_sync(a, dSb + w * 16 * LDP + kk, LDP);
          wmma::load_matrix_sync(bm, Ks + kk * LDQ + j * 16, LDQ);
          wmma::mma_sync(o, a, bm, o);
        }
        wmma::store_matrix_sync(dst + j * 16, o, D, wmma::mem_row_major);
      }
      base += live_key_tiles(qt, Sq, Sk, causal);
    }
  }
  __syncthreads();
  store_rows(dk, dKacc, scale, b, hk, k0, Sk, Hk);
  store_rows(dv, dVacc, 1.f, b, hk, k0, Sk, Hk);
}

// dq rows of query tile blockIdx.x at (b, h) = blockIdx.y: the sum of the
// tile's live partials in ascending key-tile order, times scale, in bf16
__global__ void __launch_bounds__(RT)
flash_dq_reduce_kernel(const float* __restrict__ dq_part, bf16* __restrict__ dq, int n_pairs,
                       int Sq, int Sk, int H, int causal, float scale) {
  const int qt = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int n = live_key_tiles(qt, Sq, Sk, causal);
  const float* part = dq_part + ((size_t)bh * n_pairs + pair_base(qt, Sq, Sk, causal)) * (BT * D);
  for (int i = threadIdx.x; i < BT * (D / 8); i += RT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int s = qt * BT + r;
    if (s >= Sq) continue;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < n; ++t) {
      const float4* src = reinterpret_cast<const float4*>(part + ((size_t)t * BT + r) * D + c);
      const float4 a = src[0], e = src[1];
      f[0] += a.x; f[1] += a.y; f[2] += a.z; f[3] += a.w;
      f[4] += e.x; f[5] += e.y; f[6] += e.z; f[7] += e.w;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] *= scale;
    *reinterpret_cast<uint4*>(dq + (((size_t)b * Sq + s) * H + h) * D + c) = pt::pack8(f);
  }
}

}  // namespace k9
}  // namespace pt

using namespace pt::k9;

// q, dout (B, Sq, H, D), k/v (B, Sk, Hk, D) bf16 contiguous, D = 128; bias
// (B, Sk) f32 or null (no mask); lse, delta (B, H, Sq) f32; dq_part
// (B * H, n_pairs, 64, 128) f32 scratch with n_pairs = the live
// (query tile, key tile) pairs of one (b, h) -> dq (B, Sq, H, D), dk/dv
// (B, Sk, Hk, D) bf16.
PT_EXPORT int pt_flash_attention_bwd_fused(const void* q, const void* k, const void* v,
                                           const void* bias, const void* dout,
                                           const void* lse, const void* delta, void* dq,
                                           void* dk, void* dv, void* dq_part, int n_pairs,
                                           int B, int Sq, int Sk, int H, int Hk, int causal,
                                           float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, KV_SMEM);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  if (Sk > 0) {
    flash_bwd_fused_kernel<<<dim3((Sk + BT - 1) / BT, B * Hk), NT, KV_SMEM, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const float*>(bias), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float*>(dq_part), n_pairs,
        Sq, Sk, H, Hk, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (Sq > 0)
    flash_dq_reduce_kernel<<<dim3((Sq + BT - 1) / BT, B * H), RT, 0, s>>>(
        static_cast<const float*>(dq_part), static_cast<bf16*>(dq), n_pairs, Sq, Sk, H, causal,
        scale);
  return cudaGetLastError();
}
