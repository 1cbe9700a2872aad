// K5 flash_attention_bwd: causal GQA attention backward, split in two
// kernels as the TPU's: dQ (flash_dq_kernel) and dK, dV (flash_dkv_kernel).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:_pallas_bwd
// (_dq_kernel, _dkv_kernel). Both recompute each live tile's
//   P = exp(S * scale - lse),  dP = dO V^T,  dS = P * (dP - delta)
// from the forward's lse (K1 writes it) and delta = rowsum(dO * O), which
// the wrapper computes in f32 outside the kernels, as _pallas_bwd does.
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
// (~187 KB for the dkv kernel, ~145 KB for dq: one block per SM); wgmma with
// register accumulators is a later PR's work.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using pt::bf16;

namespace {

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
constexpr int STATS = 2 * BT * 4;
constexpr int DKV_SMEM = 4 * TILE + 2 * SF + 2 * PB + 2 * ACC + STATS;
constexpr int DQ_SMEM = 4 * TILE + 2 * SF + PB + ACC + STATS;

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
                                         const float* lse_s, const float* dl_s, int q0, int k0,
                                         int Sq, int Sk, int offset, int causal, float scale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp * 16 + lane / 2, half = lane % 2;
  const int q_row = q0 + r;
  const int q_pos = q_row + offset;
  const float lse_r = lse_s[r], dl_r = dl_s[r];
#pragma unroll 8
  for (int c = 0; c < 32; ++c) {
    const int col = half * 32 + c;
    const int kpos = k0 + col;
    const bool live = q_row < Sq && kpos < Sk && !(causal && kpos > q_pos);
    const float p = live ? expf(Sf[r * LDS + col] * scale - lse_r) : 0.f;
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

__global__ void __launch_bounds__(NT)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, int Sq, int Sk, int H, int Hk, int causal, float scale) {
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

  const int w = threadIdx.x / 32;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hk = h / (H / Hk);
  const int q0 = blockIdx.x * BT;
  const int offset = Sk - Sq;

  load_rows(Qs, q, b, h, q0, Sq, H);
  load_rows(dOs, dout, b, h, q0, Sq, H);
  load_stats(lse_s, dl_s, lse, delta, b, h, H, q0, Sq);
  zero_acc(acc);

  int n_tiles = (Sk + BT - 1) / BT;
  if (causal) {
    const int last = min(q0 + BT - 1, Sq - 1) + offset;  // last visible key
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BT + 1);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BT;
    __syncthreads();  // previous tile's K/V reads are done
    load_rows(Ks, k, b, hk, k0, Sk, Hk);
    load_rows(Vs, v, b, hk, k0, Sk, Hk);
    __syncthreads();
    warp_abt(Qs + w * 16 * LDQ, Ks, Sf + w * 16 * LDS);
    warp_abt(dOs + w * 16 * LDQ, Vs, dPf + w * 16 * LDS);
    __syncwarp();
    p_and_ds(Sf, dPf, nullptr, dSb, lse_s, dl_s, q0, k0, Sq, Sk, offset, causal, scale);
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
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H, int Hk,
                 int causal, float scale) {
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

  const int w = threadIdx.x / 32;
  const int bhk = blockIdx.y, b = bhk / Hk, hk = bhk % Hk;
  const int g = H / Hk;
  const int k0 = blockIdx.x * BT;
  const int offset = Sk - Sq;

  load_rows(Ks, k, b, hk, k0, Sk, Hk);
  load_rows(Vs, v, b, hk, k0, Sk, Hk);
  zero_acc(dKacc);
  zero_acc(dVacc);

  const int nq = (Sq + BT - 1) / BT;
  int qt0 = 0;  // first query tile whose last row sees key k0
  if (causal) {
    const int first = k0 - offset;
    qt0 = first <= 0 ? 0 : first / BT;
  }
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
      p_and_ds(Sf, dPf, Pb, dSb, lse_s, dl_s, q0, k0, Sq, Sk, offset, causal, scale);
      __syncthreads();  // every query row's P and dS are in place
      warp_acc_atb(Pb, dOs, dVacc, w);
      warp_acc_atb(dSb, Qs, dKacc, w);
    }
  }
  __syncthreads();
  store_rows(dk, dKacc, scale, b, hk, k0, Sk, Hk);
  store_rows(dv, dVacc, 1.f, b, hk, k0, Sk, Hk);
}

}  // namespace

// q, dout (B, Sq, H, D), k/v (B, Sk, Hk, D) bf16 contiguous, D = 128; lse,
// delta (B, H, Sq) f32 -> dq (B, Sq, H, D), dk/dv (B, Sk, Hk, D) bf16.
PT_EXPORT int pt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
                                     int Hk, int causal, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DKV_SMEM);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *dop = static_cast<const bf16*>(dout);
  const float *lp = static_cast<const float*>(lse), *dp = static_cast<const float*>(delta);
  if (Sq > 0) {
    flash_dq_kernel<<<dim3((Sq + BT - 1) / BT, B * H), NT, DQ_SMEM, s>>>(
        qp, kp, vp, dop, lp, dp, static_cast<bf16*>(dq), Sq, Sk, H, Hk, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (Sk > 0)
    flash_dkv_kernel<<<dim3((Sk + BT - 1) / BT, B * Hk), NT, DKV_SMEM, s>>>(
        qp, kp, vp, dop, lp, dp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, H, Hk,
        causal, scale);
  return cudaGetLastError();
}
