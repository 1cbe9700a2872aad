// K5 flash_attention_bwd: causal GQA attention backward, split in two
// kernels as the TPU's: dQ (flash_dq_kernel) and dK, dV (flash_dkv_kernel).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:_pallas_bwd
// (_dq_kernel, _dkv_kernel). Both recompute each live tile's
//   P = exp(S * scale + bias - lse),  dP = dO V^T,  dS = P * (dP - delta)
// from the forward's lse (K1 writes it) and delta = rowsum(dO * O) in f32,
// which a first kernel (flash_delta_kernel, launched by the wrapper)
// computes outside the two, as _pallas_bwd computes it outside its kernels.
// bias is the (B, Sk) f32 key bias of a key-padding mask (b_ref at
// _dq_kernel :178 and _dkv_kernel :286), or null without a mask; the mask
// gets no gradient. The tile pieces are shared with K9
// (flash_bwd_tiles.cuh), which also says how a query that sees no key is
// treated and why skipping a key tile the bias masks whole is exact.
//
//   dq kernel:  one block per (b*h, 64-row query tile); a loop over the
//               causally live 64-key tiles (those the bias masks whole
//               skipped) takes the place of the TPU's sequential k grid
//               dimension; dQ += dS K accumulates in f32 registers.
//               3 products a pair: S, dP, dQ.
//   dkv kernel: one block per (b*hk, 64-key tile); it walks the g query
//               heads of its KV group and, for each, the live query tiles,
//               accumulating dV += P^T dO and dK += dS^T Q in f32
//               registers. 4 products a pair. The TPU computes dK/dV per
//               QUERY head and group-sums them outside; summing the group
//               inside the block keeps dK/dV deterministic with no atomics
//               and no (B, S, H, D) f32 intermediates. A key tile the bias
//               masks whole writes zeros at once.
//
// Numerics follow the TPU kernels: bf16 products with f32 accumulation; P
// cast to dO's dtype before dV += P^T dO, dS cast to Q's/K's dtype before
// the dK and dQ products; the group sum in f32; one bf16 rounding of dQ, dK
// and dV at the end (sm_scale applied to the f32 sums there). Masked logits
// give P = 0, exactly as exp(-1e30 - lse). Tile liveness is K1's: a query
// tile reads no key tile past its last row's diagonal. No atomics: two
// calls on the same inputs give the same bits.
//
// Bound on an H100: tensor-core operations (7 products of 2*S*S*D/2 per
// query head, causal: 0.47 TFLOP at B=4, S=2048, H=32, 0.48 ms at the bf16
// peak; the function itself needs 5). The design, per product and copy:
//   - every product is bf16 ldmatrix + mma.sync.m16n8k16 (f32 registers);
//     the streamed tiles (Q/dO and their lse/delta rows in the dkv kernel,
//     K/V and their biases in the dq kernel) come by cp.async into a
//     2-stage ring, so the next pair's loads overlap this pair's products;
//   - S and dP stay in registers; P and dS are formed there and only their
//     bf16 values go to shared memory, as the A operand of the transposed
//     products (ldmatrix.trans) and of dQ;
//   - the dkv kernel keeps K and V resident, the dq kernel Q and dO;
//   - blocks of 8 warps, two an SM (128 registers a thread, swizzled
//     unpadded tiles); the dkv grid runs key tiles in ascending order
//     (under the causal mask the longest walks first) and the dq grid
//     query tiles in descending order, so neither ends on a tail of heavy
//     blocks.
// Shared memory: dkv 113 KB (K, V; 2 x (Q, dO, lse, delta); P, dS; the
// biases are read from L1), dq 105 KB (Q, dO; 2 x (K, V, bias); dS; lse,
// delta). wgmma (warpgroup products from shared-memory descriptors) and
// TMA are the next step.
#include "flash_bwd_tiles.cuh"

using pt::bf16;

namespace pt {
namespace k5 {

using namespace pt::fb;

constexpr int DQ_STAGE = 2 * TILE + VEC;  // K, V, the key tile's biases
constexpr int DQ_SMEM = 2 * TILE + 2 * DQ_STAGE + PTILE + 2 * VEC;
constexpr int KV_STAGE = 2 * TILE + 2 * VEC;  // Q, dO, lse, delta
constexpr int DKV_SMEM = 2 * TILE + 2 * KV_STAGE + 2 * PTILE;
static_assert(DQ_SMEM <= 115712 && DKV_SMEM <= 115712, "two blocks an SM");

__global__ void __launch_bounds__(NT, 2)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ bias,
                const int* __restrict__ tile_live, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, int Sq, int Sk, int H, int Hk, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = reinterpret_cast<bf16*>(smem + TILE);
  unsigned char* ring = smem + 2 * TILE;
  bf16* dSb = reinterpret_cast<bf16*>(ring + 2 * DQ_STAGE);
  float* lse_s = reinterpret_cast<float*>(ring + 2 * DQ_STAGE + PTILE);
  float* dl_s = lse_s + BT;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / Hk);
  const int nq = (Sq + BT - 1) / BT, nk = (Sk + BT - 1) / BT;
  const int qt = nq - 1 - blockIdx.y;  // the longest walks first
  const int q0 = qt * BT;
  const int offset = Sk - Sq;
  const int n_tiles = live_key_tiles(qt, Sq, Sk, causal);

  auto stage = [&](int s) { return ring + s * DQ_STAGE; };
  auto load_kv = [&](int s, int t) {
    unsigned char* st = stage(s);
    stage_rows(reinterpret_cast<bf16*>(st), k, b, hk, t * BT, Sk, Hk);
    stage_rows(reinterpret_cast<bf16*>(st + TILE), v, b, hk, t * BT, Sk, Hk);
    stage_vec(reinterpret_cast<float*>(st + 2 * TILE), bias, (size_t)b * Sk + t * BT,
              (size_t)b * Sk + Sk);
  };

  // Q and dO stay resident; the first live key tile goes to stage 0
  stage_rows(Qs, q, b, h, q0, Sq, H);
  stage_rows(dOs, dout, b, h, q0, Sq, H);
  const size_t row0 = ((size_t)b * H + h) * Sq;
  stage_vec(lse_s, lse, row0 + q0, row0 + Sq);
  stage_vec(dl_s, delta, row0 + q0, row0 + Sq);
  int t = next_live_tile(tile_live, b, nk, 0, n_tiles);
  if (t < n_tiles) load_kv(0, t);
  cp_async_commit();

  Acc acc;
  zero(acc);
  for (int i = 0; t < n_tiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // tile t landed; the other stage and dS are free
    const int next = next_live_tile(tile_live, b, nk, t + 1, n_tiles);
    if (next < n_tiles) load_kv((i + 1) % 2, next);
    cp_async_commit();
    const unsigned char* st = stage(i % 2);
    const bf16* Ks = reinterpret_cast<const bf16*>(st);
    Score s, dp;
    score(Qs, Ks, s);
    score(dOs, reinterpret_cast<const bf16*>(st + TILE), dp);
    p_and_ds(s, dp, nullptr, dSb, lse_s, dl_s, reinterpret_cast<const float*>(st + 2 * TILE),
             bias != nullptr, q0, t * BT, Sq, Sk, offset, causal, scale);
    __syncthreads();  // every row of dS is in place
    accumulate<false>(dSb, Ks, acc);
    t = next;
  }
  cp_async_wait<0>();  // nothing in flight at exit (no live key tile)
  store_acc(dq, acc, scale, b, h, q0, Sq, H);
}

__global__ void __launch_bounds__(NT, 2)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 const int* __restrict__ tile_live, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H, int Hk,
                 int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + TILE);
  unsigned char* ring = smem + 2 * TILE;
  bf16* Pb = reinterpret_cast<bf16*>(ring + 2 * KV_STAGE);
  bf16* dSb = reinterpret_cast<bf16*>(ring + 2 * KV_STAGE + PTILE);

  const int bhk = blockIdx.x, b = bhk / Hk, hk = bhk % Hk;
  const int g = H / Hk;
  const int nk = (Sk + BT - 1) / BT;
  const int kt = blockIdx.y, k0 = kt * BT;  // the longest walks first
  const int offset = Sk - Sq;

  Acc dK, dV;
  zero(dK);
  zero(dV);
  if (!tile_is_live(tile_live, b, nk, kt)) {  // every key masked: no term
    store_acc(dk, dK, scale, b, hk, k0, Sk, Hk);
    store_acc(dv, dV, 1.f, b, hk, k0, Sk, Hk);
    return;
  }

  const int nq = (Sq + BT - 1) / BT;
  const int qt0 = first_query_tile(k0, Sq, Sk, causal);
  const int nqt = nq - qt0;
  const int n = g * nqt;  // (head, query tile) pairs, head-major
  auto load_q = [&](int s, int i) {
    unsigned char* st = ring + s * KV_STAGE;
    const int h = hk * g + i / nqt, q0 = (qt0 + i % nqt) * BT;
    const size_t row0 = ((size_t)b * H + h) * Sq;
    stage_rows(reinterpret_cast<bf16*>(st), q, b, h, q0, Sq, H);
    stage_rows(reinterpret_cast<bf16*>(st + TILE), dout, b, h, q0, Sq, H);
    stage_vec(reinterpret_cast<float*>(st + 2 * TILE), lse, row0 + q0, row0 + Sq);
    stage_vec(reinterpret_cast<float*>(st + 2 * TILE + VEC), delta, row0 + q0, row0 + Sq);
  };

  // the key tile's biases are read from global memory (L1), where the
  // key is live: no room is left in shared memory for two blocks an SM
  const float* bias_k = bias != nullptr ? bias + (size_t)b * Sk + k0 : nullptr;
  stage_rows(Ks, k, b, hk, k0, Sk, Hk);
  stage_rows(Vs, v, b, hk, k0, Sk, Hk);
  if (n > 0) load_q(0, 0);
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // pair i landed; the other stage, P and dS are free
    if (i + 1 < n) load_q((i + 1) % 2, i + 1);
    cp_async_commit();
    const unsigned char* st = ring + (i % 2) * KV_STAGE;
    const bf16* Qs = reinterpret_cast<const bf16*>(st);
    const bf16* dOs = reinterpret_cast<const bf16*>(st + TILE);
    const float* lse_s = reinterpret_cast<const float*>(st + 2 * TILE);
    Score s, dp;
    score(Qs, Ks, s);
    score(dOs, Vs, dp);
    p_and_ds(s, dp, Pb, dSb, lse_s, lse_s + BT, bias_k, bias != nullptr,
             (qt0 + i % nqt) * BT, k0, Sq, Sk, offset, causal, scale);
    sync_key_half();  // this key half's P and dS are in place
    accumulate<true>(Pb, dOs, dV);
    accumulate<true>(dSb, Qs, dK);
  }
  cp_async_wait<0>();  // nothing in flight at exit (n == 0: K and V)
  store_acc(dk, dK, scale, b, hk, k0, Sk, Hk);
  store_acc(dv, dV, 1.f, b, hk, k0, Sk, Hk);
}

}  // namespace k5
}  // namespace pt

using namespace pt::k5;

// out, dout (B, Sq, H, D) bf16 contiguous, D = 128 -> delta (B, H, Sq) f32
// = rowsum(dO * O): the first launch of K5 and of K9 (their wrappers call
// it; flash_bwd_tiles.cuh has the kernel)
PT_EXPORT int pt_flash_bwd_delta(const void* out, const void* dout, void* delta, int B, int Sq,
                                 int H, void* stream) {
  const int rows = B * Sq * H;
  if (rows > 0)
    flash_delta_kernel<<<(rows + 15) / 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
        static_cast<float*>(delta), rows, Sq, H);
  return cudaGetLastError();
}

// q, dout (B, Sq, H, D), k/v (B, Sk, Hk, D) bf16 contiguous, D = 128; bias
// (B, Sk) f32 or null (no mask); tile_live (B, ceil(Sk / 64)) int32, 0
// where the bias masks every key of the tile, or null (every tile live);
// lse, delta (B, H, Sq) f32 -> dq (B, Sq, H, D), dk/dv (B, Sk, Hk, D) bf16.
PT_EXPORT int pt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                     const void* bias, const void* tile_live, const void* dout,
                                     const void* lse, const void* delta, void* dq, void* dk,
                                     void* dv, int B, int Sq, int Sk, int H, int Hk, int causal,
                                     float scale, void* stream) {
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
  const int* tl = static_cast<const int*>(tile_live);
  if (Sq > 0) {
    flash_dq_kernel<<<dim3(B * H, (Sq + BT - 1) / BT), NT, DQ_SMEM, s>>>(
        qp, kp, vp, bp, tl, dop, lp, dp, static_cast<bf16*>(dq), Sq, Sk, H, Hk, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (Sk > 0)
    flash_dkv_kernel<<<dim3(B * Hk, (Sk + BT - 1) / BT), NT, DKV_SMEM, s>>>(
        qp, kp, vp, bp, tl, dop, lp, dp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk,
        H, Hk, causal, scale);
  return cudaGetLastError();
}
