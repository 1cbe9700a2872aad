// K9 flash_attention_bwd_fused: the one-pass causal GQA attention backward,
// with an optional key bias.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:_pallas_bwd_fused
// (_bwd_fused_kernel), which the JAX package runs under
// flags.flash_bwd_impl == "fused" when its dQ partials fit 512 MiB
// (_bwd_prologue). Each live (query tile, key tile) pair computes
//   P = exp(S * scale + bias - lse) once,  dV += P^T dO,
//   dS = P * (dO V^T - delta),            dK += dS^T Q,
//   dQ += dS K
// that is five tile products, where K5's two kernels recompute S and dP in
// each and take seven.
//
// Design (deterministic, no atomics): one block per (b*hk, 64-key tile)
// walks the g query heads of its KV group and, for each, the live query
// tiles, accumulating dK and dV in f32 registers as K5's dkv kernel does
// (the group sum inside the block, the same ring, tiles and products:
// flash_bwd_tiles.cuh). Blocks run in parallel, so dQ cannot accumulate
// across key tiles inside one. The TPU kernel writes each pair's f32 dQ
// partial (dS K, 64 x 128) and sums them after; here each live pair writes
// its bf16 dS tile (64 x 64, the operand the dQ product rounds to anyway),
// a quarter of the bytes, and a second kernel (flash_dq_reduce_kernel)
// runs the dQ product: for each query tile, dQ = sum over its live key
// tiles in ascending order of dS K, in f32 registers, scaled and cast
// once. The result does not depend on the block order. The buffer holds,
// for each (b, h), the live pairs in query-tile order, sum_qt
// live_key_tiles(qt) of them (528 at S = 2048 causal: 0.52 GiB of bf16 at
// B=4, H=32, transient); pairs of a key tile the bias masks whole are
// neither written nor read.
//
// Numerics: those of K5 (flash_bwd_tiles.cuh): bf16 products with f32
// accumulation, P cast to dO's dtype before the dV product and dS to
// Q's/K's dtype before the dK and dQ products; dK and dQ scaled once at
// the end; a query that sees no key takes no term (flash_bwd_tiles.cuh
// says why, and what the wrapper adds for it).
//
// Bound on an H100: tensor-core operations (5 products of 2*S*S*D/2 per
// query head, causal: 0.34 TFLOP at the Llama-3-8B train shape, 0.35 ms at
// the bf16 peak), plus the dS partials' write and read (2 x 0.52 GiB,
// 0.33 ms at 3.35 TB/s; the f32 dQ partials they replace took 1.3 ms).
// Hopper features as in K5: ldmatrix + mma.sync for all five products,
// a 2-stage cp.async ring for Q/dO/lse/delta (one pass) and for dS/K (the
// dQ product), longest walks first in both grids. Shared memory: 113 KB
// for the one-pass kernel (two blocks an SM), 48 KB for the dQ product
// (three).
#include "flash_bwd_tiles.cuh"

using pt::bf16;

namespace pt {
namespace k9 {

using namespace pt::fb;

constexpr int KV_STAGE = 2 * TILE + 2 * VEC;  // Q, dO, lse, delta
constexpr int FUSED_SMEM = 2 * TILE + 2 * KV_STAGE + 2 * PTILE;
static_assert(FUSED_SMEM <= 115712, "two blocks an SM");
constexpr int DS_TILE = BT * BT;  // bf16 elements of one dS partial
constexpr int RED_STAGE = PTILE + TILE;  // dS, K
constexpr int RED_SMEM = 2 * RED_STAGE;

// index of the first partial of query tile qt among its (b, h)'s pairs
__device__ __forceinline__ int pair_base(int qt, int Sq, int Sk, int causal) {
  int base = 0;
  for (int t = 0; t < qt; ++t) base += live_key_tiles(t, Sq, Sk, causal);
  return base;
}

__global__ void __launch_bounds__(NT, 2)
flash_bwd_fused_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ bias,
                       const int* __restrict__ tile_live, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, bf16* __restrict__ ds_part,
                       int n_pairs, int Sq, int Sk, int H, int Hk, int causal, float scale) {
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

  // the key tile's biases are read from global memory (L1), as in K5's
  // dkv kernel
  const float* bias_k = bias != nullptr ? bias + (size_t)b * Sk + k0 : nullptr;
  stage_rows(Ks, k, b, hk, k0, Sk, Hk);
  stage_rows(Vs, v, b, hk, k0, Sk, Hk);
  if (n > 0) load_q(0, 0);
  cp_async_commit();
  const int base0 = pair_base(qt0, Sq, Sk, causal);
  int base = base0;
  for (int i = 0; i < n; ++i) {
    const int qt = qt0 + i % nqt;
    if (qt == qt0) base = base0;  // a new head starts its walk
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
    p_and_ds(s, dp, Pb, dSb, lse_s, lse_s + BT, bias_k, bias != nullptr, qt * BT, k0, Sq, Sk,
             offset, causal, scale);
    sync_key_half();  // this key half's P and dS are in place
    accumulate<true>(Pb, dOs, dV);
    accumulate<true>(dSb, Qs, dK);
    // this pair's dS tile, each key half by the warps that formed it, 16
    // bytes a thread twice
    const int h = hk * g + i / nqt;
    bf16* dst = ds_part + (((size_t)b * H + h) * n_pairs + base + kt) * DS_TILE;
    for (int e = threadIdx.x % 128; e < DS_TILE / 16; e += 128) {
      const int r = e / 4, c = 32 * (threadIdx.x / 128) + (e % 4) * 8;
      *reinterpret_cast<uint4*>(dst + r * BT + c) =
          *reinterpret_cast<const uint4*>(dSb + sw<BT>(r, c));
    }
    base += live_key_tiles(qt, Sq, Sk, causal);
  }
  cp_async_wait<0>();  // nothing in flight at exit (n == 0: K and V)
  store_acc(dk, dK, scale, b, hk, k0, Sk, Hk);
  store_acc(dv, dV, 1.f, b, hk, k0, Sk, Hk);
}

// dq rows of query tile qt at (b, h) = blockIdx.x: dS K summed over the
// tile's live key tiles in ascending order (a 2-stage cp.async ring of dS
// partials and K tiles), times scale, in bf16; the longest walks first
__global__ void __launch_bounds__(NT, 3)
flash_dq_reduce_kernel(const bf16* __restrict__ ds_part, const bf16* __restrict__ k,
                       const int* __restrict__ tile_live, bf16* __restrict__ dq, int n_pairs,
                       int Sq, int Sk, int H, int Hk, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / Hk);
  const int nq = (Sq + BT - 1) / BT, nk = (Sk + BT - 1) / BT;
  const int qt = nq - 1 - blockIdx.y;
  const int n_tiles = live_key_tiles(qt, Sq, Sk, causal);
  const bf16* part = ds_part + ((size_t)bh * n_pairs + pair_base(qt, Sq, Sk, causal)) * DS_TILE;

  auto load = [&](int s, int t) {
    bf16* dS = reinterpret_cast<bf16*>(smem + s * RED_STAGE);
    const bf16* src = part + (size_t)t * DS_TILE;
    for (int e = threadIdx.x; e < DS_TILE / 8; e += NT) {
      const int r = e / (BT / 8), c = (e % (BT / 8)) * 8;
      cp_async16(dS + sw<BT>(r, c), src + r * BT + c, true);
    }
    stage_rows(reinterpret_cast<bf16*>(smem + s * RED_STAGE + PTILE), k, b, hk, t * BT, Sk, Hk);
  };

  int t = next_live_tile(tile_live, b, nk, 0, n_tiles);
  if (t < n_tiles) load(0, t);
  cp_async_commit();
  Acc acc;
  zero(acc);
  for (int i = 0; t < n_tiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // tile t landed; the other stage is free
    const int next = next_live_tile(tile_live, b, nk, t + 1, n_tiles);
    if (next < n_tiles) load((i + 1) % 2, next);
    cp_async_commit();
    const unsigned char* st = smem + (i % 2) * RED_STAGE;
    accumulate<false>(reinterpret_cast<const bf16*>(st), reinterpret_cast<const bf16*>(st + PTILE),
                      acc);
    t = next;
  }
  cp_async_wait<0>();
  store_acc(dq, acc, scale, b, h, qt * BT, Sq, H);
}

}  // namespace k9
}  // namespace pt

using namespace pt::k9;

// q, dout (B, Sq, H, D), k/v (B, Sk, Hk, D) bf16 contiguous, D = 128; bias
// (B, Sk) f32 or null (no mask); tile_live (B, ceil(Sk / 64)) int32, 0
// where the bias masks every key of the tile, or null; lse, delta
// (B, H, Sq) f32; ds_part (B * H, n_pairs, 64, 64) bf16 scratch with
// n_pairs = the live (query tile, key tile) pairs of one (b, h) -> dq
// (B, Sq, H, D), dk/dv (B, Sk, Hk, D) bf16.
PT_EXPORT int pt_flash_attention_bwd_fused(const void* q, const void* k, const void* v,
                                           const void* bias, const void* tile_live,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dq, void* dk, void* dv, void* ds_part,
                                           int n_pairs, int B, int Sq, int Sk, int H, int Hk,
                                           int causal, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, FUSED_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_dq_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             RED_SMEM);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  const int* tl = static_cast<const int*>(tile_live);
  bf16* part = static_cast<bf16*>(ds_part);
  if (Sk > 0) {
    flash_bwd_fused_kernel<<<dim3(B * Hk, (Sk + BT - 1) / BT), NT, FUSED_SMEM, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const float*>(bias), tl, static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), part, n_pairs, Sq, Sk, H, Hk, causal,
        scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (Sq > 0)
    flash_dq_reduce_kernel<<<dim3(B * H, (Sq + BT - 1) / BT), NT, RED_SMEM, s>>>(
        part, static_cast<const bf16*>(k), tl, static_cast<bf16*>(dq), n_pairs, Sq, Sk, H, Hk,
        causal, scale);
  return cudaGetLastError();
}
