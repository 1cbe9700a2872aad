// K1 flash_attention_fwd: causal GQA online-softmax attention, out + lse,
// with an optional key bias.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:_pallas_fwd
// (_fwd_kernel :100). The TPU walks a sequential (bh, q_block, k_block)
// grid carrying m/l/acc in VMEM scratch; here one block owns (b*h, 128-row
// query tile) and a loop over 64-key tiles takes the place of the
// sequential grid dimension, stopping at the last causally live tile.
// Query head h reads KV head h / (H/Hk), so the repeated K/V are never
// materialized (the TPU's index-map gather).
//
// Numerics follow _fwd_kernel: Q.K^T in bf16 with f32 accumulation, times
// sm_scale, plus the (B, Sk) f32 key bias of a key-padding mask (b_ref at
// _fwd_kernel :125; a null pointer without a mask), each rounded; then
// causally masked logits (and keys past Sk) set to -1e30; p = exp(s - m)
// in f32, summed in f32, and CAST TO V's DTYPE before P.V; out = acc /
// max(l, 1e-30) and lse = m + log(max(l, 1e-30)). The exponentials run as
// exp2: p = 2^(round(s * log2 e) - round(m * log2 e)) on the hardware's
// ex2 (relative error ~2^-22), so equal s and m give exactly 1 and a
// masked key against a finite m exactly 0; log2 e is not folded into the
// scale, so s itself is rounded as the TPU rounds it. A query that sees no
// key (every logit -1e30: a left-pad query under a key-padding mask, or a
// query before the first key when Sq > Sk) writes zeros and lse = -1e30;
// the wrapper then gives such rows the mean of V over all keys, the JAX
// package's reference lowering (a softmax over equal logits). The TPU
// kernel instead averages over its live tiles' keys, an answer that
// depends on its tile size.
//
// Skipped key tiles. A key tile whose 64 biases for batch row b are all
// <= -1e30 (tile_live[b, t] == 0, computed by the wrapper on the device)
// is neither loaded nor multiplied, and this changes no value (no bit, up
// to the sign of an exact zero): each of its logits is s * scale + bias
// <= -1e30 (the bias absorbs any finite s), so
// (a) a row that has seen a live key keeps its m (max with <= -1e30),
// its correction is exactly 1 (the kernel takes 1 where m is unchanged)
// and each p is 2^(-1.44e30 - m') = 0, so O and l do not move; (b) a row
// that has seen no live key yet gets m = -1e30 either way, and when a live
// key comes its correction 2^(-1.44e30 - m') = 0 wipes what the dead tile
// would have added; (c) a row that never sees a live key writes zeros and
// lse = -1e30 + log(l), which is -1e30 in f32 for l = 0 and for l = any
// key count. The same argument lets a warp skip a key tile that lies
// wholly past the causal diagonal of its 16 rows (every later tile does
// too, so the row state it would touch is final).
//
// Bound on an H100: at the train shape (B=4, S=2048, 32/8 heads, D=128,
// causal) the work is 4 * D * (S(S+1)/2) * B * H = 137 GFLOP of bf16
// tensor-core products, 0.139 ms at the 989 TFLOP/s peak; the bytes (Q,
// K, V, out, lse: 0.15 GB) take 0.045 ms. At prefill (B=8, S=128) the
// bytes bound it (6.3 us). The design, against what held the first
// version back:
//   - registers: each warp owns 16 query rows; its 16 x 128 f32 O (64
//     registers a thread) and the rows' m and l stay in registers for the
//     whole key walk, and the correction multiplies the fragments there;
//   - S = Q K^T stays in the mma.sync accumulator fragments: scale, bias,
//     mask, the row max (quad shuffles), exp2 and the row sums run on the
//     fragments, and P is repacked from them straight into the A operand
//     registers of P.V (the FlashAttention-2 layout), so neither S nor P
//     nor O touches shared memory during the walk;
//   - Q (128 rows) is staged once; K, V and the key tile's 64 biases
//     stream through a 2-stage cp.async ring (the loads of the next live
//     tile overlap this tile's products), in XOR-swizzled unpadded tiles
//     read by ldmatrix without bank conflicts: K as the B operand of
//     Q K^T, V through ldmatrix.trans as the B operand of P V (the tiles
//     and swizzle are flash_bwd_tiles.cuh's, shared with K5/K9);
//   - a block is 8 warps and 128 query rows; shared memory 32 KB (Q) + 2 x
//     (32 KB K, V + 256 B of biases) = 96.5 KB, 128 registers a thread
//     (ptxas spills ~100 bytes), so two blocks (16 warps) share an SM and
//     one block's barrier or exp2 pass overlaps the other's products.
//     Q's fragments are read from shared memory for every key tile: kept
//     in registers instead (203 a thread, one block an SM) the kernel ran
//     slower on the H100;
//   - the grid runs query tiles in descending order, so under the causal
//     mask the longest walks launch first (_fwd_walks models the order);
//   - key tiles a bias masks whole are skipped (above), and a warp skips
//     the tiles past its rows' diagonal;
//   - the output leaves through shared memory (each warp's 16 rows of the
//     free Q tile) as 16-byte row stores.
// Every product is mma.sync.m16n8k16; wgmma (warpgroup products from
// shared-memory descriptors) and TMA loads are the next step.
#include "flash_bwd_tiles.cuh"

using pt::bf16;

namespace pt {
namespace k1 {

using namespace pt::fb;

constexpr int BQ = 128;             // query rows of a block: 16 a warp
static_assert(BQ == 16 * NWARPS, "a warp owns 16 query rows");
constexpr int Q_BYTES = BQ * D * 2;
constexpr int STAGE = 2 * TILE + VEC;  // K, V, the key tile's biases
constexpr int SMEM = Q_BYTES + 2 * STAGE;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the hardware's ex2 (subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// the number of 64-key tiles a query range [row0, row0 + rows) reads: all
// of them, or under the causal mask those up to its last row's diagonal
__device__ __forceinline__ int key_tiles(int row0, int rows, int Sq, int Sk, int causal) {
  const int nk = (Sk + BT - 1) / BT;
  if (row0 >= Sq) return 0;
  if (!causal) return nk;
  const int last = min(row0 + rows - 1, Sq - 1) + (Sk - Sq);  // last visible key
  return last < 0 ? 0 : min(nk, last / BT + 1);
}

__global__ void __launch_bounds__(NT, 2)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 const int* __restrict__ tile_live, bf16* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, int Hk, int causal,
                 float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + Q_BYTES;

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;  // fragment row and column pair
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / Hk);
  const int nq = (Sq + BQ - 1) / BQ, nk = (Sk + BT - 1) / BT;
  const int q0 = (nq - 1 - blockIdx.y) * BQ;  // the longest walks first
  const int offset = Sk - Sq;
  const int n_tiles = key_tiles(q0, BQ, Sq, Sk, causal);
  const int w0 = q0 + 16 * w;  // this warp's first row
  const int warp_tiles = key_tiles(w0, 16, Sq, Sk, causal);
  const bool has_bias = bias != nullptr;

  auto load_kv = [&](int s, int t) {
    unsigned char* st = ring + s * STAGE;
    stage_rows(reinterpret_cast<bf16*>(st), k, b, hk, t * BT, Sk, Hk);
    stage_rows(reinterpret_cast<bf16*>(st + TILE), v, b, hk, t * BT, Sk, Hk);
    if (has_bias)
      stage_vec(reinterpret_cast<float*>(st + 2 * TILE), bias, (size_t)b * Sk + t * BT,
                (size_t)b * Sk + Sk);
  };

  // Q stays resident; the first live key tile goes to stage 0
  stage_rows(Qs, q, b, h, q0, Sq, H);
  stage_rows(Qs + BT * D, q, b, h, q0 + BT, Sq, H);
  int t = next_live_tile(tile_live, b, nk, 0, n_tiles);
  if (t < n_tiles) load_kv(0, t);
  cp_async_commit();

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g, g + 8
  const int ar = 16 * w + lane % 16;  // ldmatrix rows of the A operand
  const int br = lane % 8 + (lane / 16) * 8;

  for (int i = 0; t < n_tiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // tile t (and Q) landed; the other stage is free
    const int next = next_live_tile(tile_live, b, nk, t + 1, n_tiles);
    if (next < n_tiles) load_kv((i + 1) % 2, next);
    cp_async_commit();
    if (t < warp_tiles) {  // warp-uniform: a tile past the diagonal is skipped
      const unsigned char* st = ring + (i % 2) * STAGE;
      const bf16* Ks = reinterpret_cast<const bf16*>(st);
      const bf16* Vs = reinterpret_cast<const bf16*>(st + TILE);
      const int k0 = t * BT;

      // S = Q K^T: this warp's 16 rows x 64 keys, 8 fragments of 8 keys
      float s[BT / 8][4];
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned a[4];
        ldsm4(a, Qs + sw<D>(ar, kk * 16 + (lane / 16) * 8));
#pragma unroll
        for (int j = 0; j < BT / 8; j += 2) {
          unsigned r[4];
          ldsm4(r, Ks + sw<D>(br + j * 8, kk * 16 + ((lane / 8) % 2) * 8));
          mma16816(s[j], a, r[0], r[1]);
          mma16816(s[j + 1], a, r[2], r[3]);
        }
      }

      // the logits as the TPU forms them, on the fragments; a tile that
      // holds keys past Sk or past the warp's first row's diagonal needs
      // the per-element mask (warp-uniform)
      const bool edge = k0 + BT > Sk || (causal && k0 + BT - 1 > w0 + offset);
      const float* bias_s = reinterpret_cast<const float*>(st + 2 * TILE);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
        const int c = 8 * j + 2 * tq;
        float2 bv = make_float2(0.f, 0.f);
        if (has_bias) bv = *reinterpret_cast<const float2*>(bias_s + c);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float sv = __fmul_rn(s[j][2 * hr + e], scale);
            if (has_bias) sv = __fadd_rn(sv, e ? bv.y : bv.x);
            if (edge) {
              const int kpos = k0 + c + e;
              if (kpos >= Sk || (causal && kpos > w0 + g + 8 * hr + offset)) sv = kNegInf;
            }
            s[j][2 * hr + e] = sv;
            mx[hr] = fmaxf(mx[hr], sv);
          }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mr = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
        const float m_new = fmaxf(m[hr], mr);
        const float m2 = __fmul_rn(m_new, kLog2e);
        // exactly 1 where the max did not move (a skipped tile's premise)
        const float corr = m_new == m[hr] ? 1.f : ex2(__fmul_rn(m[hr], kLog2e) - m2);
        m[hr] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(__fmul_rn(s[j][2 * hr + e], kLog2e) - m2);
            s[j][2 * hr + e] = p;
            sum += p;
          }
        l[hr] = l[hr] * corr + sum;  // this thread's columns; the quad sums at the end
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[j][2 * hr] *= corr;
          o[j][2 * hr + 1] *= corr;
        }
      }

      // O += P V: P (bf16) from the S fragments as the A operand, V through
      // ldmatrix.trans as the B operand
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        unsigned a[4];
        a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int j = 0; j < D / 8; j += 2) {
          unsigned r[4];
          ldsm4_t(r, Vs + sw<D>(kk * 16 + lane % 16, j * 8 + (lane / 16) * 8));
          mma16816(o[j], a, r[0], r[1]);
          mma16816(o[j + 1], a, r[2], r[3]);
        }
      }
    }
    t = next;
  }
  cp_async_wait<0>();
  __syncthreads();  // no copy in flight, no warp still reading Q

  // out = O / max(l, 1e-30) in bf16 through this warp's 16 rows of the Q
  // tile, then 16-byte row stores; lse per row
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lr = l[hr];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float denom = fmaxf(lr, 1e-30f);
    const bool dead = m[hr] <= 0.5f * kNegInf;  // the row sees no key
    const int r = 16 * w + g + 8 * hr;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float v0 = dead ? 0.f : o[j][2 * hr] / denom;
      const float v1 = dead ? 0.f : o[j][2 * hr + 1] / denom;
      *reinterpret_cast<__nv_bfloat162*>(Qs + sw<D>(r, 8 * j + 2 * tq)) =
          __floats2bfloat162_rn(v0, v1);
    }
    const int row = q0 + r;
    if (tq == 0 && row < Sq) lse[((size_t)b * H + h) * Sq + row] = m[hr] + logf(denom);
  }
  __syncwarp();
#pragma unroll
  for (int c = lane; c < 16 * (D / 8); c += 32) {
    const int r = 16 * w + c / (D / 8), col = (c % (D / 8)) * 8;
    const int row = q0 + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(out + (((size_t)b * Sq + row) * H + h) * D + col) =
          *reinterpret_cast<const uint4*>(Qs + sw<D>(r, col));
  }
}

}  // namespace k1
}  // namespace pt

using namespace pt::k1;

// q (B, Sq, H, D), k/v (B, Sk, Hk, D) bf16 contiguous, D = 128; bias
// (B, Sk) f32 or null (no mask); tile_live (B, ceil(Sk / 64)) int32, 0
// where the bias masks every key of the tile, or null (every tile live);
// out (B, Sq, H, D) bf16, lse (B, H, Sq) f32.
PT_EXPORT int pt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                     const void* bias, const void* tile_live, void* out,
                                     void* lse, int B, int Sq, int Sk, int H, int Hk, int causal,
                                     float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  if (Sq > 0)
    flash_fwd_kernel<<<dim3(B * H, (Sq + BQ - 1) / BQ), NT, SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const float*>(bias), static_cast<const int*>(tile_live),
        static_cast<bf16*>(out), static_cast<float*>(lse), Sq, Sk, H, Hk, causal, scale);
  return cudaGetLastError();
}
