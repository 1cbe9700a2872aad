// K3 rope_append_attend_decode: one decode token per slot, per layer —
// rope on q/k, in-place append of (k, v) into the paged pool, attention of
// the slot's query heads over its pages including the new cell.
//
// Replaces paddle_tpu/ops/pallas/fused_rope_attend.py:_pallas_fused
// (_fused_kernel), decode form (fused_rope_append_attend_decode). The TPU
// kernel writes the pool through aliased outputs; here the block stores the
// new cell straight into the pool tensor. One block per (kv head, slot):
//   1. threads d = 0..127 rotate the slot's k row and its g query rows in
//      f32 at position seq_lens[b] (apply_rotary_rows: x*cos +
//      rotate_half(x)*sin with separately rounded products, cast to bf16);
//   2. the rotated k and the raw v land in page block_tables[b, pos/page],
//      cell pos % page (logical page clamped like append_token_masked);
//   3. the 8 warps split the seq_lens[b] + 1 cells, each running an f32
//      online softmax for all g query heads (q double-cast: bf16 then
//      f32 * scale, as the TPU kernel's q load); the just-written cell is
//      read from shared memory, not from the pool (the TPU kernel's
//      in-register self-cell patch);
//   4. the warps' partial (m, l, acc) merge in shared memory and the block
//      writes out (B, H, D) in bf16 after dividing by max(l, 1e-30).
// Cells past seq_lens[b] + 1 are neither read nor written.
//
// Bound on an H100: bytes — each step reads every live cell's K and V once
// (2 * len * Hk * D * 2 bytes per slot) and does ~4*g*D flops per cell.
// This version reads 8 bytes per lane per cell (one 256-byte row per warp
// access) and has B*Hk blocks, which is fewer than the 132 SMs at B = 8,
// Hk = 8; splitting the page walk across blocks is a later PR's work.
#include "common.cuh"

using pt::bf16;

namespace {

constexpr int D = 128;
constexpr int HALF = D / 2;
constexpr int MAXG = 8;
constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;

__device__ __forceinline__ float rope(float x, float partner, int d, float c, float s) {
  const float r = d < HALF ? -partner : partner;
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(r, s));
}

__global__ void __launch_bounds__(NT)
rope_append_attend_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ cos_t,
                          const float* __restrict__ sin_t, bf16* __restrict__ k_pages,
                          bf16* __restrict__ v_pages, const int* __restrict__ block_tables,
                          const int* __restrict__ seq_lens, bf16* __restrict__ out, int H,
                          int Hk, int P, int page, int pps, int layer, float scale) {
  __shared__ float qs[MAXG][D];
  __shared__ float kself[D], vself[D];
  __shared__ float red_m[NWARPS][MAXG], red_l[NWARPS][MAXG];
  __shared__ float red_acc[NWARPS][MAXG][D];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int g = H / Hk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pos = seq_lens[b];
  const int* bt = block_tables + (size_t)b * pps;
  // (L, Hk, P, page, D): the (layer, kh) plane's page p, cell o
  auto cell = [&](int p, int o) -> size_t {
    return ((((size_t)layer * Hk + kh) * P + p) * page + o) * D;
  };

  if (tid < D) {
    const int d = tid, pd = d < HALF ? d + HALF : d - HALF;
    const float c = cos_t[(size_t)b * D + d], s = sin_t[(size_t)b * D + d];
    const bf16* kr = k + ((size_t)b * Hk + kh) * D;
    const bf16 kb = __float2bfloat16(
        rope(__bfloat162float(kr[d]), __bfloat162float(kr[pd]), d, c, s));
    const bf16 vb = v[((size_t)b * Hk + kh) * D + d];
    const size_t dst = cell(bt[min(pos / page, pps - 1)], pos % page) + d;
    k_pages[dst] = kb;
    v_pages[dst] = vb;
    kself[d] = __bfloat162float(kb);
    vself[d] = __bfloat162float(vb);
    for (int j = 0; j < g; ++j) {
      const bf16* qr = q + ((size_t)b * H + kh * g + j) * D;
      const bf16 qb = __float2bfloat16(
          rope(__bfloat162float(qr[d]), __bfloat162float(qr[pd]), d, c, s));
      qs[j][d] = __bfloat162float(qb) * scale;
    }
  }
  __syncthreads();

  // lane owns dims [lane*4, lane*4+4)
  float qreg[MAXG][4], acc[MAXG][4], m[MAXG], l[MAXG];
#pragma unroll
  for (int j = 0; j < MAXG; ++j) {
    m[j] = pt::kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qreg[j][i] = j < g ? qs[j][lane * 4 + i] : 0.f;
      acc[j][i] = 0.f;
    }
  }

  const int n = pos + 1;
  for (int t = warp; t < n; t += NWARPS) {
    float kf[4], vf[4];
    if (t == pos) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kf[i] = kself[lane * 4 + i];
        vf[i] = vself[lane * 4 + i];
      }
    } else {
      const size_t base = cell(bt[min(t / page, pps - 1)], t % page) + lane * 4;
      const uint2 kv = *reinterpret_cast<const uint2*>(k_pages + base);
      const uint2 vv = *reinterpret_cast<const uint2*>(v_pages + base);
      const __nv_bfloat162* kh2 = reinterpret_cast<const __nv_bfloat162*>(&kv);
      const __nv_bfloat162* vh2 = reinterpret_cast<const __nv_bfloat162*>(&vv);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 a = __bfloat1622float2(kh2[i]), c = __bfloat1622float2(vh2[i]);
        kf[2 * i] = a.x;
        kf[2 * i + 1] = a.y;
        vf[2 * i] = c.x;
        vf[2 * i + 1] = c.y;
      }
    }
#pragma unroll
    for (int j = 0; j < MAXG; ++j) {
      if (j >= g) break;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) s += qreg[j][i] * kf[i];
      s = pt::warp_sum(s);
      const float m_new = fmaxf(m[j], s);
      const float corr = expf(m[j] - m_new);
      const float p = expf(s - m_new);
      l[j] = l[j] * corr + p;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = acc[j][i] * corr + p * vf[i];
      m[j] = m_new;
    }
  }

#pragma unroll
  for (int j = 0; j < MAXG; ++j) {
    if (j >= g) break;
    if (lane == 0) {
      red_m[warp][j] = m[j];
      red_l[warp][j] = l[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) red_acc[warp][j][lane * 4 + i] = acc[j][i];
  }
  __syncthreads();

  if (tid < D) {
    for (int j = 0; j < g; ++j) {
      float mt = pt::kNegInf;
      for (int w = 0; w < NWARPS; ++w) mt = fmaxf(mt, red_m[w][j]);
      float lt = 0.f, at = 0.f;
      for (int w = 0; w < NWARPS; ++w) {
        const float e = expf(red_m[w][j] - mt);
        lt += red_l[w][j] * e;
        at += red_acc[w][j][tid] * e;
      }
      out[((size_t)b * H + kh * g + j) * D + tid] = __float2bfloat16(at / fmaxf(lt, 1e-30f));
    }
  }
}

}  // namespace

// q (B, H, D), k/v (B, Hk, D) bf16; cos/sin (B, D) f32 at each slot's
// position; k_pages/v_pages (L, Hk, P, page, D) bf16, written in place;
// block_tables (B, pps) int32; seq_lens (B,) int32; out (B, H, D) bf16.
PT_EXPORT int pt_rope_append_attend_decode(const void* q, const void* k, const void* v,
                                           const void* cos_t, const void* sin_t, void* k_pages,
                                           void* v_pages, const void* block_tables,
                                           const void* seq_lens, void* out, int B, int H,
                                           int Hk, int P, int page, int pps, int layer,
                                           float scale, void* stream) {
  dim3 grid(Hk, B);
  rope_append_attend_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<bf16*>(k_pages), static_cast<bf16*>(v_pages),
      static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens),
      static_cast<bf16*>(out), H, Hk, P, page, pps, layer, scale);
  return cudaGetLastError();
}
