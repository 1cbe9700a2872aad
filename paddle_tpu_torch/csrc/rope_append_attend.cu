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
// On an int8 cache (pt_rope_append_attend_decode_int8) the pools hold
// symmetric-absmax codes with one f32 scale per (head, token) cell
// (L, Hk, P, page, 1). Step 2 quantizes the rotated k row (already rounded
// to bf16) and the raw v row as kv_cache._quantize_cells does: scale =
// max(max|x| / 127, 1e-12), code = clip(rint(x / scale), -127, 127), IEEE
// division and round-half-even, and stores codes and scales in place. Step
// 3 reads every page cell as code * scale in f32, and the new cell from
// shared memory as its own code * scale (the TPU kernel's quantize ->
// dequantize self-cell patch), never as the unquantized row.
//
// Bound on an H100: bytes — each step reads every live cell's K and V once
// (2 * len * Hk * D * 2 bytes per slot; 2 * len * Hk * (D + 4) on an int8
// cache) and does ~4*g*D flops per cell. This version reads 8 bytes (4 on
// an int8 cache) per lane per cell and has B*Hk blocks, which is fewer than the 132 SMs at B = 8,
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

// the 4 values of a lane's dims [lane*4, lane*4+4) of one pool cell, in f32
__device__ __forceinline__ void read4(const bf16* p, float s, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 a = __bfloat1622float2(h[i]);
    f[2 * i] = a.x;
    f[2 * i + 1] = a.y;
  }
}

__device__ __forceinline__ void read4(const signed char* p, float s, float* f) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  f[0] = (float)c.x * s;
  f[1] = (float)c.y * s;
  f[2] = (float)c.z * s;
  f[3] = (float)c.w * s;
}

// max over the D = 128 values held by threads 0..127 (4 warps); every
// thread of the block must call it
__device__ __forceinline__ float absmax_d(float x, float* red) {
  const int tid = threadIdx.x, warp = tid / 32;
  float m = tid < D ? fabsf(x) : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (tid % 32 == 0 && warp < D / 32) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < D / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

// kv_cache._quantize_cells for one value of a cell with absmax `amax`:
// (code, scale), scale = max(amax / 127, 1e-12), code = clip(rint(x / scale))
__device__ __forceinline__ signed char quantize(float x, float amax, float* scale) {
  *scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
  return (signed char)fminf(fmaxf(rintf(__fdiv_rn(x, *scale)), -127.f), 127.f);
}

// Pool = bf16 (verbatim cache) or signed char (int8 codes; k_sc/v_sc are
// the scale pools, else unused)
template <typename Pool>
__global__ void __launch_bounds__(NT)
rope_append_attend_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ cos_t,
                          const float* __restrict__ sin_t, Pool* __restrict__ k_pages,
                          Pool* __restrict__ v_pages, float* __restrict__ k_sc,
                          float* __restrict__ v_sc, const int* __restrict__ block_tables,
                          const int* __restrict__ seq_lens, bf16* __restrict__ out, int H,
                          int Hk, int P, int page, int pps, int layer, float scale) {
  constexpr bool QUANT = sizeof(Pool) == 1;
  __shared__ float qs[MAXG][D];
  __shared__ float kself[D], vself[D];
  __shared__ float red_m[NWARPS][MAXG], red_l[NWARPS][MAXG];
  __shared__ float red_acc[NWARPS][MAXG][D];
  __shared__ float red_k[D / 32], red_v[D / 32];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int g = H / Hk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pos = seq_lens[b];
  const int* bt = block_tables + (size_t)b * pps;
  // (L, Hk, P, page[, D]): the (layer, kh) plane's page p, cell o
  auto cell_index = [&](int p, int o) -> size_t {
    return (((size_t)layer * Hk + kh) * P + p) * page + o;
  };

  // the new cell: rotated k (rounded to bf16) and raw v, in f32
  float kn = 0.f, vn = 0.f;
  const size_t self_cell = cell_index(bt[min(pos / page, pps - 1)], pos % page);
  if (tid < D) {
    const int d = tid, pd = d < HALF ? d + HALF : d - HALF;
    const float c = cos_t[(size_t)b * D + d], s = sin_t[(size_t)b * D + d];
    const bf16* kr = k + ((size_t)b * Hk + kh) * D;
    kn = __bfloat162float(__float2bfloat16(
        rope(__bfloat162float(kr[d]), __bfloat162float(kr[pd]), d, c, s)));
    vn = __bfloat162float(v[((size_t)b * Hk + kh) * D + d]);
  }
  if constexpr (QUANT) {
    const float kmax = absmax_d(kn, red_k), vmax = absmax_d(vn, red_v);
    if (tid < D) {
      float ks, vs;
      const signed char kq = quantize(kn, kmax, &ks), vq = quantize(vn, vmax, &vs);
      k_pages[self_cell * D + tid] = kq;
      v_pages[self_cell * D + tid] = vq;
      if (tid == 0) {
        k_sc[self_cell] = ks;
        v_sc[self_cell] = vs;
      }
      kself[tid] = (float)kq * ks;
      vself[tid] = (float)vq * vs;
    }
  } else if (tid < D) {
    k_pages[self_cell * D + tid] = __float2bfloat16(kn);
    v_pages[self_cell * D + tid] = __float2bfloat16(vn);
    kself[tid] = kn;
    vself[tid] = vn;
  }
  if (tid < D) {
    const int d = tid, pd = d < HALF ? d + HALF : d - HALF;
    const float c = cos_t[(size_t)b * D + d], s = sin_t[(size_t)b * D + d];
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
      const size_t ci = cell_index(bt[min(t / page, pps - 1)], t % page);
      read4(k_pages + ci * D + lane * 4, QUANT ? k_sc[ci] : 0.f, kf);
      read4(v_pages + ci * D + lane * 4, QUANT ? v_sc[ci] : 0.f, vf);
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
  rope_append_attend_kernel<bf16><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<bf16*>(k_pages), static_cast<bf16*>(v_pages), nullptr, nullptr,
      static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens),
      static_cast<bf16*>(out), H, Hk, P, page, pps, layer, scale);
  return cudaGetLastError();
}

// The same over an int8 cache: k_pages/v_pages (L, Hk, P, page, D) int8
// codes and k_scales/v_scales (L, Hk, P, page, 1) f32, all written in place.
PT_EXPORT int pt_rope_append_attend_decode_int8(
    const void* q, const void* k, const void* v, const void* cos_t, const void* sin_t,
    void* k_pages, void* v_pages, void* k_scales, void* v_scales, const void* block_tables,
    const void* seq_lens, void* out, int B, int H, int Hk, int P, int page, int pps, int layer,
    float scale, void* stream) {
  dim3 grid(Hk, B);
  rope_append_attend_kernel<signed char><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<signed char*>(k_pages), static_cast<signed char*>(v_pages),
      static_cast<float*>(k_scales), static_cast<float*>(v_scales),
      static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens),
      static_cast<bf16*>(out), H, Hk, P, page, pps, layer, scale);
  return cudaGetLastError();
}
