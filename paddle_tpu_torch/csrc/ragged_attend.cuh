// The ragged two-source attention shared by K11 (ragged_paged_attention.cu)
// and K3's ragged form (rope_append_attend.cu).
//
// A wave of T query rows; slot b owns rows [q_start[b], q_start[b] +
// q_lens[b]). Each row of slot b attends, in one f32 softmax, to
//   * page keys: the slot's cells at positions < page_lens[b], through
//     its block table (no per-row causal mask: page_lens never exceeds a
//     live row's own position + 1);
//   * fresh keys: rows q_start[b] + u of the wave's own K/V with
//     u <= the row's offset and u < fresh_lens[b] (causal in the chunk),
//     non-finite values read as 0 (a 0-weight times NaN must not leak).
// One block per (tile of the slot's rows, kv head, slot) holds QB query
// rows (QB / g wave rows times the g heads of the kv head, so the g heads
// share every K/V tile); blocks past a slot's q_lens exit at once. The
// block stages KT keys at a time of K and V in shared memory as bf16;
// each warp owns QB / 8 query rows and, per tile, lane j scores key j
// against one query (q from shared memory, f32), the warp takes the tile's
// max and sum, and lane l accumulates dims [4l, 4l + 4) of p @ V. Rows
// with no visible key end with l = 0 and write zeros; rows of no segment
// are not touched (the wrapper zero-fills the output).
//
// FUSED (K3's ragged form) adds, before the attention: q rows rotated at
// their positions (apply_rotary_rows: f32 rotate-half with separately
// rounded products, cast to bf16), then scaled; every row of the block's
// tile writes its rotated k (bf16) and raw v into the pool at (slot b,
// row_pos[row]); and fresh keys are the rotated k rows. One launch is
// legal because no row reads a cell that another block writes in the same
// wave: a decode row (q_lens 1, page_lens = old length + 1) reads back only
// its own new cell, which its own block wrote before the __syncthreads()
// that precedes the page walk; prefill rows read pages only below the old
// length (page_lens = old length) and take their own chunk from the fresh
// source; and slots own disjoint pages.
#pragma once

#include "common.cuh"

namespace pt {
namespace ragged {

constexpr int D = 128;
constexpr int HALF = D / 2;
constexpr int KT = 32;          // keys per shared-memory tile (one per lane)
constexpr int QB = 32;          // query rows (wave row x head) per block
constexpr int NW = 8;           // warps per block
constexpr int NT = NW * 32;
constexpr int QPW = QB / NW;    // query rows per warp
constexpr int KSTR = D + 8;     // bf16 row stride of a tile: 272 bytes, so
                                // 16-byte reads of 8 consecutive rows hit
                                // 32 distinct banks

struct Args {
  const bf16* q;           // (T, H, D)
  const bf16* k;           // (T, Hk, D): fresh K (K11), raw k (FUSED)
  const bf16* v;           // (T, Hk, D)
  const float* cos;        // (T, D), FUSED only
  const float* sin;
  bf16* k_pages;           // (L, Hk, P, page, D); written when FUSED
  bf16* v_pages;
  const int* block_tables;  // (B, pps)
  const int* row_pos;       // (T,), FUSED only
  const int* page_lens;     // (B,)
  const int* q_start;
  const int* q_lens;
  const int* fresh_lens;
  bf16* out;               // (T, H, D), zero-filled by the wrapper
  int H, Hk, P, page, pps, layer;
  float scale;
};

struct Shared {
  float qs[QB][D];
  bf16 kt[KT][KSTR];
  bf16 vt[KT][KSTR];
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float rope(float x, float partner, int d, float c, float s) {
  const float r = d < HALF ? -partner : partner;
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(r, s));
}

__device__ __forceinline__ float finite_or_zero(float x) { return isfinite(x) ? x : 0.f; }

// 8 bf16 values with non-finite ones replaced by 0
__device__ __forceinline__ uint4 zero_non_finite8(uint4 u) {
  float f[8];
  unpack8(u, f);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = finite_or_zero(f[i]);
  return pack8(f);
}

// One tile of nk keys in sh.kt / sh.vt against the warp's query rows (the
// block's rows r0.. of its slot; query qi is row r0 + qi / g); a fresh tile
// starts at key offset u0 and is causal per row.
__device__ __forceinline__ void attend_tile(const Shared& sh, int nk, bool fresh_src, int u0,
                                            int r0, int g, int nq, float (&acc)[QPW][4],
                                            float (&m)[QPW], float (&l)[QPW]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < QPW; ++k) {
    const int qi = warp + k * NW;
    if (qi >= nq) break;
    const int roff = r0 + qi / g;
    const bool vis = lane < nk && (!fresh_src || u0 + lane <= roff);
    if (!__any_sync(0xffffffffu, vis)) continue;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      float kf[8];
      unpack8(*reinterpret_cast<const uint4*>(&sh.kt[lane][c * 8]), kf);
      const float4 q0 = *reinterpret_cast<const float4*>(&sh.qs[qi][c * 8]);
      const float4 q1 = *reinterpret_cast<const float4*>(&sh.qs[qi][c * 8 + 4]);
      s += q0.x * kf[0];
      s += q0.y * kf[1];
      s += q0.z * kf[2];
      s += q0.w * kf[3];
      s += q1.x * kf[4];
      s += q1.y * kf[5];
      s += q1.z * kf[6];
      s += q1.w * kf[7];
    }
    const float m_new = fmaxf(m[k], warp_max(vis ? s : -INFINITY));
    const float corr = expf(m[k] - m_new);
    const float p = vis ? expf(s - m_new) : 0.f;
    l[k] = l[k] * corr + warp_sum(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[k][i] *= corr;
#pragma unroll 8
    for (int j = 0; j < KT; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      const uint2 u = *reinterpret_cast<const uint2*>(&sh.vt[j][lane * 4]);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float2 v01 = __bfloat1622float2(h[0]), v23 = __bfloat1622float2(h[1]);
      acc[k][0] += pj * v01.x;
      acc[k][1] += pj * v01.y;
      acc[k][2] += pj * v23.x;
      acc[k][3] += pj * v23.y;
    }
    m[k] = m_new;
  }
}

template <bool FUSED>
__global__ void __launch_bounds__(NT) ragged_attend_kernel(const Args a) {
  __shared__ __align__(16) Shared sh;
  const int tile = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int g = a.H / a.Hk, rt = QB / g;
  const int q_len = a.q_lens[b], r0 = tile * rt;
  if (r0 >= q_len) return;
  const int nrows = min(rt, q_len - r0), nq = nrows * g;
  const int row0 = a.q_start[b] + r0;             // the block's first wave row
  const int page_len = a.page_lens[b], fresh = a.fresh_lens[b];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int* bt = a.block_tables + (size_t)b * a.pps;
  const size_t plane = ((size_t)a.layer * a.Hk + kh) * a.P;
  auto cell = [&](int t) -> size_t {
    return (plane + bt[min(t / a.page, a.pps - 1)]) * a.page + t % a.page;
  };

  // 1. the block's query rows (rotated when FUSED), scaled, in f32
  for (int i = tid; i < nq * D; i += NT) {
    const int qi = i / D, d = i % D;
    const int row = row0 + qi / g, hh = kh * g + qi % g;
    const bf16* qr = a.q + ((size_t)row * a.H + hh) * D;
    float x = __bfloat162float(qr[d]);
    if constexpr (FUSED) {
      const int pd = d < HALF ? d + HALF : d - HALF;
      x = __bfloat162float(__float2bfloat16(rope(x, __bfloat162float(qr[pd]), d,
                                                 a.cos[(size_t)row * D + d],
                                                 a.sin[(size_t)row * D + d])));
    }
    sh.qs[qi][d] = x * a.scale;
  }
  // 2. FUSED: the block's rows write their cells (rotated k, raw v)
  if constexpr (FUSED) {
    for (int i = tid; i < nrows * D; i += NT) {
      const int row = row0 + i / D, d = i % D;
      const int pd = d < HALF ? d + HALF : d - HALF;
      const size_t src = ((size_t)row * a.Hk + kh) * D;
      const size_t dst = cell(max(a.row_pos[row], 0)) * D + d;
      a.k_pages[dst] = __float2bfloat16(rope(__bfloat162float(a.k[src + d]),
                                             __bfloat162float(a.k[src + pd]), d,
                                             a.cos[(size_t)row * D + d],
                                             a.sin[(size_t)row * D + d]));
      a.v_pages[dst] = a.v[src + d];
    }
  }

  float acc[QPW][4], m[QPW], l[QPW];
#pragma unroll
  for (int k = 0; k < QPW; ++k) {
    m[k] = -INFINITY;
    l[k] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[k][i] = 0.f;
  }

  const uint4 zero = make_uint4(0, 0, 0, 0);
  // 3. page keys [0, page_len)
  for (int t0 = 0; t0 < page_len; t0 += KT) {
    const int nk = min(KT, page_len - t0);
    __syncthreads();                    // the last tile is consumed (and, FUSED,
                                        // step 2's cells are visible)
    for (int i = tid; i < KT * (D / 8); i += NT) {
      const int j = i / (D / 8), c = i % (D / 8);
      uint4 kv = zero, vv = zero;
      if (j < nk) {
        const size_t ci = cell(t0 + j) * D + c * 8;
        kv = *reinterpret_cast<const uint4*>(a.k_pages + ci);
        vv = *reinterpret_cast<const uint4*>(a.v_pages + ci);
      }
      *reinterpret_cast<uint4*>(&sh.kt[j][c * 8]) = kv;
      *reinterpret_cast<uint4*>(&sh.vt[j][c * 8]) = vv;
    }
    __syncthreads();
    attend_tile(sh, nk, false, 0, r0, g, nq, acc, m, l);
  }
  // 4. fresh keys [0, min(fresh, the block's last row offset + 1))
  const int nf = min(fresh, r0 + nrows);
  const int fresh_row0 = a.q_start[b];
  for (int u0 = 0; u0 < nf; u0 += KT) {
    const int nk = min(KT, nf - u0);
    __syncthreads();
    for (int i = tid; i < KT * (D / 8); i += NT) {
      const int j = i / (D / 8), c = i % (D / 8);
      uint4 vv = zero;
      const size_t src = ((size_t)(fresh_row0 + u0 + j) * a.Hk + kh) * D;
      if (j < nk) vv = zero_non_finite8(*reinterpret_cast<const uint4*>(a.v + src + c * 8));
      *reinterpret_cast<uint4*>(&sh.vt[j][c * 8]) = vv;
      if constexpr (FUSED) {
        // thread (j, c < 8) rotates dims [8c, 8c + 8) and their partners
        // [8c + 64, 8c + 72) of key j
        if (c < HALF / 8) {
          float lo[8], hi[8];
          if (j < nk) {
            const int row = fresh_row0 + u0 + j;
            unpack8(*reinterpret_cast<const uint4*>(a.k + src + c * 8), lo);
            unpack8(*reinterpret_cast<const uint4*>(a.k + src + HALF + c * 8), hi);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int d = c * 8 + e;
              const float* cs = a.cos + (size_t)row * D;
              const float* sn = a.sin + (size_t)row * D;
              const float x = lo[e], y = hi[e];
              lo[e] = finite_or_zero(__bfloat162float(
                  __float2bfloat16(rope(x, y, d, cs[d], sn[d]))));
              hi[e] = finite_or_zero(__bfloat162float(
                  __float2bfloat16(rope(y, x, d + HALF, cs[d + HALF], sn[d + HALF]))));
            }
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) lo[e] = hi[e] = 0.f;
          }
          *reinterpret_cast<uint4*>(&sh.kt[j][c * 8]) = pack8(lo);
          *reinterpret_cast<uint4*>(&sh.kt[j][HALF + c * 8]) = pack8(hi);
        }
      } else {
        uint4 kv = zero;
        if (j < nk) kv = zero_non_finite8(*reinterpret_cast<const uint4*>(a.k + src + c * 8));
        *reinterpret_cast<uint4*>(&sh.kt[j][c * 8]) = kv;
      }
    }
    __syncthreads();
    attend_tile(sh, nk, true, u0, r0, g, nq, acc, m, l);
  }

  // 5. the warp's query rows: acc / max(l, 1e-30) in bf16
#pragma unroll
  for (int k = 0; k < QPW; ++k) {
    const int qi = warp + k * NW;
    if (qi >= nq) break;
    const int row = row0 + qi / g, hh = kh * g + qi % g;
    const float lk = fmaxf(l[k], 1e-30f);
    uint2 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
    h[0] = __floats2bfloat162_rn(acc[k][0] / lk, acc[k][1] / lk);
    h[1] = __floats2bfloat162_rn(acc[k][2] / lk, acc[k][3] / lk);
    *reinterpret_cast<uint2*>(a.out + ((size_t)row * a.H + hh) * D + lane * 4) = u;
  }
}

// grid (row tiles covering T rows, Hk, B) of NT threads
template <bool FUSED>
int launch_ragged(const Args& a, int T, int B, cudaStream_t stream) {
  const int rt = QB / (a.H / a.Hk);
  dim3 grid((T + rt - 1) / rt, a.Hk, B);
  ragged_attend_kernel<FUSED><<<grid, NT, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace ragged
}  // namespace pt
