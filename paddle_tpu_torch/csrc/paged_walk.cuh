// The decode-row page walk shared by K3 (rope_append_attend.cu, decode
// form) and K10 (paged_attention.cu): the g query heads of one kv head of
// one slot attend over the slot's first n cells, found through its block
// table. One block of kWalkThreads threads: the 8 warps split the cells,
// each running an f32 online softmax for all g heads with lane l owning
// dims [4l, 4l + 4); the warps' partial (m, l, acc) then merge in shared
// memory and the block writes the g output rows in bf16 after dividing by
// max(l, 1e-30) (zeros when n == 0).
#pragma once

#include "common.cuh"

namespace pt {

constexpr int kD = 128;
constexpr int kMaxG = 8;
constexpr int kWalkWarps = 8;
constexpr int kWalkThreads = kWalkWarps * 32;

// the 4 values of a lane's dims [lane*4, lane*4+4) of one pool cell, in f32
__device__ __forceinline__ void read4(const bf16* p, float, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 a = __bfloat1622float2(h[i]);
    f[2 * i] = a.x;
    f[2 * i + 1] = a.y;
  }
}

// int8 codes of a cell, dequantized with the cell's scale s
__device__ __forceinline__ void read4(const signed char* p, float s, float* f) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  f[0] = (float)c.x * s;
  f[1] = (float)c.y * s;
  f[2] = (float)c.z * s;
  f[3] = (float)c.w * s;
}

struct WalkShared {
  float qs[kMaxG][kD];          // the g query rows, already scaled
  float kself[kD], vself[kD];   // the cell at self_pos (K3's new cell)
  float red_m[kWalkWarps][kMaxG], red_l[kWalkWarps][kMaxG];
  float red_acc[kWalkWarps][kMaxG][kD];
};

// Attend sh.qs[0..g) over cells [0, n) of the page plane starting at
// physical page index `plane` ((layer * Hk + kh) * P), slot block-table row
// `bt`; the cell at self_pos (-1: none) comes from sh.kself/vself, not the
// pool. k_sc/v_sc are the int8 cache's scale pools (unused for bf16).
// out points at the slot's first output row of this kv head (rows j * kD).
// Every thread of the block must call it, after sh.qs (and the self cell)
// are written and synchronised.
template <typename Pool>
__device__ void paged_walk(WalkShared& sh, int g, const Pool* k_pages,
                           const Pool* v_pages, const float* k_sc, const float* v_sc,
                           const int* bt, int pps, int page, size_t plane, int n,
                           int self_pos, bf16* out) {
  constexpr bool QUANT = sizeof(Pool) == 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  float qreg[kMaxG][4], acc[kMaxG][4], m[kMaxG], l[kMaxG];
#pragma unroll
  for (int j = 0; j < kMaxG; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qreg[j][i] = j < g ? sh.qs[j][lane * 4 + i] : 0.f;
      acc[j][i] = 0.f;
    }
  }

  for (int t = warp; t < n; t += kWalkWarps) {
    float kf[4], vf[4];
    if (t == self_pos) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kf[i] = sh.kself[lane * 4 + i];
        vf[i] = sh.vself[lane * 4 + i];
      }
    } else {
      const size_t ci = (plane + bt[min(t / page, pps - 1)]) * page + t % page;
      read4(k_pages + ci * kD + lane * 4, QUANT ? k_sc[ci] : 0.f, kf);
      read4(v_pages + ci * kD + lane * 4, QUANT ? v_sc[ci] : 0.f, vf);
    }
#pragma unroll
    for (int j = 0; j < kMaxG; ++j) {
      if (j >= g) break;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) s += qreg[j][i] * kf[i];
      s = warp_sum(s);
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
  for (int j = 0; j < kMaxG; ++j) {
    if (j >= g) break;
    if (lane == 0) {
      sh.red_m[warp][j] = m[j];
      sh.red_l[warp][j] = l[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sh.red_acc[warp][j][lane * 4 + i] = acc[j][i];
  }
  __syncthreads();

  if (tid < kD) {
    for (int j = 0; j < g; ++j) {
      float mt = kNegInf;
      for (int w = 0; w < kWalkWarps; ++w) mt = fmaxf(mt, sh.red_m[w][j]);
      float lt = 0.f, at = 0.f;
      for (int w = 0; w < kWalkWarps; ++w) {
        const float e = expf(sh.red_m[w][j] - mt);
        lt += sh.red_l[w][j] * e;
        at += sh.red_acc[w][j][tid] * e;
      }
      out[(size_t)j * kD + tid] = __float2bfloat16(at / fmaxf(lt, 1e-30f));
    }
  }
}

}  // namespace pt
