// The decode-row page walk shared by K3 (rope_append_attend.cu, decode
// form, with or without an `active` mask) and K10 (paged_attention.cu): the
// g <= 8 query heads of one kv head of one slot attend over the slot's
// first n cells, found through its block table, with an f32 online
// softmax; the g output rows are acc / max(l, 1e-30) in bf16 (zeros when
// n == 0). It computes what _paged_kernel (paged_attention.py) and
// _fused_kernel's decode use (fused_rope_attend.py) compute: the TPU
// kernels walk a slot's pages as the sequential grid axis, one page a
// step, with the softmax state in VMEM scratch.
//
// Bound on an H100 by bytes: every live cell's K and V are read once, 4 KB
// a page of 16 cells at bf16, against ~4 g D flops a cell. What held the
// earlier body back was latency: one block a (kv head, slot) (64 on 132 SMs
// at the serving shapes), its warps loading one cell at a time behind a
// dependent block-table read. So this body is built for memory-level
// parallelism, with the arithmetic kept to a few instructions a page:
//
// Split across a cluster. The walk of one (kv head, slot) runs on a
// cluster of cs CTAs (cluster_size, one rule for every form: the least cs
// in 1, 2, 4, 8 whose B x Hk x cs CTAs cover the SMs, and no more ranks
// than a slot has pages; paged_attention.walk_plan mirrors it). Rank r
// takes the contiguous whole pages np r / cs .. np (r + 1) / cs of the
// np = ceil(n / page) pages the slot's length n needs (range_of); n is
// read on the device, so the grid depends on shapes alone. At the end
// every rank leaves its partial (m, l, acc[g][128], f32) in its shared
// memory, and rank 0 merges them in rank order after one barrier.cluster,
// the other ranks having stored theirs into rank 0's shared memory
// (distributed shared memory): no workspace, no atomics, two calls give
// the same bits.
//
// Pages in flight. A CTA copies its slot's block-table row into shared
// memory (cp.async, overlapping the read of the length); then thread 0
// issues 1-D bulk copies (cp.async.bulk, completing on the stage's
// mbarrier) of whole pages into a ring of stages. A page of one (layer, kv
// head) is contiguous in the (L, Hk, P, page, D) pool: a stage holds its K
// and V (and on the int8 cache the page's K and V scales from the
// (L, Hk, P, page, 1) pools). The ring is ~48 KB (6 pages of 16 at bf16),
// and three CTAs fit an SM (80 registers), so every cluster of the grid is
// resident at once and a CTA's range is mostly in flight before its first
// page is scored.
//
// The arithmetic, on the tensor cores (mma.sync.m16n8k16, bf16 in, f32
// sums): the g <= 8 heads are the 16 MMA rows (rows g.. zero), so one
// kernel takes every group size. S = Q K^T: the query rows are bf16 values
// (K10's q, K3's rotated q), K is bf16 or int8 codes (exact in bf16), so
// every product is exact; S is then scaled (and multiplied by the cell's
// K scale on the int8 cache). n8 tiles of 8 cells go round the 8 warps,
// ldmatrix reading the K rows straight from the stage. P V: warp w owns
// output dims [16 w, 16 w + 16); P is split into bf16 hi + lo (two MMAs,
// ~2^-16 of p, so the sum keeps f32's accuracy to the bound the checks
// hold it to); int8 V scales fold into P. The pages go in chunks of half
// the ring: the chunk's scores page by page as each lands, then one max
// and one rescale a head for the chunk (warp j < g: max, exp, its lanes'
// shares of the sum), then P V; three __syncthreads a chunk, after which
// thread 0 refills the chunk's stages while the next chunk (already in
// flight) is computed. Rows past the walk's cells are zero in P and V. The
// query rows and K3's rows are loaded before the copies are issued, so
// they do not queue behind them.
//
// K3's own cell: the CTA whose range holds it has computed it into
// kself / vself (shared memory) and writes it into the landed stage over
// the pool's value, whose bulk read may race with K3's write of that cell.
#pragma once

#include <map>
#include <mutex>

#include "mma_sync.cuh"
#include "wgmma_tiles.cuh"

namespace pt {
namespace pw {
namespace {  // each including source gets its own copy

constexpr int kD = 128;
constexpr int kMaxG = 8;
constexpr int NT = 256;          // 8 warps
constexpr int MAX_CS = 8;        // the largest portable cluster
constexpr int MAX_STAGES = 16;
constexpr int RING_BYTES = 48 * 1024;

// ---- the plan (paged_attention.walk_plan / walk_items mirror it) -----------

// The one rule for every form: the least cluster size whose CTAs cover the
// SMs, never more ranks than pages a slot holds
__host__ __device__ inline int cluster_size(int B, int Hk, int pps, int sms) {
  int cs = 1;
  while (cs < MAX_CS && 2 * cs <= pps && B * Hk * cs < sms) cs *= 2;
  return cs;
}

// rank `rank` of cs's pages [lo, hi) of a walk over n cells
struct Range {
  int lo, hi;
};
__host__ __device__ inline Range range_of(int n, int page, int pps, int rank, int cs) {
  int np = (n + page - 1) / page;
  np = np < pps ? np : pps;
  return {np * rank / cs, np * (rank + 1) / cs};
}

// The CTA's place: grid (Hk * cs, B), cluster (cs, 1, 1)
struct Walk {
  int rank, kh, b, n;
  Range r;
  __device__ Walk(int n_, int page, int pps, int cs)
      : rank(blockIdx.x % cs), kh(blockIdx.x / cs), b(blockIdx.y), n(n_),
        r(range_of(n_, page, pps, blockIdx.x % cs, cs)) {}
};

// Dynamic shared memory, by byte offset: the ring of stages (K page | V
// page | K scales | V scales); the scores of a chunk of ch = stages / 2
// pages [ch * page][kMaxG] f32; the slot's block-table row (`table`); 16
// rows of slack (a 16-row MMA tile of a page's last rows may read past the
// ring, masked to zero); on rank 0, the other ranks' partials (`push`:
// cs - 1 slots of acc [g][kD], m [kMaxG], l [kMaxG]).
struct Geo {
  int kv_bytes, sc_bytes, stage_bytes, stages, ch, table, push, slot, smem;
  __host__ __device__ Geo(int page, int esz, int pps, int cs, int g) {
    kv_bytes = page * kD * esz;
    sc_bytes = esz == 1 ? page * 4 : 0;
    stage_bytes = 2 * (kv_bytes + sc_bytes);
    stages = RING_BYTES / stage_bytes;
    stages = stages < 2 ? 2 : stages > MAX_STAGES ? MAX_STAGES : stages;
    ch = stages / 2;
    table = stages * stage_bytes + ch * page * kMaxG * 4;
    push = table + (pps * 4 + 15) / 16 * 16 + 16 * kD * 2;
    slot = (g * kD + 2 * kMaxG) * 4;
    smem = push + (cs - 1) * slot;
  }
};

struct Shared {
  // rows 0..g: the query rows (bf16 values, read into registers first);
  // at the end this rank's partial acc
  alignas(16) float part[kMaxG][kD];
  float m[kMaxG], l[kMaxG];
  float corr[kMaxG];           // a chunk's rescale of each head
  float kself[kD], vself[kD];  // K3's own cell: values (bf16) or codes (int8)
  float self_sc[2];            // its K and V scales (int8)
  float red[2][kD / 32];
  uint64_t full[MAX_STAGES];
};

// Pool = bf16 (verbatim cache) or signed char (int8 codes; k_sc / v_sc the
// scale pools). K10 passes layer 0, its pools (Hk, P, page, D), and no
// k / v / cos / sin / active.
template <typename Pool>
struct Args {
  const bf16 *q, *k, *v;
  const float *cos, *sin;
  Pool *k_pages, *v_pages;
  float *k_sc, *v_sc;
  const int *block_tables, *seq_lens;
  const bool* active;
  bf16* out;
  int H, Hk, P, page, pps, layer, cs, stages;
  float scale;
};

// ---- the walk -----------------------------------------------------------------

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// two floats as a bf16x2 MMA operand register (first in the low half)
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
// two int8 codes (exact in bf16) as a bf16x2 MMA operand register
__device__ __forceinline__ unsigned codes2(const signed char* p, int stride) {
  return pack2((float)p[0], (float)p[stride]);
}
// kv_cache._quantize_cells, THE quantize-on-write rule, for one cell of
// absmax amax: its scale max(amax / 127, 1e-12) ...
__device__ __forceinline__ float cell_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
}
// ... and a value's code, clip(rint(x / scale), -127, 127): IEEE division,
// round half to even
__device__ __forceinline__ signed char quantize(float x, float scale) {
  return (signed char)fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f);
}
// the bf16 hi + lo split of a float: x ~ hi + lo to ~2^-16 of x
__device__ __forceinline__ void split2(float a, float b, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack2(a - hf.x, b - hf.y);
}

template <typename Pool>
__device__ __forceinline__ void issue(Shared& sh, unsigned char* dyn, const Args<Pool>& a,
                                      const Geo& geo, const int* bts, size_t plane, int i) {
  const int s = i % geo.stages;
  unsigned char* st = dyn + (size_t)s * geo.stage_bytes;
  const size_t cell = (plane + bts[i]) * a.page;
  wg::mbar_arrive_expect_tx(&sh.full[s], geo.stage_bytes);
  wg::bulk_load(st, a.k_pages + cell * kD, geo.kv_bytes, &sh.full[s]);
  wg::bulk_load(st + geo.kv_bytes, a.v_pages + cell * kD, geo.kv_bytes, &sh.full[s]);
  if (geo.sc_bytes) {
    wg::bulk_load(st + 2 * geo.kv_bytes, a.k_sc + cell, geo.sc_bytes, &sh.full[s]);
    wg::bulk_load(st + 2 * geo.kv_bytes + geo.sc_bytes, a.v_sc + cell, geo.sc_bytes, &sh.full[s]);
  }
}

// Start the copy of slot b's block-table row into shared memory (before
// the slot's length is read: the two loads overlap). Every thread of the
// block calls it first.
template <typename Pool>
__device__ void prefetch_table(unsigned char* dyn, const Args<Pool>& a, int b) {
  const Geo geo(a.page, sizeof(Pool), a.pps, a.cs, a.H / a.Hk);
  int* row = reinterpret_cast<int*>(dyn + geo.table);
  for (int i = threadIdx.x; i < a.pps; i += NT)
    cp_async4(row + i, a.block_tables + (size_t)b * a.pps + i, true);
  cp_async_commit();
}

// Set up the ring and put the CTA's first pages in flight, once the
// block-table row has landed. Every thread of the block calls it.
template <typename Pool>
__device__ void begin(Shared& sh, unsigned char* dyn, const Args<Pool>& a, const Walk& w,
                      size_t plane) {
  const Geo geo(a.page, sizeof(Pool), a.pps, a.cs, a.H / a.Hk);
  const int* bts = reinterpret_cast<const int*>(dyn + geo.table) + w.r.lo;
  const int np = w.r.hi - w.r.lo;
  cp_async_wait<0>();
  if (threadIdx.x == 0) {
    for (int s = 0; s < geo.stages; ++s) wg::mbar_init(&sh.full[s], 1);
    wg::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < np && i < geo.stages; ++i) issue(sh, dyn, a, geo, bts, plane, i);
}

// Attend the query rows in sh.part[0..g) over the CTA's pages (after begin,
// with the rows written and synchronised) and leave the partial in
// sh.part[0..g) / sh.m / sh.l. The cell self_off of the CTA's range (-1:
// none) is K3's own cell: it is written into its landed stage from
// sh.kself / vself before any warp reads that stage.
template <typename Pool>
__device__ void attend(Shared& sh, unsigned char* dyn, const Args<Pool>& a, const Walk& w,
                       size_t plane, int g, int self_off) {
  constexpr bool QUANT = sizeof(Pool) == 1;
  const Geo geo(a.page, sizeof(Pool), a.pps, a.cs, a.H / a.Hk);
  const int page = a.page, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;  // MMA fragment row (head) and column pair
  float* sc = reinterpret_cast<float*>(dyn + geo.stages * geo.stage_bytes);
  const int* bts = reinterpret_cast<const int*>(dyn + geo.table) + w.r.lo;

  // the query rows as the A operand of S = Q K^T, 8 k16 steps (rows 8..15
  // are padding, zero)
  unsigned qa[8][2];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float* q = sh.part[gr] + 16 * k + 2 * tq;
    qa[k][0] = gr < g ? pack2(q[0], q[1]) : 0u;
    qa[k][1] = gr < g ? pack2(q[8], q[9]) : 0u;
  }
  // softmax warp `warp` < g: its head's running max, and this lane's share
  // of the running sum
  float m = kNegInf, l = 0.f;
  // O (16 x 128) = P V: this warp's dims [16 warp, 16 warp + 16), two n8 tiles
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  const int np = w.r.hi - w.r.lo;
  for (int p0 = 0; p0 < np; p0 += geo.ch) {
    const int p1 = min(np, p0 + geo.ch);
    const int cnt = min((p1 - p0) * page, w.n - (w.r.lo + p0) * page);  // the chunk's cells

    // the chunk's scores, page by page as the pages land; n8 tile t of the
    // chunk (8 rows of one page) goes to warp t % 8
    for (int pi = p0, cb = 0, tile = 0; pi < p1; ++pi, cb += page) {
      const int si = pi % geo.stages, pc = min(page, cnt - cb);
      wg::mbar_wait(&sh.full[si], (pi / geo.stages) & 1);
      unsigned char* st = dyn + (size_t)si * geo.stage_bytes;
      const Pool* kp = reinterpret_cast<const Pool*>(st);
      const float* ksc = reinterpret_cast<const float*>(st + 2 * geo.kv_bytes);
      if (self_off >= 0 && self_off / page == pi) {  // the same in the whole block
        const int r = self_off % page;
        Pool* kr = reinterpret_cast<Pool*>(st) + r * kD;
        Pool* vr = reinterpret_cast<Pool*>(st + geo.kv_bytes) + r * kD;
        if (tid < kD) {
          if constexpr (QUANT) {
            kr[tid] = (signed char)sh.kself[tid];
            vr[tid] = (signed char)sh.vself[tid];
            if (tid == 0) {
              reinterpret_cast<float*>(st + 2 * geo.kv_bytes)[r] = sh.self_sc[0];
              reinterpret_cast<float*>(st + 2 * geo.kv_bytes + geo.sc_bytes)[r] = sh.self_sc[1];
            }
          } else {
            kr[tid] = __float2bfloat16(sh.kself[tid]);
            vr[tid] = __float2bfloat16(sh.vself[tid]);
          }
        }
        wg::fence_proxy_async();  // before a later bulk copy rewrites the stage
        __syncthreads();
      }
      for (int r0 = 0; r0 < pc; r0 += 8, ++tile) {
        if (tile % (NT / 32) != warp) continue;
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (QUANT) {
          const signed char* kr = kp + (r0 + gr) * kD + 2 * tq;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const unsigned qk[4] = {qa[k][0], 0u, qa[k][1], 0u};
            mma16816(s, qk, codes2(kr + 16 * k, 1), codes2(kr + 16 * k + 8, 1));
          }
        } else {
#pragma unroll
          for (int k = 0; k < 8; k += 2) {
            unsigned b[4];
            ldsm4(b, kp + (r0 + lane % 8) * kD + 16 * k + (lane / 8) * 8);
            const unsigned q0[4] = {qa[k][0], 0u, qa[k][1], 0u};
            const unsigned q1[4] = {qa[k + 1][0], 0u, qa[k + 1][1], 0u};
            mma16816(s, q0, b[0], b[1]);
            mma16816(s, q1, b[2], b[3]);
          }
        }
        // s[0], s[1]: head gr, rows r0 + 2 tq and + 1 of the page
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = r0 + 2 * tq + e;
          if (gr < g && r < pc)
            sc[(cb + r) * kMaxG + gr] = s[e] * a.scale * (QUANT ? ksc[r] : 1.f);
        }
      }
    }
    __syncthreads();

    // one max and one rescale a head for the chunk: the scores become
    // probabilities
    if (warp < g) {
      float pm = kNegInf;
      for (int c = lane; c < cnt; c += 32) pm = fmaxf(pm, sc[c * kMaxG + warp]);
      const float mn = fmaxf(m, warp_max(pm)), corr = expf(m - mn);
      l *= corr;
      for (int c = lane; c < cnt; c += 32) {
        const float p = expf(sc[c * kMaxG + warp] - mn);
        sc[c * kMaxG + warp] = p;
        l += p;
      }
      m = mn;
      if (lane == 0) sh.corr[warp] = corr;
    }
    __syncthreads();

    // O += P V, page by page in k16 tiles of 16 rows (rows past the chunk's
    // cells are zero in P and in V)
    const float corr = gr < g ? sh.corr[gr] : 1.f;
#pragma unroll
    for (int n = 0; n < 2; ++n) acc[n][0] *= corr, acc[n][1] *= corr;
    for (int pi = p0, cb = 0; pi < p1; ++pi, cb += page) {
      const int pc = min(page, cnt - cb);
      const unsigned char* st = dyn + (size_t)(pi % geo.stages) * geo.stage_bytes;
      const Pool* vp = reinterpret_cast<const Pool*>(st + geo.kv_bytes);
      const float* vsc = reinterpret_cast<const float*>(st + 2 * geo.kv_bytes + geo.sc_bytes);
      for (int r0 = 0; r0 < pc; r0 += 16) {
        // P rows gr, columns r0 + 2 tq (+1) and + 8 (+9); int8: p * the cell's V scale
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + 2 * tq + (e & 1) + (e >> 1) * 8;
          p[e] = gr < g && r < pc ? sc[(cb + r) * kMaxG + gr] * (QUANT ? vsc[r] : 1.f) : 0.f;
        }
        unsigned ph[4] = {0u, 0u, 0u, 0u}, pl[4] = {0u, 0u, 0u, 0u};
        split2(p[0], p[1], ph[0], pl[0]);
        split2(p[2], p[3], ph[2], pl[2]);
        unsigned b[2][2];
        if constexpr (QUANT) {
          // B[k = row][n = dim]: rows r0 + 2 tq (+1), + 8 (+9); dim gr of each tile
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const signed char* vc = vp + (r0 + 2 * tq) * kD + 16 * warp + 8 * n + gr;
            b[n][0] = codes2(vc, kD);
            b[n][1] = codes2(vc + 8 * kD, kD);
          }
        } else {
          unsigned r[4];
          ldsm4_t(r, vp + (r0 + lane % 16) * kD + 16 * warp + (lane / 16) * 8);
          b[0][0] = r[0], b[0][1] = r[1], b[1][0] = r[2], b[1][1] = r[3];
        }
        // zero the rows past the cells (the stage may hold anything there)
        const int rb = r0 + 2 * tq;
        const unsigned m0 = (rb < pc ? 0xffffu : 0u) | (rb + 1 < pc ? 0xffff0000u : 0u);
        const unsigned m1 = (rb + 8 < pc ? 0xffffu : 0u) | (rb + 9 < pc ? 0xffff0000u : 0u);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          b[n][0] &= m0;
          b[n][1] &= m1;
          mma16816(acc[n], ph, b[n][0], b[n][1]);
          mma16816(acc[n], pl, b[n][0], b[n][1]);
        }
      }
    }
    __syncthreads();  // the chunk's stages and the scores are free
    if (tid == 0)
      for (int i = p0 + geo.stages; i < p1 + geo.stages && i < np; ++i)
        issue(sh, dyn, a, geo, bts, plane, i);
  }

  // this rank's partial
  if (warp < g) {
    l = warp_sum(l);
    if (lane == 0) sh.m[warp] = m, sh.l[warp] = l;
  }
  __syncthreads();  // every warp is past its query rows (a rank with no pages)
  if (gr < g)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float* o = sh.part[gr] + 16 * warp + 8 * n + 2 * tq;
      o[0] = acc[n][0];
      o[1] = acc[n][1];
    }
}

// Rank 0 merges the cluster's partials in rank order and writes the g
// output rows at out (row j at out + j * kD): the other ranks store theirs
// into rank 0's shared memory (`push` slots) before one barrier.cluster,
// then exit; rank 0 reads them locally. Every thread of the cluster calls
// it, after attend.
template <typename Pool>
__device__ void merge(Shared& sh, unsigned char* dyn, const Args<Pool>& a, const Walk& w,
                      int g, bf16* out) {
  const Geo geo(a.page, sizeof(Pool), a.pps, a.cs, g);
  __syncthreads();  // this rank's partial is in sh
  if (w.rank > 0) {
    float* slot = reinterpret_cast<float*>(dyn + geo.push + (w.rank - 1) * geo.slot);
    for (int idx = threadIdx.x; idx < g * kD / 4; idx += NT) {
      const int j = idx / (kD / 4), d = 4 * (idx % (kD / 4));
      wg::st_rank_f4(slot + j * kD + d, 0, *reinterpret_cast<const float4*>(&sh.part[j][d]));
    }
    if (threadIdx.x < g) {
      wg::st_rank_f32(slot + g * kD + threadIdx.x, 0, sh.m[threadIdx.x]);
      wg::st_rank_f32(slot + g * kD + kMaxG + threadIdx.x, 0, sh.l[threadIdx.x]);
    }
  }
  wg::cluster_sync();  // every rank's partial is in rank 0's shared memory
  if (w.rank > 0) return;
  const int cs = a.cs;
  for (int idx = threadIdx.x; idx < g * kD / 4; idx += NT) {
    const int j = idx / (kD / 4), d = 4 * (idx % (kD / 4));
    float mr[MAX_CS], lr[MAX_CS], mt = kNegInf;
    float4 ar[MAX_CS];
#pragma unroll
    for (int r = 0; r < MAX_CS; ++r) {
      if (r < cs) {
        const float* src =
            reinterpret_cast<const float*>(dyn + geo.push + (r > 0 ? r - 1 : 0) * geo.slot);
        mr[r] = r == 0 ? sh.m[j] : src[g * kD + j];
        lr[r] = r == 0 ? sh.l[j] : src[g * kD + kMaxG + j];
        ar[r] = *reinterpret_cast<const float4*>(r == 0 ? &sh.part[j][d] : src + j * kD + d);
        mt = fmaxf(mt, mr[r]);
      }
    }
    float lt = 0.f, at[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < MAX_CS; ++r) {
      if (r < cs) {
        const float e = expf(mr[r] - mt);
        lt += lr[r] * e;
        at[0] += ar[r].x * e, at[1] += ar[r].y * e, at[2] += ar[r].z * e, at[3] += ar[r].w * e;
      }
    }
    lt = fmaxf(lt, 1e-30f);
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + (size_t)j * kD + d);
    o[0] = __floats2bfloat162_rn(at[0] / lt, at[1] / lt);
    o[1] = __floats2bfloat162_rn(at[2] / lt, at[3] / lt);
  }
}

// g zero rows at out (a walk of length 0), written by rank 0 alone, once
// the block-table copy has landed (nothing may write the CTA's shared
// memory after it exits)
__device__ __forceinline__ void zeros(const Walk& w, int g, bf16* out) {
  cp_async_wait<0>();
  if (w.rank == 0)
    for (int idx = threadIdx.x; idx < g * kD; idx += NT) out[idx] = __float2bfloat16(0.f);
}

// The walk as the CTAs decode it: row (b * Hk + kh) * cs + rank of out
// (3 ints a row) = (rank, first page, end page) of a walk over lens[b]
__global__ void items_kernel(const int* lens, int Hk, int page, int pps, int cs, int* out) {
  const Walk w(lens[blockIdx.y], page, pps, cs);
  if (threadIdx.x == 0) {
    int* o = out + 3 * (((size_t)w.b * Hk + w.kh) * cs + w.rank);
    o[0] = w.rank, o[1] = w.r.lo, o[2] = w.r.hi;
  }
}

// ---- host side ----------------------------------------------------------------

inline int sms() {
  static const int n = wg::num_sms();
  return n;
}

// Raise kernel fn's dynamic shared memory limit to smem (once per kernel
// and size), with the most shared memory an SM can give, so that several
// CTAs of a cluster grid are resident on each SM
inline cudaError_t allow_smem(const void* fn, int smem) {
  static std::mutex mu;
  static std::map<const void*, int> allowed;
  std::lock_guard<std::mutex> lock(mu);
  auto it = allowed.find(fn);
  if (it == allowed.end()) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    it = allowed.emplace(fn, 0).first;
  }
  if (smem > it->second) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    it->second = smem;
  }
  return cudaSuccess;
}

// The launch of `grid` in clusters of cs along x with `threads` threads
// and `smem` bytes of dynamic shared memory; `cluster` holds its attribute
inline cudaLaunchConfig_t cluster_config(dim3 grid, int cs, int threads, int smem,
                                         cudaStream_t stream, cudaLaunchAttribute* cluster) {
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = cs;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch kern on `grid` in clusters of cs along x with `threads` threads
// and `smem` bytes of dynamic shared memory
template <typename... T>
cudaError_t launch_clusters(void (*kern)(T...), dim3 grid, int cs, int threads, int smem,
                            cudaStream_t stream, T... args) {
  const void* fn = reinterpret_cast<const void*>(kern);
  const cudaError_t set = allow_smem(fn, smem);
  if (set != cudaSuccess) return set;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = cluster_config(grid, cs, threads, smem, stream, &cluster);
  void* argv[] = {&args...};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, fn, argv);
  const cudaError_t last = cudaGetLastError();  // cleared either way
  return err != cudaSuccess ? err : last;
}

// Launch a walk kernel (K10's or K3's) for B slots on the plan's grid
template <typename Pool>
cudaError_t launch(void (*kern)(Args<Pool>), Args<Pool> a, int B, cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  a.cs = cluster_size(B, a.Hk, a.pps, sms());
  const Geo geo(a.page, sizeof(Pool), a.pps, a.cs, a.H / a.Hk);
  a.stages = geo.stages;
  return launch_clusters(kern, dim3(a.Hk * a.cs, B), a.cs, NT, geo.smem, stream, a);
}

// The plan's items for walks over lens (B,) into out (B * Hk * cs rows of 3)
inline cudaError_t items(const int* lens, int B, int Hk, int page, int pps, int* out,
                         cudaStream_t stream) {
  const int cs = cluster_size(B, Hk, pps, sms());
  return launch_clusters(items_kernel, dim3(Hk * cs, B), cs, 32, 0, stream, lens, Hk, page, pps,
                         cs, out);
}

}  // namespace
}  // namespace pw
}  // namespace pt
