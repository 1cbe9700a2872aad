// K3 rope_append_attend: rope on q/k, in-place append of (k, v) into the
// paged pool, attention over the pages including the new cells — per
// layer, in one launch. Two entry forms.
//
// Replaces paddle_tpu/ops/pallas/fused_rope_attend.py:_pallas_fused
// (_fused_kernel) in both of the forms that drive it. The TPU kernel writes
// the pool through aliased outputs; here the blocks store the new cells
// straight into the pool tensors.
//
// Decode form (fused_rope_append_attend_decode): one token per slot, an
// optional `active` mask, on paged_walk.cuh's cluster-split walk: the walk
// of each (kv head, slot) over its n = seq_lens[b] + 1 cells (0 for an
// inactive slot) is split in whole pages across a cluster of CTAs, and
// rank 0 merges the ranks' partials. In each CTA:
//   0. an inactive slot: the whole cluster returns; rank 0 writes zeros,
//      nothing is written to the pool;
//   1. threads d = 0..127 rotate the slot's g query rows in f32 at position
//      pos = seq_lens[b] (apply_rotary_rows: x*cos + rotate_half(x)*sin
//      with separately rounded products, cast to bf16); the scores are
//      (bf16 q . k) * scale in f32 (the TPU kernel's q load, bf16 then
//      f32 * scale, up to rounding);
//   2. the CTA whose page range holds pos (and no other) rotates the k row
//      the same way and stores the rotated k and the raw v in page
//      block_tables[b, pos / page], cell pos % page (logical page clamped
//      like append_token_masked), and keeps that cell in shared memory;
//   3. the page walk over its range, where the cell at pos is written
//      from shared memory into the landed copy of its page, never read
//      from the pool (the TPU kernel's in-register self-cell patch): the
//      range's bulk copy of that page may race with step 2's write.
// Cells past seq_lens[b] + 1 are neither read nor written.
//
// On an int8 cache (pt_rope_append_attend_decode_int8) the pools hold
// symmetric-absmax codes with one f32 scale per (head, token) cell
// (L, Hk, P, page, 1). Step 2 quantizes the rotated k row (already rounded
// to bf16) and the raw v row as kv_cache._quantize_cells does: scale =
// max(max|x| / 127, 1e-12), code = clip(rint(x / scale), -127, 127), IEEE
// division and round-half-even, and stores codes and scales in place. Step
// 3 reads every page cell as code * scale, and the new cell as its own
// codes and scale (the TPU kernel's quantize -> dequantize self-cell
// patch), never as the unquantized row. The scale pools ride the same bulk
// copies (page * 4 bytes each: page % 4 == 0).
//
// Ragged form (fused_rope_append_attend, pt_rope_append_attend_ragged and,
// on an int8 cache, pt_rope_append_attend_ragged_int8): the continuous
// batcher's admission wave and the speculative verify wave —
// ragged_walk.cuh with FUSED set, which also writes down why one launch
// may write and read the pool, how the int8 form quantizes its written
// cells and reads its pages, and how a fresh_pool_read slot (a verify
// segment: the TPU kernel's static `spec` variant, selected per slot by
// fq_ref[b]) reads its own rows as the pool holds them.
//
// Bound on an H100: bytes — each step reads every live cell's K and V once
// (2 * len * Hk * D * 2 bytes per slot; 2 * len * Hk * (D + 4) on an int8
// cache) and does ~4*g*D flops per cell.
#include "paged_walk.cuh"
#include "ragged_walk.cuh"

using pt::bf16;
using pt::pw::kD;

namespace {

constexpr int HALF = kD / 2;

// max over the D = 128 values held by threads 0..127 (4 warps); every
// thread of the block must call it
__device__ __forceinline__ float absmax_d(float x, float* red) {
  const int tid = threadIdx.x, warp = tid / 32;
  float m = tid < kD ? fabsf(x) : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (tid % 32 == 0 && warp < kD / 32) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < kD / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

// Pool = bf16 (verbatim cache) or signed char (int8 codes; k_sc/v_sc are
// the scale pools, else unused); active == nullptr: every slot active
template <typename Pool>
__global__ void __launch_bounds__(pt::pw::NT, 3) rope_append_attend_kernel(const pt::pw::Args<Pool> a) {
  constexpr bool QUANT = sizeof(Pool) == 1;
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ pt::pw::Shared sh;

  // every load that needs no length, issued first and together: the
  // block-table row (cp.async), q, cos/sin, k and v at dims d and pd (k
  // and v are used only by the CTA that owns the new cell), the slot's
  // length and active flag
  const int b = blockIdx.y, kh = blockIdx.x / a.cs, g = a.H / a.Hk, tid = threadIdx.x;
  pt::pw::prefetch_table(dyn, a, b);
  const int d = tid % kD, pd = d < HALF ? d + HALF : d - HALF;
  float qd[pt::pw::kMaxG], qp[pt::pw::kMaxG];
#pragma unroll
  for (int j = 0; j < pt::pw::kMaxG; ++j) {
    const bf16* qr = a.q + ((size_t)b * a.H + kh * g + (j < g ? j : 0)) * kD;
    qd[j] = __bfloat162float(qr[d]);
    qp[j] = __bfloat162float(qr[pd]);
  }
  const float c = a.cos[(size_t)b * kD + d], s = a.sin[(size_t)b * kD + d];
  const bf16* kr = a.k + ((size_t)b * a.Hk + kh) * kD;
  const float kd = __bfloat162float(kr[d]), kp = __bfloat162float(kr[pd]);
  const float vd = __bfloat162float(a.v[((size_t)b * a.Hk + kh) * kD + d]);
  const bool on = a.active == nullptr || a.active[b];
  const int sl = a.seq_lens[b];

  const int pos = on ? sl : -1;
  const pt::pw::Walk w(pos + 1, a.page, a.pps, a.cs);
  bf16* out_b = a.out + ((size_t)b * a.H + kh * g) * kD;
  if (w.n == 0) return pt::pw::zeros(w, g, out_b);  // the whole cluster returns
  const int self_page = min(pos / a.page, a.pps - 1);
  const bool mine = self_page >= w.r.lo && self_page < w.r.hi;  // the same in the whole block
  const size_t plane = ((size_t)a.layer * a.Hk + w.kh) * a.P;
  pt::pw::begin(sh, dyn, a, w, plane);

  if (mine) {
    // the new cell: rotated k (rounded to bf16) and raw v, in f32
    const size_t self_cell =
        (plane + a.block_tables[(size_t)b * a.pps + self_page]) * a.page + pos % a.page;
    const float kn =
        tid < kD ? __bfloat162float(__float2bfloat16(pt::rw::rope(kd, kp, d, c, s))) : 0.f;
    const float vn = tid < kD ? vd : 0.f;
    if constexpr (QUANT) {
      const float kmax = absmax_d(kn, sh.red[0]), vmax = absmax_d(vn, sh.red[1]);
      if (tid < kD) {
        const float ks = pt::pw::cell_scale(kmax), vs = pt::pw::cell_scale(vmax);
        const signed char kq = pt::pw::quantize(kn, ks), vq = pt::pw::quantize(vn, vs);
        a.k_pages[self_cell * kD + tid] = kq;
        a.v_pages[self_cell * kD + tid] = vq;
        if (tid == 0) {
          a.k_sc[self_cell] = ks;
          a.v_sc[self_cell] = vs;
          sh.self_sc[0] = ks;
          sh.self_sc[1] = vs;
        }
        sh.kself[tid] = kq;
        sh.vself[tid] = vq;
      }
    } else if (tid < kD) {
      a.k_pages[self_cell * kD + tid] = __float2bfloat16(kn);
      a.v_pages[self_cell * kD + tid] = __float2bfloat16(vn);
      sh.kself[tid] = kn;
      sh.vself[tid] = vn;
    }
  }
  if (tid < kD) {
#pragma unroll
    for (int j = 0; j < pt::pw::kMaxG; ++j)
      if (j < g)
        sh.part[j][d] = __bfloat162float(__float2bfloat16(pt::rw::rope(qd[j], qp[j], d, c, s)));
  }
  __syncthreads();
  pt::pw::attend(sh, dyn, a, w, plane, g,
                 mine ? (self_page - w.r.lo) * a.page + pos % a.page : -1);
  pt::pw::merge(sh, dyn, a, w, g, out_b);
}

template <typename Pool>
int launch_decode(const void* q, const void* k, const void* v, const void* cos_t,
                  const void* sin_t, void* k_pages, void* v_pages, void* k_scales, void* v_scales,
                  const void* block_tables, const void* seq_lens, const void* active, void* out,
                  int B, int H, int Hk, int P, int page, int pps, int layer, float scale,
                  void* stream) {
  pt::pw::Args<Pool> a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.cos = static_cast<const float*>(cos_t);
  a.sin = static_cast<const float*>(sin_t);
  a.k_pages = static_cast<Pool*>(k_pages);
  a.v_pages = static_cast<Pool*>(v_pages);
  a.k_sc = static_cast<float*>(k_scales);
  a.v_sc = static_cast<float*>(v_scales);
  a.block_tables = static_cast<const int*>(block_tables);
  a.seq_lens = static_cast<const int*>(seq_lens);
  a.active = static_cast<const bool*>(active);
  a.out = static_cast<bf16*>(out);
  a.H = H;
  a.Hk = Hk;
  a.P = P;
  a.page = page;
  a.pps = pps;
  a.layer = layer;
  a.scale = scale;
  return pt::pw::launch(rope_append_attend_kernel<Pool>, a, B,
                        static_cast<cudaStream_t>(stream));
}

template <typename Pool>
int launch_ragged(const void* q, const void* k, const void* v, const void* cos_t,
                  const void* sin_t, void* k_pages, void* v_pages, void* k_scales, void* v_scales,
                  const void* block_tables, const void* row_pos, const void* page_lens,
                  const void* q_start, const void* q_lens, const void* fresh_lens,
                  const void* fresh_pool_read, void* out, int T, int B, int H, int Hk, int P,
                  int page, int pps, int layer, float scale,
                  void* stream) {
  pt::rw::Args<Pool> a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.cos = static_cast<const float*>(cos_t);
  a.sin = static_cast<const float*>(sin_t);
  a.k_pages = static_cast<Pool*>(k_pages);
  a.v_pages = static_cast<Pool*>(v_pages);
  a.k_sc = static_cast<float*>(k_scales);
  a.v_sc = static_cast<float*>(v_scales);
  a.block_tables = static_cast<const int*>(block_tables);
  a.row_pos = static_cast<const int*>(row_pos);
  a.page_lens = static_cast<const int*>(page_lens);
  a.q_start = static_cast<const int*>(q_start);
  a.q_lens = static_cast<const int*>(q_lens);
  a.fresh_lens = static_cast<const int*>(fresh_lens);
  a.fresh_pool_read = static_cast<const bool*>(fresh_pool_read);
  a.out = static_cast<bf16*>(out);
  a.T = T;
  a.B = B;
  a.H = H;
  a.Hk = Hk;
  a.P = P;
  a.page = page;
  a.pps = pps;
  a.layer = layer;
  a.scale = scale;
  return pt::rw::launch<true>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// q (B, H, D), k/v (B, Hk, D) bf16; cos/sin (B, D) f32 at each slot's
// position; k_pages/v_pages (L, Hk, P, page, D) bf16, written in place;
// block_tables (B, pps) int32; seq_lens (B,) int32; active (B,) bool or
// null; out (B, H, D) bf16. Every pointer 16-byte aligned.
PT_EXPORT int pt_rope_append_attend_decode(const void* q, const void* k, const void* v,
                                           const void* cos_t, const void* sin_t, void* k_pages,
                                           void* v_pages, const void* block_tables,
                                           const void* seq_lens, const void* active, void* out,
                                           int B, int H, int Hk, int P, int page, int pps,
                                           int layer, float scale, void* stream) {
  return launch_decode<bf16>(q, k, v, cos_t, sin_t, k_pages, v_pages, nullptr, nullptr,
                             block_tables, seq_lens, active, out, B, H, Hk, P, page, pps, layer,
                             scale, stream);
}

// The same over an int8 cache: k_pages/v_pages (L, Hk, P, page, D) int8
// codes and k_scales/v_scales (L, Hk, P, page, 1) f32, all written in
// place; page % 4 == 0 (a page's scales are a bulk copy of whole 16 bytes).
PT_EXPORT int pt_rope_append_attend_decode_int8(
    const void* q, const void* k, const void* v, const void* cos_t, const void* sin_t,
    void* k_pages, void* v_pages, void* k_scales, void* v_scales, const void* block_tables,
    const void* seq_lens, const void* active, void* out, int B, int H, int Hk, int P, int page,
    int pps, int layer, float scale, void* stream) {
  return launch_decode<signed char>(q, k, v, cos_t, sin_t, k_pages, v_pages, k_scales, v_scales,
                                    block_tables, seq_lens, active, out, B, H, Hk, P, page, pps,
                                    layer, scale, stream);
}

// The ragged form: q (T, H, D), k/v (T, Hk, D) bf16 unrotated; cos/sin
// (T, D) f32 at each row's position row_pos (T,) int32; k_pages/v_pages
// (L, Hk, P, page, D) bf16, written in place; block_tables (B, pps),
// page_lens/q_start/q_lens/fresh_lens (B,) int32; fresh_pool_read (B,)
// bool or null: the slots whose fresh rows are read as the pool holds them
// (on a bf16 pool the rotated k already is: no bit changes); out (T, H, D)
// bf16, every row written (rows of no segment as zeros).
PT_EXPORT int pt_rope_append_attend_ragged(
    const void* q, const void* k, const void* v, const void* cos_t, const void* sin_t,
    void* k_pages, void* v_pages, const void* block_tables, const void* row_pos,
    const void* page_lens, const void* q_start, const void* q_lens, const void* fresh_lens,
    const void* fresh_pool_read, void* out, int T, int B, int H, int Hk, int P, int page,
    int pps, int layer, float scale, void* stream) {
  return launch_ragged<bf16>(q, k, v, cos_t, sin_t, k_pages, v_pages, nullptr, nullptr,
                             block_tables, row_pos, page_lens, q_start, q_lens, fresh_lens,
                             fresh_pool_read, out, T, B, H, Hk, P, page, pps, layer, scale,
                             stream);
}

// The same over an int8 cache: k_pages/v_pages (L, Hk, P, page, D) int8
// codes and k_scales/v_scales (L, Hk, P, page, 1) f32, all written in
// place; page % 4 == 0 (a page's scales are copied in 16-byte pieces); a
// flagged slot's fresh rows are quantized in shared memory as its cells
// are, and read as code * scale.
PT_EXPORT int pt_rope_append_attend_ragged_int8(
    const void* q, const void* k, const void* v, const void* cos_t, const void* sin_t,
    void* k_pages, void* v_pages, void* k_scales, void* v_scales, const void* block_tables,
    const void* row_pos, const void* page_lens, const void* q_start, const void* q_lens,
    const void* fresh_lens, const void* fresh_pool_read, void* out, int T, int B, int H, int Hk,
    int P, int page, int pps, int layer, float scale, void* stream) {
  return launch_ragged<signed char>(q, k, v, cos_t, sin_t, k_pages, v_pages, k_scales, v_scales,
                                    block_tables, row_pos, page_lens, q_start, q_lens, fresh_lens,
                                    fresh_pool_read, out, T, B, H, Hk, P, page, pps, layer,
                                    scale, stream);
}

// The ragged form's plan at a wave's shapes, into host memory out[4] (as
// pt_ragged_paged_attention_plan); int8: on an int8 cache.
PT_EXPORT int pt_rope_append_attend_ragged_plan(int T, int B, int H, int Hk, int page, int pps,
                                                void* out) {
  return pt::rw::describe<true, bf16>(T, B, H, Hk, page, pps, static_cast<int*>(out));
}
PT_EXPORT int pt_rope_append_attend_ragged_int8_plan(int T, int B, int H, int Hk, int page,
                                                     int pps, void* out) {
  return pt::rw::describe<true, signed char>(T, B, H, Hk, page, pps, static_cast<int*>(out));
}
