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
// optional `active` mask. One block per (kv head, slot):
//   0. an inactive slot writes nothing and returns zeros;
//   1. threads d = 0..127 rotate the slot's k row and its g query rows in
//      f32 at position seq_lens[b] (apply_rotary_rows: x*cos +
//      rotate_half(x)*sin with separately rounded products, cast to bf16);
//   2. the rotated k and the raw v land in page block_tables[b, pos/page],
//      cell pos % page (logical page clamped like append_token_masked);
//   3. the page walk of paged_walk.cuh over the seq_lens[b] + 1 cells, q
//      double-cast (bf16 then f32 * scale, as the TPU kernel's q load); the
//      just-written cell is read from shared memory, not from the pool (the
//      TPU kernel's in-register self-cell patch).
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
// Ragged form (fused_rope_append_attend, pt_rope_append_attend_ragged):
// the continuous batcher's admission wave — ragged_attend.cuh with FUSED
// set, which also writes down why one launch may write and read the pool.
// bf16 pools only.
//
// Bound on an H100: bytes — each step reads every live cell's K and V once
// (2 * len * Hk * D * 2 bytes per slot; 2 * len * Hk * (D + 4) on an int8
// cache) and does ~4*g*D flops per cell. The decode form reads 8 bytes (4
// on an int8 cache) per lane per cell and has B*Hk blocks, which is fewer
// than the 132 SMs at B = 8, Hk = 8; splitting the page walk across blocks
// is a later PR's work.
#include "paged_walk.cuh"
#include "ragged_attend.cuh"

using pt::bf16;
using pt::kD;

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

// kv_cache._quantize_cells for one value of a cell with absmax `amax`:
// (code, scale), scale = max(amax / 127, 1e-12), code = clip(rint(x / scale))
__device__ __forceinline__ signed char quantize(float x, float amax, float* scale) {
  *scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
  return (signed char)fminf(fmaxf(rintf(__fdiv_rn(x, *scale)), -127.f), 127.f);
}

// Pool = bf16 (verbatim cache) or signed char (int8 codes; k_sc/v_sc are
// the scale pools, else unused); active == nullptr: every slot active
template <typename Pool>
__global__ void __launch_bounds__(pt::kWalkThreads)
rope_append_attend_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ cos_t,
                          const float* __restrict__ sin_t, Pool* __restrict__ k_pages,
                          Pool* __restrict__ v_pages, float* __restrict__ k_sc,
                          float* __restrict__ v_sc, const int* __restrict__ block_tables,
                          const int* __restrict__ seq_lens, const bool* __restrict__ active,
                          bf16* __restrict__ out, int H, int Hk, int P, int page, int pps,
                          int layer, float scale) {
  constexpr bool QUANT = sizeof(Pool) == 1;
  __shared__ pt::WalkShared sh;
  __shared__ float red_k[kD / 32], red_v[kD / 32];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int g = H / Hk;
  const int tid = threadIdx.x;
  bf16* out_b = out + ((size_t)b * H + kh * g) * kD;
  if (active != nullptr && !active[b]) {
    if (tid < kD)
      for (int j = 0; j < g; ++j) out_b[(size_t)j * kD + tid] = __float2bfloat16(0.f);
    return;
  }
  const int pos = seq_lens[b];
  const int* bt = block_tables + (size_t)b * pps;
  const size_t plane = ((size_t)layer * Hk + kh) * P;
  const size_t self_cell = (plane + bt[min(pos / page, pps - 1)]) * page + pos % page;

  // the new cell: rotated k (rounded to bf16) and raw v, in f32
  float kn = 0.f, vn = 0.f;
  if (tid < kD) {
    const int d = tid, pd = d < HALF ? d + HALF : d - HALF;
    const float c = cos_t[(size_t)b * kD + d], s = sin_t[(size_t)b * kD + d];
    const bf16* kr = k + ((size_t)b * Hk + kh) * kD;
    kn = __bfloat162float(__float2bfloat16(
        pt::ragged::rope(__bfloat162float(kr[d]), __bfloat162float(kr[pd]), d, c, s)));
    vn = __bfloat162float(v[((size_t)b * Hk + kh) * kD + d]);
  }
  if constexpr (QUANT) {
    const float kmax = absmax_d(kn, red_k), vmax = absmax_d(vn, red_v);
    if (tid < kD) {
      float ks, vs;
      const signed char kq = quantize(kn, kmax, &ks), vq = quantize(vn, vmax, &vs);
      k_pages[self_cell * kD + tid] = kq;
      v_pages[self_cell * kD + tid] = vq;
      if (tid == 0) {
        k_sc[self_cell] = ks;
        v_sc[self_cell] = vs;
      }
      sh.kself[tid] = (float)kq * ks;
      sh.vself[tid] = (float)vq * vs;
    }
  } else if (tid < kD) {
    k_pages[self_cell * kD + tid] = __float2bfloat16(kn);
    v_pages[self_cell * kD + tid] = __float2bfloat16(vn);
    sh.kself[tid] = kn;
    sh.vself[tid] = vn;
  }
  if (tid < kD) {
    const int d = tid, pd = d < HALF ? d + HALF : d - HALF;
    const float c = cos_t[(size_t)b * kD + d], s = sin_t[(size_t)b * kD + d];
    for (int j = 0; j < g; ++j) {
      const bf16* qr = q + ((size_t)b * H + kh * g + j) * kD;
      const bf16 qb = __float2bfloat16(
          pt::ragged::rope(__bfloat162float(qr[d]), __bfloat162float(qr[pd]), d, c, s));
      sh.qs[j][d] = __bfloat162float(qb) * scale;
    }
  }
  __syncthreads();
  pt::paged_walk<Pool>(sh, g, k_pages, v_pages, k_sc, v_sc, bt, pps, page, plane, pos + 1, pos,
                       out_b);
}

}  // namespace

// q (B, H, D), k/v (B, Hk, D) bf16; cos/sin (B, D) f32 at each slot's
// position; k_pages/v_pages (L, Hk, P, page, D) bf16, written in place;
// block_tables (B, pps) int32; seq_lens (B,) int32; active (B,) bool or
// null; out (B, H, D) bf16.
PT_EXPORT int pt_rope_append_attend_decode(const void* q, const void* k, const void* v,
                                           const void* cos_t, const void* sin_t, void* k_pages,
                                           void* v_pages, const void* block_tables,
                                           const void* seq_lens, const void* active, void* out,
                                           int B, int H, int Hk, int P, int page, int pps,
                                           int layer, float scale, void* stream) {
  dim3 grid(Hk, B);
  rope_append_attend_kernel<bf16>
      <<<grid, pt::kWalkThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
          static_cast<bf16*>(k_pages), static_cast<bf16*>(v_pages), nullptr, nullptr,
          static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens),
          static_cast<const bool*>(active), static_cast<bf16*>(out), H, Hk, P, page, pps, layer,
          scale);
  return cudaGetLastError();
}

// The same over an int8 cache: k_pages/v_pages (L, Hk, P, page, D) int8
// codes and k_scales/v_scales (L, Hk, P, page, 1) f32, all written in place.
PT_EXPORT int pt_rope_append_attend_decode_int8(
    const void* q, const void* k, const void* v, const void* cos_t, const void* sin_t,
    void* k_pages, void* v_pages, void* k_scales, void* v_scales, const void* block_tables,
    const void* seq_lens, const void* active, void* out, int B, int H, int Hk, int P, int page,
    int pps, int layer, float scale, void* stream) {
  dim3 grid(Hk, B);
  rope_append_attend_kernel<signed char>
      <<<grid, pt::kWalkThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
          static_cast<signed char*>(k_pages), static_cast<signed char*>(v_pages),
          static_cast<float*>(k_scales), static_cast<float*>(v_scales),
          static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens),
          static_cast<const bool*>(active), static_cast<bf16*>(out), H, Hk, P, page, pps, layer,
          scale);
  return cudaGetLastError();
}

// The ragged form: q (T, H, D), k/v (T, Hk, D) bf16 unrotated; cos/sin
// (T, D) f32 at each row's position row_pos (T,) int32; k_pages/v_pages
// (L, Hk, P, page, D) bf16, written in place; block_tables (B, pps),
// page_lens/q_start/q_lens/fresh_lens (B,) int32; out (T, H, D) bf16,
// zero-filled by the caller.
PT_EXPORT int pt_rope_append_attend_ragged(
    const void* q, const void* k, const void* v, const void* cos_t, const void* sin_t,
    void* k_pages, void* v_pages, const void* block_tables, const void* row_pos,
    const void* page_lens, const void* q_start, const void* q_lens, const void* fresh_lens,
    void* out, int T, int B, int H, int Hk, int P, int page, int pps, int layer, float scale,
    void* stream) {
  pt::ragged::Args a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.cos = static_cast<const float*>(cos_t);
  a.sin = static_cast<const float*>(sin_t);
  a.k_pages = static_cast<bf16*>(k_pages);
  a.v_pages = static_cast<bf16*>(v_pages);
  a.block_tables = static_cast<const int*>(block_tables);
  a.row_pos = static_cast<const int*>(row_pos);
  a.page_lens = static_cast<const int*>(page_lens);
  a.q_start = static_cast<const int*>(q_start);
  a.q_lens = static_cast<const int*>(q_lens);
  a.fresh_lens = static_cast<const int*>(fresh_lens);
  a.out = static_cast<bf16*>(out);
  a.H = H;
  a.Hk = Hk;
  a.P = P;
  a.page = page;
  a.pps = pps;
  a.layer = layer;
  a.scale = scale;
  return pt::ragged::launch_ragged<true>(a, T, B, static_cast<cudaStream_t>(stream));
}
