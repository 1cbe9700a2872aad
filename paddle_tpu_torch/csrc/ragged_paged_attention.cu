// K11 ragged_paged_attention: two-source ragged paged attention for a
// mixed wave of chunked-prefill and decode rows (ragged_walk.cuh sets out
// the contract and the design).
//
// Replaces paddle_tpu/ops/pallas/ragged_paged_attention.py:_pallas_ragged
// (_ragged_kernel), whose grid walks (kv head, slot, q-row block, page) in
// order with the online softmax in VMEM scratch and parks the page index of
// a q-row block outside the slot's segment. Here a grid that depends on
// shapes only decodes its items on the device: each decode row's page walk
// split in whole pages across a thread-block cluster and merged in rank
// order, every chunk in tiles of 64 MMA rows that walk the slot's pages
// and their causal share of the chunk on the tensor cores, the pages
// brought in by cp.async pieces. On an int8 cache
// (pt_ragged_paged_attention_int8) the pages are codes with per-cell
// scales, dequantized in the arithmetic (ragged_walk.cuh); the fresh rows
// stay bf16, as in the TPU kernel, but for the slots a fresh_pool_read flag
// marks (speculative verify segments): there the TPU kernel receives the
// rows already passed through the pool's representation as an f32 fresh
// source (fused_rope_attend.py _pool_roundtrip), which no bf16 mma.sync
// operand carries exactly. This kernel takes the (B,) flag instead and, on
// an int8 cache, quantizes a flagged slot's fresh rows in shared memory as
// the cache writer does, then reads them as code * scale, like page cells
// (ragged_walk.cuh). On a bf16 cache the flag changes nothing: a bf16 row
// cast to the bf16 pool is itself.
//
// Bound on an H100: bytes for decode rows (each live cell's K and V read
// once), operations for long prefill chunks (4 * D flops per query row and
// visible key).
#include "ragged_walk.cuh"

using pt::bf16;

namespace {

template <typename Pool>
int launch_wave(const void* q_rows, const void* k_pages, const void* v_pages,
                const void* k_scales, const void* v_scales, const void* block_tables,
                const void* page_lens, const void* q_start, const void* q_lens,
                const void* fresh_lens, const void* fresh_pool_read, const void* k_fresh,
                const void* v_fresh, void* out,
                int T, int B, int H, int Hk, int P, int page, int pps, float scale,
                void* stream) {
  pt::rw::Args<Pool> a{};
  a.q = static_cast<const bf16*>(q_rows);
  a.k = static_cast<const bf16*>(k_fresh);
  a.v = static_cast<const bf16*>(v_fresh);
  a.k_pages = const_cast<Pool*>(static_cast<const Pool*>(k_pages));
  a.v_pages = const_cast<Pool*>(static_cast<const Pool*>(v_pages));
  a.k_sc = const_cast<float*>(static_cast<const float*>(k_scales));
  a.v_sc = const_cast<float*>(static_cast<const float*>(v_scales));
  a.block_tables = static_cast<const int*>(block_tables);
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
  a.layer = 0;
  a.scale = scale;
  return pt::rw::launch<false>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// q_rows (T, H, D) bf16; k_pages/v_pages (Hk, P, page, D) bf16;
// block_tables (B, pps), page_lens/q_start/q_lens/fresh_lens (B,) int32;
// fresh_pool_read (B,) bool or null (no slot flagged); k_fresh/v_fresh
// (T, Hk, D) bf16; out (T, H, D) bf16, every row written (rows of no
// segment as zeros). Every pointer 16-byte aligned.
PT_EXPORT int pt_ragged_paged_attention(const void* q_rows, const void* k_pages,
                                        const void* v_pages, const void* block_tables,
                                        const void* page_lens, const void* q_start,
                                        const void* q_lens, const void* fresh_lens,
                                        const void* fresh_pool_read, const void* k_fresh,
                                        const void* v_fresh, void* out,
                                        int T, int B, int H, int Hk, int P, int page, int pps,
                                        float scale, void* stream) {
  return launch_wave<bf16>(q_rows, k_pages, v_pages, nullptr, nullptr, block_tables,
                           page_lens, q_start, q_lens, fresh_lens, fresh_pool_read, k_fresh,
                           v_fresh, out, T, B,
                           H, Hk, P, page, pps, scale, stream);
}

// The same over an int8 cache: k_pages/v_pages (Hk, P, page, D) int8 codes,
// k_scales/v_scales (Hk, P, page, 1) f32; page % 4 == 0 (a page's scales
// are copied in 16-byte pieces). The fresh K/V stay bf16 (a flagged slot's
// are quantized in the kernel).
PT_EXPORT int pt_ragged_paged_attention_int8(
    const void* q_rows, const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, const void* block_tables, const void* page_lens, const void* q_start,
    const void* q_lens, const void* fresh_lens, const void* fresh_pool_read,
    const void* k_fresh, const void* v_fresh, void* out, int T, int B, int H, int Hk, int P,
    int page, int pps, float scale, void* stream) {
  return launch_wave<signed char>(q_rows, k_pages, v_pages, k_scales, v_scales,
                                  block_tables, page_lens, q_start, q_lens, fresh_lens,
                                  fresh_pool_read, k_fresh, v_fresh, out, T, B, H, Hk, P, page,
                                  pps, scale, stream);
}

// The ragged walk's items for a wave at this card's plan (both forms share
// it): out (clusters * cs * Hk, 6) int32 rows (kind, slot, kv head, rank or
// tile, first key, end key), row kh * clusters * cs + CTA.
PT_EXPORT int pt_ragged_items(const void* page_lens, const void* q_lens, const void* fresh_lens,
                              void* out, int T, int B, int H, int Hk, int page, int pps,
                              void* stream) {
  return pt::rw::items(static_cast<const int*>(page_lens), static_cast<const int*>(q_lens),
                       static_cast<const int*>(fresh_lens), T, B, H, Hk, page, pps,
                       static_cast<int*>(out), static_cast<cudaStream_t>(stream));
}

// K11's plan at a wave's shapes, into host memory out[4]: cluster size,
// clusters a kv head, dynamic shared memory bytes, and the most clusters
// of the kernel this card holds at once; int8: on an int8 cache.
PT_EXPORT int pt_ragged_paged_attention_plan(int T, int B, int H, int Hk, int page, int pps,
                                             void* out) {
  return pt::rw::describe<false, bf16>(T, B, H, Hk, page, pps, static_cast<int*>(out));
}
PT_EXPORT int pt_ragged_paged_attention_int8_plan(int T, int B, int H, int Hk, int page, int pps,
                                                  void* out) {
  return pt::rw::describe<false, signed char>(T, B, H, Hk, page, pps, static_cast<int*>(out));
}
