// K11 ragged_paged_attention: two-source ragged paged attention for a
// mixed wave of chunked-prefill and decode rows (ragged_attend.cuh sets
// out the contract and the design).
//
// Replaces paddle_tpu/ops/pallas/ragged_paged_attention.py:_pallas_ragged
// (_ragged_kernel), whose grid walks (kv head, slot, q-row block, page) in
// order with the online softmax in VMEM scratch and parks the page index of
// a q-row block outside the slot's segment. Here the blocks run in
// parallel: one block per (tile of a slot's rows, kv head, slot), which
// exits at once when its tile lies past the slot's q_lens, so a wave costs
// work only where it has rows; within a block the g query heads of the kv
// head share every K/V tile staged in shared memory.
//
// Bound on an H100: bytes for decode rows (each live cell's K and V read
// once), operations for long prefill chunks (4 * D flops per query row
// and visible key, in f32 outside the tensor cores here); this version
// rereads a slot's pages once per row tile, and its scores and p @ V run
// on the CUDA cores. Tensor-core tiles are a later PR's work.
#include "ragged_attend.cuh"

using pt::bf16;

// q_rows (T, H, D) bf16; k_pages/v_pages (Hk, P, page, D) bf16;
// block_tables (B, pps), page_lens/q_start/q_lens/fresh_lens (B,) int32;
// k_fresh/v_fresh (T, Hk, D) bf16; out (T, H, D) bf16, zero-filled by the
// caller (rows of no segment are not written).
PT_EXPORT int pt_ragged_paged_attention(const void* q_rows, const void* k_pages,
                                        const void* v_pages, const void* block_tables,
                                        const void* page_lens, const void* q_start,
                                        const void* q_lens, const void* fresh_lens,
                                        const void* k_fresh, const void* v_fresh, void* out,
                                        int T, int B, int H, int Hk, int P, int page, int pps,
                                        float scale, void* stream) {
  pt::ragged::Args a{};
  a.q = static_cast<const bf16*>(q_rows);
  a.k = static_cast<const bf16*>(k_fresh);
  a.v = static_cast<const bf16*>(v_fresh);
  a.k_pages = const_cast<bf16*>(static_cast<const bf16*>(k_pages));
  a.v_pages = const_cast<bf16*>(static_cast<const bf16*>(v_pages));
  a.block_tables = static_cast<const int*>(block_tables);
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
  a.layer = 0;
  a.scale = scale;
  return pt::ragged::launch_ragged<false>(a, T, B, static_cast<cudaStream_t>(stream));
}
