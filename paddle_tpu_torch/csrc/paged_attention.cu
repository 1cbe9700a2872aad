// K10 paged_attention: decode attention of one query row per slot over the
// slot's first seq_lens[b] cells of a paged KV pool, found through its
// block table; zeros for a slot of length 0.
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py:_pallas_paged
// (_paged_kernel), which walks the pages of one (slot, kv head) as the
// sequential grid axis with the online softmax in VMEM scratch. Here the
// g query heads of a kv head ride together through the page walk K3 uses
// (paged_walk.cuh): each (kv head, slot) walk split over a cluster of CTAs
// in whole pages, the pages brought in by bulk copies into a ring and
// scored in chunks on the tensor cores, and the ranks' partial softmax
// states merged by rank 0 in rank order. The scores are (bf16 q . k) * scale in f32 (the TPU
// kernel loads q as bf16 -> f32 * scale: the same up to rounding). On an
// int8 cache (pt_paged_attention_int8; _paged_kernel's quantized form) the
// walk copies each page's scales beside its codes and reads a cell as
// code * scale: S times the K scale per key, the V scale folded into P.
//
// Bound on an H100: bytes — each call reads every live cell's K and V once
// (2 * len * Hk * D * 2 bytes per slot; 2 * len * Hk * (D + 4) on an int8
// cache) and does ~4 * g * D flops per cell.
#include "paged_walk.cuh"

using pt::bf16;
using pt::pw::kD;

namespace {

// Pool = bf16 (verbatim pools) or signed char (int8 codes; a.k_sc / a.v_sc
// the (Hk, P, page, 1) scale pools, which the walk copies beside each page)
template <typename Pool>
__global__ void __launch_bounds__(pt::pw::NT, 3) paged_attention_kernel(const pt::pw::Args<Pool> a) {
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ pt::pw::Shared sh;
  // the block-table row (cp.async), q and the slot's length, issued first
  // and together
  const int b = blockIdx.y, kh = blockIdx.x / a.cs, g = a.H / a.Hk, tid = threadIdx.x;
  pt::pw::prefetch_table(dyn, a, b);
  float qv[pt::pw::kMaxG];
#pragma unroll
  for (int j = 0; j < pt::pw::kMaxG; ++j)
    qv[j] = tid < kD && j < g
                ? __bfloat162float(a.q[((size_t)b * a.H + kh * g + j) * kD + tid])
                : 0.f;
  const pt::pw::Walk w(a.seq_lens[b], a.page, a.pps, a.cs);
  bf16* out = a.out + ((size_t)b * a.H + kh * g) * kD;
  if (w.n == 0) return pt::pw::zeros(w, g, out);  // the whole cluster returns
  const size_t plane = (size_t)w.kh * a.P;
  pt::pw::begin(sh, dyn, a, w, plane);
  if (tid < kD)
#pragma unroll
    for (int j = 0; j < pt::pw::kMaxG; ++j)
      if (j < g) sh.part[j][tid] = qv[j];
  __syncthreads();
  pt::pw::attend(sh, dyn, a, w, plane, g, -1);
  pt::pw::merge(sh, dyn, a, w, g, out);
}

template <typename Pool>
int launch_walk(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
                const void* v_scales, const void* block_tables, const void* seq_lens, void* out,
                int B, int H, int Hk, int P, int page, int pps, float scale, void* stream) {
  pt::pw::Args<Pool> a{};
  a.q = static_cast<const bf16*>(q);
  a.k_pages = static_cast<Pool*>(const_cast<void*>(k_pages));
  a.v_pages = static_cast<Pool*>(const_cast<void*>(v_pages));
  a.k_sc = static_cast<float*>(const_cast<void*>(k_scales));
  a.v_sc = static_cast<float*>(const_cast<void*>(v_scales));
  a.block_tables = static_cast<const int*>(block_tables);
  a.seq_lens = static_cast<const int*>(seq_lens);
  a.out = static_cast<bf16*>(out);
  a.H = H;
  a.Hk = Hk;
  a.P = P;
  a.page = page;
  a.pps = pps;
  a.scale = scale;
  return pt::pw::launch(paged_attention_kernel<Pool>, a, B, static_cast<cudaStream_t>(stream));
}

}  // namespace

// q (B, H, D) bf16; k_pages/v_pages (Hk, P, page, D) bf16, 16-byte
// aligned; block_tables (B, pps) int32; seq_lens (B,) int32; out (B, H, D)
// bf16.
PT_EXPORT int pt_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                 const void* block_tables, const void* seq_lens, void* out,
                                 int B, int H, int Hk, int P, int page, int pps, float scale,
                                 void* stream) {
  return launch_walk<bf16>(q, k_pages, v_pages, nullptr, nullptr, block_tables, seq_lens, out,
                           B, H, Hk, P, page, pps, scale, stream);
}

// The same over an int8 cache: k_pages/v_pages (Hk, P, page, D) int8 codes,
// k_scales/v_scales (Hk, P, page, 1) f32, each cell read as code * scale;
// page % 4 == 0 (a page's scales are one bulk copy of whole 16 bytes).
PT_EXPORT int pt_paged_attention_int8(const void* q, const void* k_pages, const void* v_pages,
                                      const void* k_scales, const void* v_scales,
                                      const void* block_tables, const void* seq_lens, void* out,
                                      int B, int H, int Hk, int P, int page, int pps, float scale,
                                      void* stream) {
  return launch_walk<signed char>(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                                  seq_lens, out, B, H, Hk, P, page, pps, scale, stream);
}

// The walk's items for walks over lens (B,) int32 at this card's plan: out
// (B * Hk * cs, 3) int32 rows (rank, first page, end page), row
// (b * Hk + kh) * cs + rank.
PT_EXPORT int pt_paged_walk_items(const void* lens, void* out, int B, int Hk, int page, int pps,
                                  void* stream) {
  return pt::pw::items(static_cast<const int*>(lens), B, Hk, page, pps, static_cast<int*>(out),
                       static_cast<cudaStream_t>(stream));
}
