// K10 paged_attention: decode attention of one query row per slot over the
// slot's first seq_lens[b] cells of a paged KV pool, found through its
// block table; zeros for a slot of length 0.
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py:_pallas_paged
// (_paged_kernel), which walks the pages of one (slot, kv head) as the
// sequential grid axis with the online softmax in VMEM scratch. Here one
// block per (kv head, slot) runs the page walk K3 uses (paged_walk.cuh):
// the g query heads of the kv head ride together, q is loaded as
// bf16 -> f32 * scale (the TPU kernel's q load), the 8 warps split the
// cells and merge their partial softmax states in shared memory.
//
// Bound on an H100: bytes — each call reads every live cell's K and V once
// (2 * len * Hk * D * 2 bytes per slot) and does ~4 * g * D flops per cell.
// B * Hk blocks (64 at B = 8, Hk = 8) fill half the 132 SMs; splitting
// the page walk across blocks is a later PR's work.
#include "paged_walk.cuh"

using pt::bf16;

namespace {

__global__ void __launch_bounds__(pt::kWalkThreads)
paged_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
                       const bf16* __restrict__ v_pages, const int* __restrict__ block_tables,
                       const int* __restrict__ seq_lens, bf16* __restrict__ out, int H, int Hk,
                       int P, int page, int pps, float scale) {
  __shared__ pt::WalkShared sh;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int g = H / Hk, tid = threadIdx.x;
  if (tid < pt::kD) {
    for (int j = 0; j < g; ++j)
      sh.qs[j][tid] = __bfloat162float(q[((size_t)b * H + kh * g + j) * pt::kD + tid]) * scale;
  }
  __syncthreads();
  pt::paged_walk<bf16>(sh, g, k_pages, v_pages, nullptr, nullptr, block_tables + (size_t)b * pps,
                       pps, page, (size_t)kh * P, seq_lens[b], -1,
                       out + ((size_t)b * H + kh * g) * pt::kD);
}

}  // namespace

// q (B, H, D) bf16; k_pages/v_pages (Hk, P, page, D) bf16; block_tables
// (B, pps) int32; seq_lens (B,) int32; out (B, H, D) bf16.
PT_EXPORT int pt_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                 const void* block_tables, const void* seq_lens, void* out,
                                 int B, int H, int Hk, int P, int page, int pps, float scale,
                                 void* stream) {
  dim3 grid(Hk, B);
  paged_attention_kernel<<<grid, pt::kWalkThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
      static_cast<const bf16*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(seq_lens), static_cast<bf16*>(out), H, Hk, P, page, pps, scale);
  return cudaGetLastError();
}
