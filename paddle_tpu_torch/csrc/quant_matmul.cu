// K4 quant_matmul: y = x @ dequant(codes, scales), weight-only int8 / int4.
//
// Replaces paddle_tpu/ops/pallas/quant_matmul.py:_pallas_quant_matmul
// (_qmm_kernel). As on the TPU, the codes stay packed (1 or 1/2 byte per
// weight) all the way into shared memory, where they become bf16 — exactly,
// since |code| <= 127 — and meet x in the tensor cores with f32
// accumulation, so every product x * code is exact. A per-channel scale
// multiplies the f32 sum once at the end (_qmm_kernel's flush); a
// group-wise scale multiplies each K-group's partial sum before it joins the
// total. Codes: int8 (K, N), or nibble-packed int4 (K/2, N) with byte i
// holding row 2i in its low nibble and row 2i+1 in its high nibble
// (unpack_int4_tile's rule, sign-extended).
//
// One entry point for any M, as K2:
//   M <= 16 (decode): skinny_wgmma_kernel (skinny_tiles.cuh, shared with
//     K2's M <= 16 forms): a TMA ring of raw code slices on every SM,
//     dequantized into a bf16 tile that wgmma reads as its A operand
//     (W^T . x^T), K split across a thread-block cluster and summed in rank
//     order; bound by the bytes of the codes (K*N int8, K*N/2 int4): o_proj
//     16.8 MB = 5.0 us, down_proj 58.7 MB = 17.5 us at 3.35 TB/s;
//   M > 16 (prefill): quant_wgmma_kernel (wgmma_quant_tiles.cuh, shared
//     with K2's tiled forms): the raw codes ride a TMA ring beside x,
//     the two consumer warpgroups turn each slice's codes into a bf16 B
//     tile in shared memory and run wgmma on it, 128 x 256 tiles per
//     channel, 128 x 128 group-wise (each group's partial sum folded into
//     a second register set, after the next group's first slice is
//     converted), on a persistent banded grid; bound by tensor-core
//     operations (2*M*K*N).
#include "skinny_tiles.cuh"

using namespace pt::mm;

// x (M, K) bf16; codes/scales as above; y (M, N) bf16. wt: 1 int8, 2 int4;
// group_size -1 per channel, else 64 or 128. Requires K % 128 == 0,
// K % group_size == 0, N % 16 == 0 and 16-byte-aligned x and codes
// (checked by the Python wrapper).
PT_EXPORT int pt_quant_matmul(const void* x, const void* codes, const void* scales, void* y,
                              int M, int K, int N, int wt, int group_size, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int gs = group_size > 0 ? group_size : 0;
  if (wt != kInt8 && wt != kInt4) return cudaErrorInvalidValue;
  if (M <= 16) {
    using pt::sk::launch;
    if (wt == kInt8)
      return gs ? launch<false, kInt8, kGroup>(x, nullptr, codes, scales, y, M, K, N, gs, 0.f, s)
                : launch<false, kInt8, kEnd>(x, nullptr, codes, scales, y, M, K, N, 0, 0.f, s);
    return gs ? launch<false, kInt4, kGroup>(x, nullptr, codes, scales, y, M, K, N, gs, 0.f, s)
              : launch<false, kInt4, kEnd>(x, nullptr, codes, scales, y, M, K, N, 0, 0.f, s);
  }
  using pt::wq::launch;
  if (wt == kInt8)
    return gs ? launch<false, kInt8, kGroup>(x, nullptr, nullptr, codes, scales, y, M, K, N, gs, s)
              : launch<false, kInt8, kEnd>(x, nullptr, nullptr, codes, scales, y, M, K, N, 0, s);
  return gs ? launch<false, kInt4, kGroup>(x, nullptr, nullptr, codes, scales, y, M, K, N, gs, s)
            : launch<false, kInt4, kEnd>(x, nullptr, nullptr, codes, scales, y, M, K, N, 0, s);
}

// The tiled body's output tiles as its blocks decode them, in walk order:
// out holds item_count(M, N, block_n) rows of (row tile, column tile)
// int32, for tiles of 128 rows x block_n columns (256, or 128 for K4's
// group-wise form) and a K-deep reduction (the card tests hold it to
// quant_matmul.quant_tiles).
PT_EXPORT int pt_quant_matmul_items(int M, int K, int N, int block_n, void* out, void* stream) {
  const int n = pt::wq::item_count(M, N, block_n);
  if (n <= 0) return cudaSuccess;
  pt::wq::items_kernel<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      M, N, block_n, pt::wq::band_for(K), n, static_cast<int*>(out));
  return cudaGetLastError();
}

// The small-M body's walk (M <= 16, every form) as its CTAs decode it, for
// the plan this card gets: out holds tiles * 8 rows of 4 int32 (tiles =
// ceil(N / 64)); row tile * cs + rank = (CTA, its step at that tile, first
// slice, end slice) of 128 k-rows, rows past tiles * cs untouched (the card
// tests hold it to quant_matmul.small_items).
PT_EXPORT int pt_small_matmul_items(int K, int N, void* out, void* stream) {
  return pt::sk::items(K, N, static_cast<int*>(out), static_cast<cudaStream_t>(stream));
}
