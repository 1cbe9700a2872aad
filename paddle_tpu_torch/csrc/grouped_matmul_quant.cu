// K13's int8/int4 forms: y[r] = x[r] @ dequant(codes[g], scales[g]) over
// expert-sorted rows, weight-only quantized expert weights.
//
// Replaces the quantized forms of
// paddle_tpu/ops/pallas/grouped_matmul.py:_pallas_grouped_matmul
// (_gmm_kernel :156, its dequant at :177-186: int4 codes unpacked with
// unpack_int4_tile, a per-channel (1, bn) scale broadcast or a group-wise
// one expanded with expand_group_scales, then an f32 dot). The TPU
// dequantizes each weight tile before the dot because one of its row
// tiles can mix two experts. Here a work item is one (step, column tile)
// of K13's step walk (grouped_matmul.cu): it holds one group only, so the
// design is K4's (wgmma_quant_tiles.cuh): the raw codes ride a TMA ring
// (a 3-D map with the expert outermost: int8 (E, K, N), packed int4
// (E, K/2, N) with byte i holding k-row 2i in its low nibble and 2i + 1 in
// its high one), become an exact bf16 B tile in shared memory and meet x
// in wgmma with f32 accumulation; a per-channel scale multiplies the f32
// sum once at the flush (kEnd, 128 x 256 tiles), a group-wise scale each
// K-group's partial sum (kGroup, 128 x 128 tiles and a second register set
// for the total: at a group's end the consumers first convert the next
// group's first slice, then wait for the group's wgmmas and fold its sum
// with the scale row the producer staged beside its last slice).
// Every product x * code is exact, so the only roundings are the
// f32 sums and the one bf16 rounding of each output, closer to the TPU's
// f32 arithmetic than rounding each dequantized weight to bf16. An item
// writes rows [lo, hi) only: the other step of a row tile that straddles
// a group boundary owns the rest. A parked step loads nothing.
//
// Bound on an H100: tensor-core operations at the MoE shapes (T = 16,384
// routed rows, 4096 -> 14336 and 14336 -> 4096: 1.92 TFLOP, ~1.95 ms at
// the bf16 peak), as for the bf16 form; the codes are half (int8) or a
// quarter (int4) of the bf16 weight's bytes.
#include "wgmma_quant_tiles.cuh"

using namespace pt::mm;

// x (T, K) bf16; offsets (E + 1,) int32 on the card, non-decreasing, in
// [0, T]; codes/scales as above; y (T, N) bf16 (rows of no group are not
// written). wt: 1 int8, 2 int4; group_size -1 per channel, else 64 or 128.
// Requires T >= 1, K % 128 == 0, K % group_size == 0, N % 16 == 0 and
// 16-byte-aligned x and codes (checked by the Python wrapper).
PT_EXPORT int pt_grouped_matmul_quant(const void* x, const void* offsets, const void* codes,
                                      const void* scales, void* y, int T, int K, int N, int E,
                                      int wt, int group_size, void* stream) {
  using pt::wq::launch_grouped;
  auto s = static_cast<cudaStream_t>(stream);
  auto off = static_cast<const int*>(offsets);
  auto sc = static_cast<const float*>(scales);
  const int gs = group_size > 0 ? group_size : 0;
  if (wt == kInt8)
    return gs ? launch_grouped<kInt8, kGroup, 128>(x, off, codes, sc, y, T, K, N, E, gs, s)
              : launch_grouped<kInt8, kEnd, 256>(x, off, codes, sc, y, T, K, N, E, 0, s);
  if (wt == kInt4)
    return gs ? launch_grouped<kInt4, kGroup, 128>(x, off, codes, sc, y, T, K, N, E, gs, s)
              : launch_grouped<kInt4, kEnd, 256>(x, off, codes, sc, y, T, K, N, E, 0, s);
  return cudaErrorInvalidValue;
}
