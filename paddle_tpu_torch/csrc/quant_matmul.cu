// K4 quant_matmul: y = x @ dequant(codes, scales), weight-only int8 / int4.
//
// Replaces paddle_tpu/ops/pallas/quant_matmul.py:_pallas_quant_matmul
// (_qmm_kernel). As on the TPU, the codes stay packed (1 or 1/2 byte per
// weight) all the way into shared memory, where they become bf16 — exactly,
// since |code| <= 127 — and meet x in the tensor cores (nvcuda::wmma, f32
// accumulate), so every product x * code is exact. A per-channel scale
// multiplies the f32 sum once at the end (_qmm_kernel's flush); a
// group-wise scale multiplies each K-group's partial sum before it joins the
// total. Codes: int8 (K, N), or nibble-packed int4 (K/2, N) with byte i
// holding row 2i in its low nibble and row 2i+1 in its high nibble
// (unpack_int4_tile's rule, sign-extended).
//
// One entry point for any M, as K2: the small-M kernel (decode) splits K
// over 4 warps that prefetch their next code slice into registers; the
// tiled kernel (prefill) walks 64x128 output tiles. The bodies live in
// matmul_tiles.cuh, shared with K2 (which dequantizes in its tile instead).
//
// Bound on an H100: at decode (M = 8) the bytes of the codes (K*N int8,
// K*N/2 int4): o_proj 16.8 MB = 5.0 us, down_proj 58.7 MB = 17.5 us at
// 3.35 TB/s. At prefill (M = 1024) tensor-core operations: 2*M*K*N.
#include "matmul_tiles.cuh"

using namespace pt::mm;

// x (M, K) bf16; codes/scales as above; y (M, N) bf16. wt: 1 int8, 2 int4;
// group_size -1 per channel, else 64 or 128. Requires K % 128 == 0,
// K % group_size == 0 and N % 16 == 0 (checked by the Python wrapper).
PT_EXPORT int pt_quant_matmul(const void* x, const void* codes, const void* scales, void* y,
                              int M, int K, int N, int wt, int group_size, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int gs = group_size > 0 ? group_size : 0;
  if (wt == kInt8)
    return gs ? launch<false, kInt8, kGroup>(x, nullptr, codes, scales, y, M, K, N, gs, 0.f, s)
              : launch<false, kInt8, kEnd>(x, nullptr, codes, scales, y, M, K, N, 0, 0.f, s);
  if (wt == kInt4)
    return gs ? launch<false, kInt4, kGroup>(x, nullptr, codes, scales, y, M, K, N, gs, 0.f, s)
              : launch<false, kInt4, kEnd>(x, nullptr, codes, scales, y, M, K, N, 0, 0.f, s);
  return cudaErrorInvalidValue;
}
