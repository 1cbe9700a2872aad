// The Hopper body of K2's and K4's tiled product (M > 16):
//
//   y = A @ B,  A = rms_norm(x) (NORM, K2) or x (K4),
//   B = W (dense bf16, K2) or dequant(codes, scales) (K2, K4)
//
// K2's forms (norm_matmul.cu; dense W, or int8/int4 with scale mode kTile)
// and K4's (quant_matmul.cu, kEnd per channel, kGroup group-wise): the
// prefill and train forms of paddle_tpu/ops/pallas/fused_norm_matmul.py:
// _pallas_fnm / _pallas_fnm_streamed and of quant_matmul.py:
// _pallas_quant_matmul (_qmm_kernel). It is wgmma_tiles.cuh's shape
// (K13/K14); a quantized weight adds one stage inside the ring: it reaches
// shared memory as its raw codes and becomes a bf16 B tile there.
//
// A block is three warpgroups on one SM. Warpgroup 0 is the producer:
// one thread keeps STAGES slices of TMA loads in flight, each stage 128
// rows x 64 k of x (a 128-byte-swizzled K-major box, as K13) and the
// slice of W:
//   dense (DENSE): 64 k-rows of bf16 W as 64-column MN-major boxes with
//     the 128-byte swizzle, K13's forward B operand, read by wgmma straight
//     from the stage;
//   quantized: int8 (K, N) or nibble-packed int4 (K/2, N) codes in
//     unswizzled 128-column byte boxes, half (int8) or a quarter (int4) of
//     the bytes of a bf16 slice.
// With NORM (K2) its warps 1-3 normalize each landed x slice in place
// (bf16(x * rstd) * w_norm, rstd from norm_rstd_kernel), fence it to the
// async proxy and arrive on the stage's normed barrier. Warpgroups 1 and 2
// are the consumers, 64 rows of the 128-row tile each. For each slice they
//   1. wait on the stage's full barrier;
//   2. (quantized) dequantize its codes into a bf16 B tile in the layout
//      TMA would have written for a dense W: each of the 256 threads turns
//      8-byte pieces of codes into 16-byte bf16 vectors with integer ops
//      (the byte placed under a float's exponent, then one subtraction:
//      exact), nibbles sign-extended (a code byte's low nibble is k-row 2i,
//      its high nibble k-row 2i + 1); kTile also multiplies by the
//      column's scale there (_fnm_kernel's rule: bf16(code) * bf16(scale),
//      rounded to bf16 once);
//   3. wait on the normed barrier (NORM); quantized: fence the B tile's
//      writes to the async proxy and meet at one named barrier of the 256
//      consumer threads (both read the same B tile);
//   4. issue the slice's four k16 wgmmas (m64n256k16 on a 256-wide tile,
//      m64n128k16 on a 128-wide one), keep one group in flight and
//      release the slice before.
// With a dense W, a consumer warpgroup whose 64 rows all lie past M (the
// upper half of a cut last row tile: M = 264 leaves 8 rows in the last)
// issues no wgmma and stores nothing, but walks the ring and releases each
// stage. Step 2 of a slice overlaps the previous slice's wgmmas. The
// B tile has three buffers, not two: when one warpgroup converts slice s,
// the other may still be running slice s - 1's wgmmas and has only been
// seen (at slice s - 1's barrier) to have finished slice s - 2's, so slice
// s may reuse only slice s - 3's buffer.
//
// Scales: kEnd multiplies the f32 sum by its column's scale once, in the
// epilogue (_qmm_kernel's flush); kTile scales inside the B tile. kGroup
// (K4's and K13's group-wise forms) multiplies each K-group's f32 partial
// sum by its f32 scales before it joins the total (a second register set,
// tot), so the partial sum must be complete, its wgmmas waited for, at
// every group's end. What it does about that wait:
//   - the wait comes late: a group's first slice is converted and met at
//     the named barrier first, so its conversion overlaps the last
//     slice's wgmmas, and only then do the consumers wait for those
//     (wgmma_wait<0>), fold the partial sum into tot (64 FMAs a thread)
//     and issue the slice, whose first k16 overwrites the sum (scale-d
//     0: no zeroing);
//   - the group's scale row rides the ring: the producer bulk-copies
//     columns n0 .. n0 + 127 of it beside the group's last slice, on that
//     stage's full barrier, and the fold reads it from shared memory (no
//     global load after the wait). That stage is released after the fold,
//     by each consumer warp (its empty barrier counts the 8 warps), so no
//     warp's scale reads race the producer's next copy;
//   - a group's slices are unrolled (64 or 128 wide: 1 or 2 slices).
// Two partial-sum sets used by alternate groups, each folded while the
// next group's wgmmas run, would need no wait at all, but ptxas then
// serializes every wgmma (C7514: a non-wgmma instruction reads
// accumulator registers inside the pipeline stage, also with the sets
// pinned by fence_operand and the loop entered and left with the same
// set in flight): 6.0-6.2 ms at the MoE shapes against this design's
// 4.5-4.8 (H100 80GB HBM3, 700 W), and three sets spill 36-220 bytes.
// Also slower there: folding in one warpgroup before the barrier and in
// the other after it, the scale row loaded into registers before the
// barrier, and splitting the first slice into two m64n64 halves around
// the fold. Tiles stay 128 wide: a 256-wide tile's partial sum and total
// would be 256 registers a thread, past the 255 limit.
// Tiles are otherwise 256 wide, or 128 where 256-wide ones would fill at
// most half the SMs (block_n). The epilogue writes 16-byte bf16
// vectors from the registers (as K13); rows past M and columns past N,
// which TMA read as zeros, are not written.
//
// The grid is persistent (one block an SM) and its walk a template
// parameter. TileWalk (K2, K4): block b takes output tiles b, b + grid, ...
// in bands of row tiles (grouped_tiles.cuh swizzle, K13's band): a band's
// x rows and the W columns of the tiles in flight stay in L2
// (quant_matmul.quant_tiles and quant_matmul.block_n model it). GroupWalk
// (K13's int8/int4 forms, grouped_matmul_quant.cu): K13's items, one
// (step, column tile) of the step walk over expert-sorted rows each
// (grouped_tiles.cuh group_item), the codes read through a 3-D map with
// the expert outermost (a K or N edge reads zeros, never the next
// expert's codes), the item's scales at its expert's offset, and only
// rows [lo, hi) written (the other step of a boundary tile owns the
// rest); a parked step loads, converts and releases nothing
// (grouped_matmul.gmm_items models it). No split-K, no atomics: two calls
// give the same bits.
//
// Shared memory: STAGES x (16 KB of x + the W slice), plus three B tiles
// when quantized (kGroup: and STAGES scale rows of 512 bytes): 193 KB
// dense at BN = 256, 225 KB int8, 147 KB int8 kGroup. Registers
// (setmaxnreg): producer warpgroup 40, or 104 with the normalizers;
// consumers 232, or 192 (faster at every K2 shape than 88 / 200). Bound on an H100: tensor-core operations at
// prefill and train (2 M K N bf16 products); the norm adds a 16 KB read
// and write of shared memory a slice to wgmma's reads, the conversion a
// 32 KB write and a 16 KB (int8) read.
#pragma once

#include <type_traits>

#include "grouped_tiles.cuh"
#include "matmul_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace pt {
namespace wq {
namespace {  // each including source gets its own copy

using mm::kBf16;
using mm::kEnd;
using mm::kGroup;
using mm::kInt4;
using mm::kInt8;
using mm::kTile;

constexpr int BM = 128, BK = 64;  // block tile rows; BK = the reduction slice
constexpr int STAGES = 4, B_BUFS = 3;
constexpr int CONSUMERS = 256;  // threads of the two consumer warpgroups
// NORM: the producer warpgroup's warps 1-3 normalize each x slice, up to
// NORM_ROWS rows a thread, with more registers than a bare producer
constexpr int NORMALIZERS = 96, NORM_ROWS = (BM * 8 + NORMALIZERS - 1) / NORMALIZERS;
constexpr int NORM_PRODUCER_REGS = 104, NORM_CONSUMER_REGS = 192;

template <int WT, int BN_>
struct Geo {
  static constexpr bool DENSE = WT == kBf16;          // W rides the ring as bf16 B boxes
  static constexpr int BN = BN_;                      // block tile columns
  static constexpr int NACC = BN / 2;                 // f32 accumulators a consumer thread
  static constexpr int PACK = WT == kInt4 ? 2 : 1;    // K rows a code byte holds
  static constexpr int CODE_ROWS = BK / PACK;         // code rows a slice
  static constexpr int CODE_BOXES = BN / 128;         // 128-column byte boxes a slice
  static constexpr int CODE_BOX_BYTES = CODE_ROWS * 128;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  // a stage: the x slice, then W's (its B boxes, or its codes)
  static constexpr int STAGE_BYTES = A_BYTES + (DENSE ? B_BYTES : CODE_BOXES * CODE_BOX_BYTES);
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + (DENSE ? 0 : B_BUFS * B_BYTES) + 1024;
  // a consumer thread's 8-byte code pieces a slice, and a box's
  static constexpr int PIECES = CODE_BOXES * CODE_BOX_BYTES / 8 / CONSUMERS;
  static constexpr int BOX_PIECES = CODE_BOX_BYTES / 8 / CONSUMERS;
  // kGroup: a stage's f32 scale row (the tile's columns), after the B tiles
  static constexpr int SROW_BYTES = BN * 4;
};

// The kernel's dynamic shared memory
template <int WT, int SM, int BN>
constexpr int smem_bytes() {
  using G = Geo<WT, BN>;
  return G::SMEM_BYTES + (SM == kGroup ? STAGES * G::SROW_BYTES : 0);
}

// the row tiles whose x rows fill ~16 MB of L2 together (K13's band)
inline int band_for(int K) {
  const int rows_fit = (16 << 20) / (BM * K * 2);
  return rows_fit < 1 ? 1 : (rows_fit > 16 ? 16 : rows_fit);
}

__host__ __device__ inline int item_count(int M, int N, int BN) {
  return ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
}

// One work item: rows [lo, hi) of row tile `tile` against column tile nt
// of weight `group` (K13's expert; 0 for K2 and K4). A live item runs K / BK
// slices; a parked one (a K13 step past the walk) none.
struct Item {
  bool live;
  int tile, nt, group, lo, hi;
};

// K2's and K4's walk: the output tiles of one (M, K) x (K, N) product
template <int BN_>
struct TileWalk {
  static constexpr int BN = BN_;
  static constexpr bool GROUPED = false;
  int M, N, band;
  __host__ __device__ int n_items() const { return item_count(M, N, BN); }
  __device__ Item item(int i) const {
    int mt, nt;
    gt::swizzle(i, (M + BM - 1) / BM, (N + BN - 1) / BN, band, &mt, &nt);
    return {true, mt, nt, 0, 0, M};
  }
};

// K13's walk: (step, column tile) pairs of the step walk over the
// expert-sorted rows of x (T, K), the offsets read on the card
template <int BN_>
struct GroupWalk {
  static constexpr int BN = BN_;
  static constexpr bool GROUPED = true;
  const int* off;
  int T, N, E, band;
  __host__ __device__ int n_items() const {
    return ((T + BM - 1) / BM + E - 1) * ((N + BN - 1) / BN);
  }
  __device__ Item item(int i) const {
    const gt::GroupItem g = gt::group_item(off, E, T, N, BM, BN, band, i);
    return {g.lo < g.hi, g.tile, g.nt, g.group, g.lo, g.hi};
  }
};

// ---- the dequant stage ------------------------------------------------------

// 4 code bytes biased to 0..255 (code + bias) as two bf16x2 words: each
// byte under the exponent of 2^23 gives the f32 2^23 + byte, one
// subtraction the code, exact; its upper half is the exact bf16
__device__ __forceinline__ void biased_to_bf16x2(uint32_t u, float bias, uint32_t& lo,
                                                 uint32_t& hi) {
  const float off = 8388608.f + bias;
  uint32_t f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + b)) - off);
  lo = __byte_perm(f[0], f[1], 0x7632);
  hi = __byte_perm(f[2], f[3], 0x7632);
}

__device__ __forceinline__ uint32_t hmul2_bits(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// 8 biased code bytes (w0, w1) as 8 bf16 values; with SCALE each times its
// column's bf16 scale (s: 4 bf16x2 words), the exact product rounded once
template <bool SCALE>
__device__ __forceinline__ uint4 codes8(uint32_t w0, uint32_t w1, float bias, const uint32_t* s) {
  uint4 o;
  biased_to_bf16x2(w0, bias, o.x, o.y);
  biased_to_bf16x2(w1, bias, o.z, o.w);
  if (SCALE) {
    o.x = hmul2_bits(o.x, s[0]);
    o.y = hmul2_bits(o.y, s[1]);
    o.z = hmul2_bits(o.z, s[2]);
    o.w = hmul2_bits(o.w, s[3]);
  }
  return o;
}

// The f32 scales of columns [n, n + 8) in scale row srow, rounded to bf16
// as the dequant rule reads them, as 4 bf16x2 words (zeros past N)
__device__ __forceinline__ void scales8(uint32_t (&s)[4], const float* __restrict__ scales,
                                        int srow, int n, int N) {
  float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (n < N) {
    const float4* p = reinterpret_cast<const float4*>(scales + (size_t)srow * N + n);
    const float4 a = __ldg(p), b = __ldg(p + 1);
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z,
    f[7] = b.w;
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * p], f[2 * p + 1]);
    s[p] = *reinterpret_cast<const uint32_t*>(&v);
  }
}

// The 16 columns whose codes consumer thread t converts: 8 at
// cb * 128 + (t % 16) * 8 for each code box cb, their scales in scale row
// srow (scales8)
template <class G>
__device__ __forceinline__ void tile_scales(uint32_t (&s)[G::CODE_BOXES][4],
                                            const float* __restrict__ scales, int srow, int n0,
                                            int N, int t) {
#pragma unroll
  for (int cb = 0; cb < G::CODE_BOXES; ++cb)
    scales8(s[cb], scales, srow, n0 + cb * 128 + (t % 16) * 8, N);
}

// One slice's codes (the stage's byte boxes) into the bf16 B tile bt.
// Thread t takes the 8-byte pieces t + 256 i: piece p of box cb is code
// row p / 16, columns (p % 16) * 8 .., so a warp reads 256 contiguous
// bytes and each quarter-warp writes one swizzled 128-byte row of a B box.
template <class G, int WT, bool SCALE>
__device__ __forceinline__ void dequant(const unsigned char* codes, unsigned char* bt, int t,
                                        const uint32_t (&s)[G::CODE_BOXES][4]) {
  const int j = t % 16;
#pragma unroll
  for (int i = 0; i < G::PIECES; ++i) {
    const int cb = i / G::BOX_PIECES, r = 16 * (i % G::BOX_PIECES) + t / 16;
    const uint2 v = *reinterpret_cast<const uint2*>(codes + (size_t)(t + CONSUMERS * i) * 8);
    // B box of columns cb * 128 + j * 8: 64 columns (8 KB) a box
    unsigned char* box = bt + (2 * cb + j / 8) * wg::BOX_BYTES;
    if constexpr (WT == kInt8) {
      const uint4 o = codes8<SCALE>(v.x ^ 0x80808080u, v.y ^ 0x80808080u, 128.f, s[cb]);
      *reinterpret_cast<uint4*>(box + r * 128 + ((j % 8) ^ (r % 8)) * 16) = o;
    } else {  // byte i of a packed row: k-row 2i in its low nibble, 2i + 1 in its high one
      const uint4 lo = codes8<SCALE>((v.x & 0x0F0F0F0Fu) ^ 0x08080808u,
                                     (v.y & 0x0F0F0F0Fu) ^ 0x08080808u, 8.f, s[cb]);
      const uint4 hi = codes8<SCALE>(((v.x >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                                     ((v.y >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 8.f, s[cb]);
      const int k0 = 2 * r, k1 = 2 * r + 1;
      *reinterpret_cast<uint4*>(box + k0 * 128 + ((j % 8) ^ (k0 % 8)) * 16) = lo;
      *reinterpret_cast<uint4*>(box + k1 * 128 + ((j % 8) ^ (k1 % 8)) * 16) = hi;
    }
  }
}

// NORM: normalizer thread t normalizes chunk t % 8 (8 k) of rows
// t / 8 + 12 i of the 128-row A slice in place (rs: those rows' rstd);
// all its loads are in flight before the first store
__device__ __forceinline__ void normalize(unsigned char* a, const bf16* __restrict__ nw, int t,
                                          const float (&rs)[NORM_ROWS]) {
  const int c = t % 8;
  const uint4 wv = __ldg(reinterpret_cast<const uint4*>(nw + c * 8));
  uint4 v[NORM_ROWS];
#pragma unroll
  for (int i = 0; i < NORM_ROWS; ++i) {
    const int r = t / 8 + NORMALIZERS / 8 * i;
    if (r < BM) v[i] = *reinterpret_cast<const uint4*>(a + r * 128 + ((c ^ (r % 8)) * 16));
  }
#pragma unroll
  for (int i = 0; i < NORM_ROWS; ++i) {
    const int r = t / 8 + NORMALIZERS / 8 * i;
    if (r < BM)
      *reinterpret_cast<uint4*>(a + r * 128 + ((c ^ (r % 8)) * 16)) = mm::norm8(v[i], wv, rs[i]);
  }
}

// ---- wgmma and the epilogue ---------------------------------------------------

// d (64 x 128 f32) = A (64 x 16, K-major) . B (16 x 128, MN-major) + d,
// or without the "+ d" where accumulate is 0
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// one slice's four k16 steps: A K-major (32 bytes a step), B MN-major
// (2048 bytes a step); fresh (m64n128 only): the first step overwrites d
template <int NACC>
__device__ __forceinline__ void mma_slice(float (&d)[NACC], const void* a, const void* b,
                                          bool fresh = false) {
  const uint64_t da = wg::operand_desc<false>(a), db = wg::operand_desc<true>(b);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t ka = da + ((kk * wg::k16_step<false>()) >> 4);
    const uint64_t kb = db + ((kk * wg::k16_step<true>()) >> 4);
    if constexpr (NACC == 128)
      wg::wgmma_m64n256k16<0, 1>(d, ka, kb);
    else
      wgmma_m64n128k16(d, ka, kb, kk > 0 || !fresh);
  }
}

// Pin d's registers here: the compiler may not move a read or a write of
// them across this point, so a wgmma's accumulators are touched only
// after the wait that retires it
template <int NACC>
__device__ __forceinline__ void fence_operand(float (&d)[NACC]) {
#pragma unroll
  for (int j = 0; j < NACC; ++j) asm volatile("" : "+f"(d[j])::"memory");
}

// kGroup: tot += d * the group's f32 scales (srow: the tile's scale row
// in shared memory; column 8 j + 2 q + e of d[4 j + 2 h + e], q = t % 4)
template <int NACC>
__device__ __forceinline__ void fold(float (&tot)[NACC], const float (&d)[NACC], const float* srow,
                                     int q) {
#pragma unroll
  for (int j = 0; j < NACC / 4; ++j) {
    const float2 s = *reinterpret_cast<const float2*>(srow + 8 * j + 2 * q);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tot[4 * j + 2 * h] = fmaf(d[4 * j + 2 * h], s.x, tot[4 * j + 2 * h]);
      tot[4 * j + 2 * h + 1] = fmaf(d[4 * j + 2 * h + 1], s.y, tot[4 * j + 2 * h + 1]);
    }
  }
}

// the f32 factors of columns n, n + 1 of scale row srow (zeros past N)
__device__ __forceinline__ float2 scales2(const float* __restrict__ scales, int srow, int n,
                                          int N) {
  return n < N ? __ldg(reinterpret_cast<const float2*>(scales + (size_t)srow * N + n))
               : make_float2(0.f, 0.f);
}

// ---- kGroup's consumers ------------------------------------------------------

// Consumer warpgroup c's side of every live item of a kGroup form (the
// header's kGroup notes): one partial-sum set acc and the total tot. A
// group's first slice is converted and met at the named barrier before
// the consumers wait for the group before it; that wait, the fold of acc
// (times the scale row staged with the group's last slice) into tot and
// the release of that slice's stage come after, and the slice's first
// wgmma overwrites acc (scale-d 0). Each consumer warp releases a stage.
template <class G, int WT, class Walk>
__device__ __forceinline__ void consume_grouped(const Walk& walk, uint64_t* full, uint64_t* empty,
                                                unsigned char* ring, unsigned char* btiles,
                                                const float* srows, bf16* __restrict__ y, int K,
                                                int N, int gs, int c, int t) {
  const int n_items = walk.n_items(), n_g = K / gs, q = t % 4;
  const bool signals = t % 32 == 0;
  const uint32_t no_scales[G::CODE_BOXES][4] = {};
  float acc[G::NACC], tot[G::NACC];
  int stage = 0, buf = 0, prev = -1;
  uint32_t phase = 0;
  auto release = [&](int s) {  // this warp's reads of stage s are done
    __syncwarp();
    if (signals) wg::mbar_arrive(&empty[s]);
  };
  auto fold_prev = [&] {  // acc's group is done: tot += acc * its scales
    wg::wgmma_wait<0>();
    fence_operand(acc);
    fold(tot, acc, srows + prev * (G::SROW_BYTES / 4), q);
    release(prev);
  };
  // PER (the slices of a group) at compile time: the group's slices unrolled
  auto run = [&](auto per_c) {
    constexpr int PER = decltype(per_c)::value;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
      const Item it = walk.item(i);
      if (!it.live) continue;  // a parked step: no slice came, none to release
#pragma unroll
      for (int j = 0; j < G::NACC; ++j) tot[j] = 0.f;
      prev = -1;
      for (int j = 0; j < n_g; ++j) {
#pragma unroll
        for (int s = 0; s < PER; ++s) {
          wg::mbar_wait(&full[stage], phase);
          unsigned char* st = ring + stage * G::STAGE_BYTES;
          unsigned char* bt = btiles + buf * G::B_BYTES;
          dequant<G, WT, false>(st + G::A_BYTES, bt, t, no_scales);
          wg::fence_proxy_async();
          wg::named_barrier(1, CONSUMERS);
          if (s == 0 && j > 0) fold_prev(), prev = -1;
          fence_operand(acc);
          wg::wgmma_fence();
          mma_slice(acc, st + c * wg::BOX_BYTES, bt, s == 0);
          wg::wgmma_commit();
          fence_operand(acc);
          wg::wgmma_wait<1>();  // the slice before is done: free its stage
          if (prev >= 0) release(prev);
          prev = stage;
          if (++stage == STAGES) stage = 0, phase ^= 1;
          if (++buf == B_BUFS) buf = 0;
        }
      }
      fold_prev();  // the tile's last group

      const int r0 = it.tile * BM + 64 * c, n0 = it.nt * G::BN;
      wg::store_bf16(tot, wg::Uniform{1.f}, [&](int r, int col, uint4 v) {
        const int row = r0 + r, cc = n0 + col;
        if (row >= it.lo && row < it.hi && cc < N)
          *reinterpret_cast<uint4*>(y + (size_t)row * N + cc) = v;
      });
    }
  };
  if (gs == 2 * BK)
    run(std::integral_constant<int, 2>{});
  else
    run(std::integral_constant<int, 1>{});
}

// ---- the kernel -----------------------------------------------------------------

// scales: item group g's scales start at scales + g * sstride
template <bool NORM, int WT, int SM, class Walk>
__global__ void __launch_bounds__(wg::NT, 1)
quant_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                   const bf16* __restrict__ nw, const float* __restrict__ rstd,
                   const float* __restrict__ scales, bf16* __restrict__ y, const Walk walk, int K,
                   int N, int gs, long sstride) {
  using G = Geo<WT, Walk::BN>;
  constexpr bool GROUP = SM == kGroup, TILE_SCALE = SM == kTile && !G::DENSE;
  static_assert(!GROUP || (Walk::BN == 128 && !NORM), "kGroup: a partial sum and a total, K4/K13");
  static_assert(!(G::DENSE && Walk::GROUPED), "K13's bf16 forms run wgmma_tiles.cuh");
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], normed[STAGES];
  unsigned char* ring = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* btiles = ring + STAGES * G::STAGE_BYTES;
  // kGroup: stage s's scale row (the group's, beside its last slice)
  float* srows = reinterpret_cast<float*>(btiles + B_BUFS * G::B_BYTES);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 1);  // the producer's arrive + the stage's bytes
      // one arrive per consumer warpgroup; kGroup: per consumer warp
      wg::mbar_init(&empty[s], GROUP ? CONSUMERS / 32 : 2);
      wg::mbar_init(&normed[s], NORMALIZERS);  // NORM: one arrive per normalizer
    }
    wg::fence_barrier_init();
  }
  __syncthreads();
  const int n_items = walk.n_items(), n_k = K / BK;

  if (threadIdx.x < 128) {  // the producer warpgroup
    wg::setmaxnreg_dec<NORM ? NORM_PRODUCER_REGS : wg::PRODUCER_REGS>();
    if (NORM && threadIdx.x >= 32) {  // warps 1-3: normalize each x slice in place
      const int t = threadIdx.x - 32;
      int stage = 0;
      uint32_t phase = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const Item it = walk.item(i);
        float rs[NORM_ROWS];  // rows past M (zeros) stay zeros
#pragma unroll
        for (int j = 0; j < NORM_ROWS; ++j) {
          const int row = it.tile * BM + t / 8 + NORMALIZERS / 8 * j;
          rs[j] = row < it.hi && row < it.tile * BM + BM ? rstd[row] : 0.f;
        }
        for (int kt = 0; kt < n_k; ++kt) {
          wg::mbar_wait(&full[stage], phase);
          normalize(ring + stage * G::STAGE_BYTES, nw + kt * BK, t, rs);
          wg::fence_proxy_async();
          wg::mbar_arrive(&normed[stage]);
          if (++stage == STAGES) stage = 0, phase ^= 1;
        }
      }
    }
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
      const Item it = walk.item(i);
      const int kts = it.live ? n_k : 0;  // a parked step loads nothing
      // kGroup: the scale row's columns of this tile (a multiple of 16)
      const int srow_bytes = GROUP ? min(G::BN, N - it.nt * G::BN) * 4 : 0;
      for (int kt = 0; kt < kts; ++kt) {
        const bool group_end = GROUP && (kt + 1) * BK % gs == 0;
        wg::mbar_wait(&empty[stage], phase ^ 1);  // the first pass finds it free
        wg::mbar_arrive_expect_tx(&full[stage], G::STAGE_BYTES + (group_end ? srow_bytes : 0));
        unsigned char* st = ring + stage * G::STAGE_BYTES;
        wg::tma_load_2d(st, &tx, &full[stage], kt * BK, it.tile * BM);  // x rows: 128 x 64
        if constexpr (G::DENSE) {
#pragma unroll
          for (int b = 0; b < G::BN / 64; ++b)  // W rows k: 64 x 64 columns a box
            wg::tma_load_2d(st + G::A_BYTES + b * wg::BOX_BYTES, &tb, &full[stage],
                            it.nt * G::BN + 64 * b, kt * BK);
        } else {
#pragma unroll
          for (int cb = 0; cb < G::CODE_BOXES; ++cb) {  // codes: CODE_ROWS x 128 bytes
            unsigned char* dst = st + G::A_BYTES + cb * G::CODE_BOX_BYTES;
            const int c0 = it.nt * G::BN + 128 * cb, c1 = kt * G::CODE_ROWS;
            if constexpr (Walk::GROUPED)  // the expert is the map's outer coordinate
              wg::tma_load_3d(dst, &tb, &full[stage], c0, c1, it.group);
            else
              wg::tma_load_2d(dst, &tb, &full[stage], c0, c1);
          }
        }
        if constexpr (GROUP) {
          if (group_end)  // the group's scale row, columns n0 ..
            wg::bulk_load(srows + stage * (G::SROW_BYTES / 4),
                          scales + it.group * sstride + (size_t)(kt * BK / gs) * N + it.nt * G::BN,
                          srow_bytes, &full[stage]);
        }
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // consumer warpgroup c: rows 64 c .. 64 c + 63 of each tile
  wg::setmaxnreg_inc<NORM ? NORM_CONSUMER_REGS : wg::CONSUMER_REGS>();
  const int c = threadIdx.x / 128 - 1, t = threadIdx.x - 128, tw = t % 128;
  if constexpr (GROUP) {
    consume_grouped<G, WT>(walk, full, empty, ring, btiles, srows, y, K, N, gs, c, t);
    return;
  }
  const bool signals = tw == 0;
  float acc[G::NACC];
  uint32_t sc[G::CODE_BOXES][4];  // TILE_SCALE: this thread's column scales
  int stage = 0, buf = 0;
  uint32_t phase = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const Item it = walk.item(i);
    if (!it.live) continue;  // a parked step: no slice came, none to release
    const int m0 = it.tile * BM, n0 = it.nt * G::BN;
    const float* __restrict__ scl = scales + it.group * sstride;  // this weight's scales
    if (TILE_SCALE && !gs) tile_scales<G>(sc, scl, 0, n0, N, t);
    if (G::DENSE && m0 + 64 * c >= it.hi) {
      // dense: every row of this warpgroup lies past M (a cut last row
      // tile): walk the ring and release each stage, with no wgmma and no
      // store. (A quantized warpgroup converts its half of each shared B
      // tile all the same, so it keeps the live path.) A loop of its own: a
      // wgmma under a branch inside the loop makes ptxas serialize them.
      for (int kt = 0; kt < n_k; ++kt) {
        wg::mbar_wait(&full[stage], phase);
        if (signals) wg::mbar_arrive(&empty[stage]);
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < G::NACC; ++j) acc[j] = 0.f;
    int prev = -1;
    for (int kt = 0; kt < n_k; ++kt) {
      wg::mbar_wait(&full[stage], phase);
      unsigned char* st = ring + stage * G::STAGE_BYTES;
      // dense: B is the stage's W slice; quantized: the converted B tile
      unsigned char* bt = G::DENSE ? st + G::A_BYTES : btiles + buf * G::B_BYTES;
      if constexpr (!G::DENSE) {
        if (TILE_SCALE && gs && kt * BK % gs == 0)
          tile_scales<G>(sc, scl, kt * BK / gs, n0, N, t);
        dequant<G, WT, TILE_SCALE>(st + G::A_BYTES, bt, t, sc);
      }
      if (NORM) wg::mbar_wait(&normed[stage], phase);  // the x slice is normalized
      if constexpr (!G::DENSE) {
        wg::fence_proxy_async();
        wg::named_barrier(1, CONSUMERS);
      }
      wg::wgmma_fence();
      mma_slice(acc, st + c * wg::BOX_BYTES, bt);
      wg::wgmma_commit();
      wg::wgmma_wait<1>();  // the slice before is done: free its stage
      if (prev >= 0 && signals) wg::mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == STAGES) stage = 0, phase ^= 1;
      if (++buf == B_BUFS) buf = 0;
    }
    wg::wgmma_wait<0>();
    if (prev >= 0 && signals) wg::mbar_arrive(&empty[prev]);

    const int r0 = m0 + 64 * c;
    auto put = [&](int r, int col, uint4 v) {
      const int row = r0 + r, cc = n0 + col;
      if (row >= it.lo && row < it.hi && cc < N)
        *reinterpret_cast<uint4*>(y + (size_t)row * N + cc) = v;
    };
    if constexpr (SM == kEnd)  // the column's scale times the f32 sum, once
      wg::store_bf16(acc, [&](int col) { return scales2(scl, 0, n0 + col, N); }, put);
    else
      wg::store_bf16(acc, wg::Uniform{1.f}, put);
  }
}

// Output tile i of the walk as the kernel decodes it: (row tile, column tile)
__global__ void items_kernel(int M, int N, int BN, int band, int n, int* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  gt::swizzle(i, (M + BM - 1) / BM, (N + BN - 1) / BN, band, out + 2 * i, out + 2 * i + 1);
}

// ---- host side ---------------------------------------------------------------

// A map over a row-major (rows, cols) byte array cut into unswizzled boxes
// of box_cols (a multiple of 16, <= 256) columns x box_rows; bytes past an
// edge read as zeros. depth > 0: a 3-D map over `depth` such arrays laid
// one after another (K13's expert stack), boxes one array deep. base must
// be 16-byte aligned and cols a multiple of 16.
inline cudaError_t u8_map(CUtensorMap* map, const void* base, int cols, int rows, int box_rows,
                          int box_cols = 128, int depth = 0) {
  const wg::EncodeTiled fn = wg::encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cudaError_t err = wg::bind_context();
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)depth};
  const cuuint64_t strides[2] = {(cuuint64_t)cols, (cuuint64_t)cols * rows};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, depth > 0 ? 3 : 2, const_cast<void*>(base), dims,
         strides, box, ones,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// w: the dense (K, N) bf16 W, or the codes
template <bool NORM, int WT, int SM, int BN>
cudaError_t launch_bn(const void* x, const void* nw, const float* rstd, const void* w,
                      const void* scales, void* y, int M, int K, int N, int gs,
                      cudaStream_t stream) {
  using G = Geo<WT, BN>;
  CUtensorMap tx, tb;
  const cuuint64_t dx[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint32_t bx[2] = {64, BM};
  cudaError_t err = wg::bf16_map(&tx, x, 2, dx, bx);
  if (err != cudaSuccess) return err;
  if constexpr (G::DENSE) {  // 64 k-rows x 64 columns a box (K13's forward B)
    const cuuint64_t dw[2] = {(cuuint64_t)N, (cuuint64_t)K};
    const cuuint32_t bw[2] = {64, BK};
    err = wg::bf16_map(&tb, w, 2, dw, bw);
  } else {
    err = u8_map(&tb, w, N, K / G::PACK, G::CODE_ROWS);
  }
  if (err != cudaSuccess) return err;
  const TileWalk<BN> walk{M, N, band_for(K)};
  return wg::launch_persistent(quant_wgmma_kernel<NORM, WT, SM, TileWalk<BN>>, walk.n_items(),
                               smem_bytes<WT, SM, BN>(), stream, tx, tb,
                               static_cast<const bf16*>(nw), rstd,
                               static_cast<const float*>(scales), static_cast<bf16*>(y), walk, K, N,
                               gs, 0L);
}

// K13's int8/int4 forms: y (T, N) bf16, y[r] = x[r] @ dequant(codes[g],
// scales[g]) for the rows r of group g (offsets (E + 1) int32 on the
// card); codes (E, K / PACK, N), scales (E, N) (kEnd) or (E, K / gs, N)
// (kGroup). Rows of no group are not written.
template <int WT, int SM, int BN>
cudaError_t launch_grouped(const void* x, const int* offsets, const void* codes,
                           const float* scales, void* y, int T, int K, int N, int E, int gs,
                           cudaStream_t stream) {
  using G = Geo<WT, BN>;
  CUtensorMap tx, tb;
  const cuuint64_t dx[2] = {(cuuint64_t)K, (cuuint64_t)T};
  const cuuint32_t bx[2] = {64, BM};
  cudaError_t err = wg::bf16_map(&tx, x, 2, dx, bx);
  if (err != cudaSuccess) return err;
  err = u8_map(&tb, codes, N, K / G::PACK, G::CODE_ROWS, 128, E);
  if (err != cudaSuccess) return err;
  const GroupWalk<BN> walk{offsets, T, N, E, band_for(K)};
  const long sstride = (long)(SM == kGroup ? K / gs : 1) * N;
  return wg::launch_persistent(quant_wgmma_kernel<false, WT, SM, GroupWalk<BN>>, walk.n_items(),
                               smem_bytes<WT, SM, BN>(), stream, tx, tb,
                               static_cast<const bf16*>(nullptr), static_cast<const float*>(nullptr),
                               scales, static_cast<bf16*>(y), walk, K, N, gs, sstride);
}

// The block tile's columns, the one rule for every form: 128 for kGroup
// (its partial sum and total) and where 256-wide tiles would fill at most
// half the SMs (K2's k/v projections at prefill, q and k/v in the
// batcher's waves), else 256
inline int block_n(int M, int N, int sm, int sms) {
  return sm == kGroup || 2 * item_count(M, N, 256) <= sms ? 128 : 256;
}

// y (M, N) bf16 = A @ B for M > 16 on a persistent grid; w: the dense
// bf16 W (WT kBf16, SM kTile) or the codes; rstd (NORM): M floats from
// norm_rstd_kernel. Requires K % 128 == 0, K % gs == 0, N % 8 == 0 (dense)
// or N % 16 == 0, and 16-byte-aligned x and w (kGroup: and scales).
template <bool NORM, int WT, int SM>
cudaError_t launch(const void* x, const void* nw, const float* rstd, const void* w,
                   const void* scales, void* y, int M, int K, int N, int gs, cudaStream_t stream) {
  if constexpr (SM != kGroup) {
    if (block_n(M, N, SM, wg::num_sms()) == 256)
      return launch_bn<NORM, WT, SM, 256>(x, nw, rstd, w, scales, y, M, K, N, gs, stream);
  }
  return launch_bn<NORM, WT, SM, 128>(x, nw, rstd, w, scales, y, M, K, N, gs, stream);
}

}  // namespace
}  // namespace wq
}  // namespace pt
