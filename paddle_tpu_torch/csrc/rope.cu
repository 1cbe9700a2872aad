// K12 rope: rotate-half rotary position embedding over (B, S, H, D) rows.
//
// Replaces paddle_tpu/ops/pallas/fused_norm_rope.py:_pallas_rope
// (_rope_kernel): out = x * cos + concat(-x2, x1) * sin in f32, cast back
// to x's dtype, with the (S, D) f32 tables of the row's position, and its
// VJP (_rope_bwd): the same rope on the gradient with
// sin' = -swap_halves(sin), exact for any table. The transposed instance
// (TRANSPOSE) reads sin at the swapped column and negates it, so the
// backward is one launch and no table is built.
//
// A thread owns VEC columns c..c+VEC-1 of a row's first half and the
// matching ones of its second half, the outputs that read the same inputs:
//   out[c]       = x[c] * cos[c] + (-x[c + D/2]) * sin[c]
//   out[c + D/2] = x[c + D/2] * cos[c + D/2] + x[c] * sin[c + D/2]
// Each product and the sum are separately rounded f32 ops (no fused
// multiply-add), as the plain version's, so the two agree bit for bit.
//
// Bound on an H100: bytes (x read and out written once, the tables once a
// position), ~0.041 ms for a (4, 2048, 32, 128) bf16 q. The design moves
// those bytes at the card's rate:
//   * 16-byte accesses: VEC = 8 bf16 or 4 f32 columns a thread (the
//     vector instance, when D/2 % VEC == 0); otherwise VEC = 1 (the scalar
//     instance, any even D).
//   * The rows of one position s (B x H of them, H x D contiguous
//     elements a batch) share the tables: a thread loads its 4 x VEC table
//     values once an item and applies them to up to ROWS rows.
//   * An item is (a group of PPC positions, a chunk of RPT x ROWS rows of
//     each): a CTA of TPR x RPT x PPC threads, TPR threads a row (column
//     groups), RPT row threads and PPC position slots; a thread issues
//     the loads of its ROWS rows before it computes. At H 8 a position's
//     32 rows are only 8 KB, so a CTA takes PPC = 4 positions.
//   * Index math per row: a 32-bit j -> (b, h) split, then 64-bit offsets.
//   * A persistent grid of SMs x resident CTAs walks the items.
// ops/kernels/fused_norm_rope.py:rope_plan computes TPR, RPT, PPC, the
// chunks and the items; the launcher sizes the grid.
#include "common.cuh"

namespace pt {
namespace k12 {

constexpr int ROWS = 4;       // rows a thread has in flight (rope_plan's)
constexpr int THREADS = 256;  // the most threads a CTA (rope_plan's)

template <typename T, int VEC>
struct Vec;

template <>
struct Vec<bf16, 8> {
  typedef uint4 type;
  static __device__ __forceinline__ void unpack(const uint4& v, float* f) { unpack8(v, f); }
  static __device__ __forceinline__ uint4 pack(const float* f) { return pack8(f); }
};

template <>
struct Vec<float, 4> {
  typedef float4 type;
  static __device__ __forceinline__ void unpack(const float4& v, float* f) {
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  static __device__ __forceinline__ float4 pack(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<bf16, 1> {
  typedef bf16 type;
  static __device__ __forceinline__ void unpack(const bf16& v, float* f) {
    f[0] = __bfloat162float(v);
  }
  static __device__ __forceinline__ bf16 pack(const float* f) { return __float2bfloat16(f[0]); }
};

template <>
struct Vec<float, 1> {
  typedef float type;
  static __device__ __forceinline__ void unpack(const float& v, float* f) { f[0] = v; }
  static __device__ __forceinline__ float pack(const float* f) { return f[0]; }
};

// VEC consecutive f32 table values (16-byte loads where VEC % 4 == 0)
template <int VEC>
__device__ __forceinline__ void load_table(const float* __restrict__ p, float* f) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
      f[i] = v.x;
      f[i + 1] = v.y;
      f[i + 2] = v.z;
      f[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = __ldg(p + i);
  }
}

template <typename T, int VEC, bool TRANSPOSE>
__global__ void __launch_bounds__(THREADS)
rope_kernel(const T* __restrict__ x, const float* __restrict__ cos_t,
            const float* __restrict__ sin_t, T* __restrict__ out, int S, int H, int D,
            int rows, int tpr, int rpt, int chunks, int ppc, int items) {
  typedef Vec<T, VEC> V;
  typedef typename V::type VT;
  const int half = D / 2;
  const int groups = half / VEC;
  const int cg = threadIdx.x % tpr;
  const int rt = threadIdx.x / tpr % rpt;
  const int slot = threadIdx.x / (tpr * rpt);
  const int chunk_rows = rpt * ROWS;
  const size_t b_stride = (size_t)S * H * D;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int pg = it / chunks;
    const int s = pg * ppc + slot;
    if (s >= S) continue;
    const int j0 = (it - pg * chunks) * chunk_rows + rt;
    const int j_end = min(rows, j0 - rt + chunk_rows);
    // this thread's rows of position s: element offsets of column 0
    size_t off[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int j = j0 + u * rpt;
      const int b = j / H;
      off[u] = b * b_stride + ((size_t)s * H + (j - b * H)) * D;
    }
    for (int g = cg; g < groups; g += tpr) {
      const int c = g * VEC;
      VT lo[ROWS], hi[ROWS];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        if (j0 + u * rpt < j_end) {
          lo[u] = *reinterpret_cast<const VT*>(x + off[u] + c);
          hi[u] = *reinterpret_cast<const VT*>(x + off[u] + c + half);
        }
      }
      float cl[VEC], ch[VEC], sl[VEC], sh[VEC];
      const size_t t = (size_t)s * D + c;
      load_table<VEC>(cos_t + t, cl);
      load_table<VEC>(cos_t + t + half, ch);
      if (TRANSPOSE) {  // sin' = -swap_halves(sin)
        load_table<VEC>(sin_t + t + half, sl);
        load_table<VEC>(sin_t + t, sh);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          sl[v] = -sl[v];
          sh[v] = -sh[v];
        }
      } else {
        load_table<VEC>(sin_t + t, sl);
        load_table<VEC>(sin_t + t + half, sh);
      }
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        if (j0 + u * rpt < j_end) {
          float x1[VEC], x2[VEC], o1[VEC], o2[VEC];
          V::unpack(lo[u], x1);
          V::unpack(hi[u], x2);
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            o1[v] = __fadd_rn(__fmul_rn(x1[v], cl[v]), __fmul_rn(-x2[v], sl[v]));
            o2[v] = __fadd_rn(__fmul_rn(x2[v], ch[v]), __fmul_rn(x1[v], sh[v]));
          }
          *reinterpret_cast<VT*>(out + off[u] + c) = V::pack(o1);
          *reinterpret_cast<VT*>(out + off[u] + c + half) = V::pack(o2);
        }
      }
    }
  }
}

template <typename T, int VEC, bool TRANSPOSE>
cudaError_t launch(const void* x, const void* cos_t, const void* sin_t, void* out, int S, int H,
                   int D, int rows, int tpr, int rpt, int chunks, int ppc, int items, int sms,
                   cudaStream_t stream) {
  if (items == 0) return cudaSuccess;
  const int threads = tpr * rpt * ppc;
  if (threads < 1 || threads > THREADS) return cudaErrorInvalidConfiguration;
  static int resident[THREADS + 1];  // CTAs an SM holds, by CTA size
  if (!resident[threads]) {
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, rope_kernel<T, VEC, TRANSPOSE>, threads, 0);
    if (e != cudaSuccess) return e;
    resident[threads] = n > 0 ? n : 1;
  }
  const long long cap = (long long)sms * resident[threads];
  const int grid = static_cast<int>(items < cap ? items : cap);
  rope_kernel<T, VEC, TRANSPOSE><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<T*>(out), S, H, D, rows, tpr, rpt, chunks,
      ppc, items);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_dir(int transpose, const void* x, const void* cos_t, const void* sin_t,
                       void* out, int S, int H, int D, int rows, int tpr, int rpt, int chunks,
                       int ppc, int items, int sms, cudaStream_t stream) {
  return transpose ? launch<T, VEC, true>(x, cos_t, sin_t, out, S, H, D, rows, tpr, rpt, chunks,
                                          ppc, items, sms, stream)
                   : launch<T, VEC, false>(x, cos_t, sin_t, out, S, H, D, rows, tpr, rpt, chunks,
                                           ppc, items, sms, stream);
}

}  // namespace k12
}  // namespace pt

// x (B, S, H, D) contiguous, bf16 (is_bf16 = 1) or f32, D even; cos/sin
// (S, D) f32 contiguous -> out like x; transpose = 1 is the VJP (sin' =
// -swap_halves(sin)). vec (8 / 4 / 1: 16-byte or scalar columns), tpr, rpt,
// chunks, ppc and items are rope_plan's; sms sizes the grid.
PT_EXPORT int pt_rope(const void* x, const void* cos_t, const void* sin_t, void* out, int B,
                      int S, int H, int D, int is_bf16, int transpose, int vec, int tpr, int rpt,
                      int chunks, int ppc, int items, int sms, void* stream) {
  using namespace pt::k12;
  auto st = static_cast<cudaStream_t>(stream);
  const int rows = B * H;
  if (is_bf16) {
    if (vec == 8)
      return launch_dir<pt::bf16, 8>(transpose, x, cos_t, sin_t, out, S, H, D, rows, tpr, rpt,
                                     chunks, ppc, items, sms, st);
    if (vec == 1)
      return launch_dir<pt::bf16, 1>(transpose, x, cos_t, sin_t, out, S, H, D, rows, tpr, rpt,
                                     chunks, ppc, items, sms, st);
  } else {
    if (vec == 4)
      return launch_dir<float, 4>(transpose, x, cos_t, sin_t, out, S, H, D, rows, tpr, rpt,
                                  chunks, ppc, items, sms, st);
    if (vec == 1)
      return launch_dir<float, 1>(transpose, x, cos_t, sin_t, out, S, H, D, rows, tpr, rpt,
                                  chunks, ppc, items, sms, st);
  }
  return cudaErrorInvalidValue;
}
