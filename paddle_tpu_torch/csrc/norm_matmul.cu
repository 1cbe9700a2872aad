// K2 norm_matmul: y = ((x32 * rsqrt(mean(x32^2) + eps)).to(bf16) * w_norm) @ W
//
// Replaces paddle_tpu/ops/pallas/fused_norm_matmul.py:_pallas_fnm (resident,
// M <= 1024; _fnm_kernel :79) and :_pallas_fnm_streamed (M > 1024;
// _fnm_stream_kernel :189) with ONE entry point that takes any M. The
// normalized activations never touch device memory — the point of the TPU
// fusion; only rstd (M floats) does. W is dense bf16 or weight-only int8 /
// packed int4 with per-channel or group-wise scales, dequantized into the
// bf16 B tile as _fnm_kernel does (bf16(code) * bf16(scale), rounded to
// bf16).
//
// Numerics follow _pure_rms / _fnm_kernel: rstd = 1 / sqrtf(mean(x32^2) +
// eps) in f32; bf16(x32 * rstd), times w_norm, rounded to bf16 (the exact
// product of two bf16 values rounded once, which __hmul2 computes); then
// a dot with f32 accumulation and one bf16 rounding of the output.
//
// Three bodies:
//   dense bf16 W, M > 16 (prefill, train, the batcher's waves): two
//     kernels. norm_rstd_kernel writes each row's rstd once (one warp a
//     row, the summation order of matmul_tiles.cuh rows_rstd), then
//     norm_matmul_kernel runs grouped_tiles.cuh's GEMM body: 128 x 128
//     block tiles, 8 warps of 64 x 32, BK = 64, a 3-stage cp.async ring of
//     raw x and W slices, ldmatrix + mma.sync.m16n8k16 with f32
//     accumulators in registers for the whole K walk, a register epilogue
//     writing bf16. The norm is the ring's prologue: as a thread's own
//     copies of an x slice land it normalizes those 16-byte vectors in
//     place (its rows' rstd in registers for the whole walk, the w_norm
//     slice read through L1), before the one barrier that hands the slice
//     to the warps, so each x element is normalized once per block and
//     the slice costs no second barrier. (The w_norm slice is not staged
//     in the ring: a thread reads the same 16-byte vector of it as its x
//     vectors, which another thread's copy would only reach after that
//     barrier.) Blocks run in bands of row tiles (grouped_tiles.cuh
//     swizzle): a band's x rows and the W columns in flight stay in L2.
//     Where 128-row tiles would give fewer blocks than the card has SMs
//     (the batcher's M = 264 at N <= 4096, prefill's N = 1024), the tiles
//     are 64 x 128 (warps of 32 x 32), twice the blocks. A last row tile
//     that M cuts runs with as few 16-row fragments a warp as its rows
//     need (32, 64 or 128 rows: at M = 264 its 8 rows cost a quarter of a
//     full tile's products) and, where one band would hold every row
//     tile, gets a band of its own so that its light blocks launch after
//     the full ones instead of holding a second wave of full-cost blocks.
//     No split-K: two calls give the same bits (_block_order in
//     ops/kernels/fused_norm_matmul.py models the order).
//   M <= 16 (decode), any W: matmul_small_kernel (matmul_tiles.cuh), bound
//     by the bytes of W: 16x32 output tiles over >= 128 blocks at N =
//     4096, the 4 warps split K with no block barrier in the K loop, each
//     prefetching its next W slice into registers during its MMAs.
//   quantized W, M > 16: norm_rstd_kernel as above, then
//     quant_wgmma_kernel (wgmma_quant_tiles.cuh, shared with K4): the
//     K13/K14 Hopper body (TMA ring, producer warp, two consumer
//     warpgroups on wgmma, persistent banded grid) whose ring carries the
//     raw codes; the consumers dequantize each slice into a bf16 B tile
//     (bf16(code) * bf16(scale), as _fnm_kernel) while three warps of
//     the producer warpgroup normalize the x slice in place, both before
//     the slice's wgmmas.
//
// Bound on an H100: at M = 8192, K = 4096, N = 14336 (the train step's
// gate/up projections) 0.96 TFLOP of bf16 products, 0.97 ms at the 989
// TFLOP/s peak, against 0.42 GB of bytes (0.12 ms): operations. At the
// batcher's M = 264 the bytes of W bound it (0.038 ms at N = 14336).
// Shared memory 108 KB a block (3 stages of an x and a W slice), 128
// registers a thread (ptxas spills ~30 bytes): two blocks an SM. The
// quantized forms are bound by operations at prefill too (M = 1024:
// 0.12 ms at N = 14336).
#include "grouped_tiles.cuh"
#include "matmul_tiles.cuh"
#include "wgmma_quant_tiles.cuh"

namespace pt {
namespace k2 {

using namespace pt::gt;

constexpr int RSTD_ROWS = 8;  // rows a norm_rstd_kernel block (a warp each)

__global__ void __launch_bounds__(RSTD_ROWS * 32)
norm_rstd_kernel(const bf16* __restrict__ x, float* __restrict__ rstd, int M, int K, float eps) {
  __shared__ float r[RSTD_ROWS];
  const int m0 = blockIdx.x * RSTD_ROWS;
  pt::mm::rows_rstd(x, r, m0, RSTD_ROWS, M, K, eps, RSTD_ROWS);
  __syncthreads();
  if (threadIdx.x < RSTD_ROWS && m0 + threadIdx.x < M) rstd[m0 + threadIdx.x] = r[threadIdx.x];
}

// The x vectors a thread copies and normalizes: rows tid / 8 + 32 i of
// the [32 FM_][BK] slice, columns (tid % 8) * 8.
template <int FM_>
struct Rows {
  static constexpr int TM = 32 * FM_;                // rows: 2 warps of 16 FM_
  static constexpr int A_VECS = TM * (BK / 8) / NT;  // x vectors a thread
  static_assert(A_VECS >= 1 && NT % (BK / 8) == 0, "a thread's x vectors share one column");
};

// one output tile, rows [m0, m0 + 32 FM_) x columns [n0, n0 + 128), with
// grouped_tiles.cuh's ring and 2 x 4 warps of 16 FM_ x 32
template <int FM_>
__device__ __forceinline__ void tile(const bf16* __restrict__ x, const bf16* __restrict__ nw,
                                     const float* __restrict__ rstd,
                                     const bf16* __restrict__ w, bf16* __restrict__ y, int M,
                                     int K, int N, int m0, int n0, unsigned char* smem) {
  constexpr int A_VECS = Rows<FM_>::A_VECS;
  const int tid = threadIdx.x;
  const int ar = tid / (BK / 8), ac = (tid % (BK / 8)) * 8;
  float rs[A_VECS];  // rows past M: 0 (their x is staged as zeros)
#pragma unroll
  for (int i = 0; i < A_VECS; ++i) {
    const int row = m0 + ar + i * (NT / (BK / 8));
    rs[i] = row < M ? rstd[row] : 0.f;
  }

  auto load = [&](unsigned char* stage, int kt) {
    const int k0 = kt * BK;
    bf16* As = reinterpret_cast<bf16*>(stage);
    bf16* Bs = reinterpret_cast<bf16*>(stage + SLICE_BYTES);
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int r = ar + i * (NT / (BK / 8)), row = m0 + r;
      const bool ok = row < M;
      cp_async16(As + r * LD_COL + ac, ok ? x + (size_t)row * K + k0 + ac : x, ok);
    }
    for (int v = tid; v < BK * (BN / 8); v += NT) {  // Bs[k][n] = w[k0 + k][n0 + n]
      const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
      const bool ok = n0 + c < N;
      cp_async16(Bs + r * LD_ROW + c, ok ? w + (size_t)(k0 + r) * N + n0 + c : w, ok);
    }
  };
  auto prep = [&](unsigned char* stage, int kt) {
    bf16* As = reinterpret_cast<bf16*>(stage);
    const uint4 wv = __ldg(reinterpret_cast<const uint4*>(nw + kt * BK + ac));
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      uint4* p = reinterpret_cast<uint4*>(As + (ar + i * (NT / (BK / 8))) * LD_COL + ac);
      *p = mm::norm8(*p, wv, rs[i]);
    }
  };
  float acc[FM_][NI][4];
  run_ring<false, false>(smem, K / BK, load, acc, prep);
  epilogue(acc, [&](int r, int c, float v0, float v1) {
    const int row = m0 + r, col = n0 + c;
    if (row < M && col < N)
      *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * N + col) = __floats2bfloat162_rn(v0, v1);
  });
}

// a grid of (32 FM_)-row x 128-column tiles in band order; the last row
// tile, where M cuts it, runs with as few 16-row fragments a warp as its
// rows need
template <int FM_>
__global__ void __launch_bounds__(NT, 2)
norm_matmul_kernel(const bf16* __restrict__ x, const bf16* __restrict__ nw,
                   const float* __restrict__ rstd, const bf16* __restrict__ w,
                   bf16* __restrict__ y, int M, int K, int N, int band) {
  constexpr int TM = Rows<FM_>::TM;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_mt = (M + TM - 1) / TM, n_nt = (N + BN - 1) / BN;
  int mt, nt;
  swizzle(blockIdx.x, n_mt, n_nt, band, &mt, &nt);
  const int m0 = mt * TM, n0 = nt * BN, rows = M - m0;
  if (FM_ > 1 && rows <= 32)
    tile<1>(x, nw, rstd, w, y, M, K, N, m0, n0, smem);
  else if (FM_ > 2 && rows <= 64)
    tile<FM_ / 2>(x, nw, rstd, w, y, M, K, N, m0, n0, smem);
  else
    tile<FM_>(x, nw, rstd, w, y, M, K, N, m0, n0, smem);
}

template <int FM_>
cudaError_t launch_dense(const bf16* x, const bf16* nw, const bf16* w, float* rstd, bf16* y,
                         int M, int K, int N, float eps, cudaStream_t stream) {
  constexpr int TM = Rows<FM_>::TM;
  auto kern = norm_matmul_kernel<FM_>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  norm_rstd_kernel<<<(M + RSTD_ROWS - 1) / RSTD_ROWS, RSTD_ROWS * 32, 0, stream>>>(x, rstd, M, K,
                                                                                  eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_mt = (M + TM - 1) / TM, n_nt = (N + BN - 1) / BN;
  // the row tiles whose x rows fill ~16 MB of L2 together; a cut last row
  // tile (lighter) gets a band of its own, so its blocks launch last
  const int rows_fit = (16 << 20) / (TM * K * 2);
  int band = rows_fit < 1 ? 1 : (rows_fit > 16 ? 16 : rows_fit);
  if (M % TM != 0 && n_mt > 1 && band >= n_mt) band = n_mt - 1;
  kern<<<n_mt * n_nt, NT, SMEM_BYTES, stream>>>(x, nw, rstd, w, y, M, K, N, band);
  return cudaGetLastError();
}

}  // namespace k2
}  // namespace pt

using namespace pt::mm;

// x (M, K) bf16, nw (K,) bf16, w (K, N) bf16 row-major, y (M, N) bf16;
// rstd: M f32 of scratch (written and read when M > 16). Requires K % 128
// == 0 and N % 8 == 0 (checked by the Python wrapper).
PT_EXPORT int pt_norm_matmul(const void* x, const void* nw, const void* w, void* rstd, void* y,
                             int M, int K, int N, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const pt::bf16*>(x), nwp = static_cast<const pt::bf16*>(nw),
       wp = static_cast<const pt::bf16*>(w);
  auto yp = static_cast<pt::bf16*>(y);
  if (M <= small::BM) {
    matmul_small_kernel<true, kBf16, kTile><<<(N + small::BN - 1) / small::BN, small::NT, 0, s>>>(
        xp, nwp, static_cast<const unsigned char*>(w), nullptr, yp, M, K, N, 0, eps);
    return cudaGetLastError();
  }
  auto rp = static_cast<float*>(rstd);
  // 128-row tiles, or 64-row ones where the 128-row grid would leave SMs
  // without a block
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long blocks = (long)((M + 127) / 128) * ((N + pt::gt::BN - 1) / pt::gt::BN);
  return blocks < sms ? pt::k2::launch_dense<2>(xp, nwp, wp, rp, yp, M, K, N, eps, s)
                      : pt::k2::launch_dense<4>(xp, nwp, wp, rp, yp, M, K, N, eps, s);
}

// The same with a weight-only quantized W: codes int8 (K, N) (wt = 1) or
// packed int4 (K/2, N) (wt = 2); scales f32 (N,) (group_size -1) or
// (K/group_size, N); rstd as above. Requires K % 128 == 0,
// K % group_size == 0, N % 16 == 0.
PT_EXPORT int pt_norm_matmul_quant(const void* x, const void* nw, const void* codes,
                                   const void* scales, void* rstd, void* y, int M, int K, int N,
                                   int wt, int group_size, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int gs = group_size > 0 ? group_size : 0;
  if (wt != kInt8 && wt != kInt4) return cudaErrorInvalidValue;
  if (M <= small::BM)
    return wt == kInt8
               ? launch_small<true, kInt8, kTile>(x, nw, codes, scales, y, M, K, N, gs, eps, s)
               : launch_small<true, kInt4, kTile>(x, nw, codes, scales, y, M, K, N, gs, eps, s);
  auto rp = static_cast<float*>(rstd);
  pt::k2::norm_rstd_kernel<<<(M + pt::k2::RSTD_ROWS - 1) / pt::k2::RSTD_ROWS,
                             pt::k2::RSTD_ROWS * 32, 0, s>>>(static_cast<const pt::bf16*>(x), rp,
                                                             M, K, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return wt == kInt8
             ? pt::wq::launch<true, kInt8, kTile>(x, nw, rp, codes, scales, y, M, K, N, gs, s)
             : pt::wq::launch<true, kInt4, kTile>(x, nw, rp, codes, scales, y, M, K, N, gs, s);
}
