// K2 norm_matmul: y = ((x32 * rsqrt(mean(x32^2) + eps)).to(bf16) * w_norm) @ W
//
// Replaces paddle_tpu/ops/pallas/fused_norm_matmul.py:_pallas_fnm (resident,
// M <= 1024) and :_pallas_fnm_streamed (M > 1024) with ONE entry point that
// takes any M: a block owns an output tile, computes its rows' rstd once (a
// full-K pass over x, which stays in L2), then walks K in slices,
// normalizing each x slice into shared memory as it lands and feeding bf16
// tensor-core tiles (nvcuda::wmma, f32 accumulate) from there. The
// normalized activations never touch device memory — the point of the TPU
// fusion.
//
// Numerics follow _pure_rms / _fnm_kernel: f32 statistics, cast back to
// bf16 BEFORE the norm-weight multiply, that multiply rounded to bf16, then
// a dot with f32 accumulation and one bf16 rounding of the output.
//
// Bound on an H100: at decode (M = batch <= 16) the kernel is bound by the
// bytes of W (2*K*N). The small-M kernel therefore keeps W loads in flight:
// 16x32 output tiles spread W over >= 128 blocks at N = 4096, the block's
// 4 warps split K among themselves with no block barrier in the K loop,
// and each warp prefetches its next W slice into registers while its
// tensor cores work on the current one; the 4 partial sums meet in shared
// memory at the end (a fixed order, so results are deterministic). At
// prefill (M = 1024) the kernel is bound by tensor-core operations; 64x128
// tiles keep 8 accumulator fragments per warp. No cp.async/TMA/wgmma yet
// (a later PR's work).
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using pt::bf16;

namespace {

// rstd of rows [m0, m0 + rows) into rstd[]: warp w takes rows w, w+nwarps..
__device__ __forceinline__ void rows_rstd(const bf16* __restrict__ x, float* rstd, int m0,
                                          int rows, int M, int K, float eps, int nwarps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += nwarps) {
    const int row = m0 + r;
    float s = 0.f;
    if (row < M) {
      const bf16* xr = x + (size_t)row * K;
#pragma unroll 4
      for (int k = lane * 8; k < K; k += 256) {
        float f[8];
        pt::unpack8(*reinterpret_cast<const uint4*>(xr + k), f);
#pragma unroll
        for (int j = 0; j < 8; ++j) s += f[j] * f[j];
      }
    }
    s = pt::warp_sum(s);
    if (lane == 0) rstd[r] = row < M ? 1.f / sqrtf(s / (float)K + eps) : 0.f;
  }
}

// 8 normalized bf16 of row `row` at column k: bf16(x * rstd) * w_norm,
// rounded to bf16 (zeros past M)
__device__ __forceinline__ uint4 norm8(const bf16* __restrict__ x, const bf16* __restrict__ nw,
                                       int row, int M, int K, int k, float rs) {
  if (row >= M) return make_uint4(0u, 0u, 0u, 0u);
  float xf[8], wf[8], o[8];
  pt::unpack8(*reinterpret_cast<const uint4*>(x + (size_t)row * K + k), xf);
  pt::unpack8(*reinterpret_cast<const uint4*>(nw + k), wf);
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = __bfloat162float(__float2bfloat16(xf[j] * rs)) * wf[j];
  return pt::pack8(o);
}

// ---- small M (decode): one 16x32 tile per block, K split over 4 warps
namespace small {
constexpr int BM = 16, BN = 32, BK = 64, NWARPS = 4, NT = NWARPS * 32;
constexpr int LDA = BK + 8;  // bf16
constexpr int LDB = BN + 8;  // bf16
constexpr int LDC = BN + 4;  // f32
constexpr int A_BYTES = BM * LDA * 2;
constexpr int WARP_BYTES = A_BYTES + BK * LDB * 2;
constexpr int B_VECS = BK * BN / 8 / 32;  // 16-byte W vectors per lane per slice
static_assert(NWARPS * BM * LDC * 4 <= NWARPS * WARP_BYTES, "epilogue reuse");
}  // namespace small

__global__ void __launch_bounds__(small::NT)
norm_matmul_small_kernel(const bf16* __restrict__ x, const bf16* __restrict__ nw,
                         const bf16* __restrict__ w, bf16* __restrict__ y, int M, int K, int N,
                         float eps) {
  using namespace small;
  __shared__ __align__(128) unsigned char smem[NWARPS * WARP_BYTES];
  __shared__ float rstd[BM];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * BN;
  bf16* As = reinterpret_cast<bf16*>(smem + warp * WARP_BYTES);
  bf16* Bs = reinterpret_cast<bf16*>(smem + warp * WARP_BYTES + A_BYTES);

  rows_rstd(x, rstd, 0, BM, M, K, eps, NWARPS);
  __syncthreads();

  // W slice [k0, k0+BK) x [n0, n0+BN) as 16-byte vectors, lane-strided
  uint4 breg[B_VECS];
  auto load_b = [&](int k0) {
#pragma unroll
    for (int t = 0; t < B_VECS; ++t) {
      const int i = lane + t * 32, r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      breg[t] = n0 + c < N ? *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * N + n0 + c)
                           : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  int k0 = warp * BK;
  if (k0 < K) load_b(k0);
  for (; k0 < K; k0 += NWARPS * BK) {
    for (int i = lane; i < BM * (BK / 8); i += 32) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(As + r * LDA + c) = norm8(x, nw, r, M, K, k0 + c, rstd[r]);
    }
#pragma unroll
    for (int t = 0; t < B_VECS; ++t) {
      const int i = lane + t * 32, r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(Bs + r * LDB + c) = breg[t];
    }
    __syncwarp();
    if (k0 + NWARPS * BK < K) load_b(k0 + NWARPS * BK);  // in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, As + kk, LDA);
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Bs + kk * LDB + j * 16, LDB);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncwarp();
  }

  __syncthreads();  // every warp is done with its A/B slices
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
    wmma::store_matrix_sync(Cs + warp * BM * LDC + j * 16, acc[j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * (BN / 8); i += NT) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    if (r < M && n0 + c < N) {
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < NWARPS; ++q) s += Cs[q * BM * LDC + r * LDC + c + e];
        f[e] = s;
      }
      *reinterpret_cast<uint4*>(y + (size_t)r * N + n0 + c) = pt::pack8(f);
    }
  }
}

// ---- larger M (prefill): (BM, BN) tiles, warps split the tile
template <int BM, int BN, int BK, int WM, int WN>
struct NmTile {
  static constexpr int kWarpsM = BM / WM;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = kWarpsM * kWarpsN * 32;
  static constexpr int kLda = BK + 8;  // bf16; rows stay 32-byte aligned
  static constexpr int kLdb = BN + 8;
  static constexpr int kLdc = BN + 4;  // f32
  static constexpr int kABytes = BM * kLda * 2;
  static constexpr int kBBytes = BK * kLdb * 2;
  static constexpr int kLoopBytes = kABytes + kBBytes + BM * 4;
  static constexpr int kEpiBytes = BM * kLdc * 4;
  static constexpr int kSmem = kLoopBytes > kEpiBytes ? kLoopBytes : kEpiBytes;
};

template <int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__(NmTile<BM, BN, BK, WM, WN>::kThreads)
norm_matmul_kernel(const bf16* __restrict__ x, const bf16* __restrict__ nw,
                   const bf16* __restrict__ w, bf16* __restrict__ y, int M,
                   int K, int N, float eps) {
  using T = NmTile<BM, BN, BK, WM, WN>;
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int NT = T::kThreads, NWARPS = NT / 32;
  __shared__ __align__(128) unsigned char smem[T::kSmem];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + T::kABytes);
  float* rstd = reinterpret_cast<float*>(smem + T::kABytes + T::kBBytes);
  float* Cs = reinterpret_cast<float*>(smem);  // epilogue reuse

  const int tid = threadIdx.x, warp = tid / 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  rows_rstd(x, rstd, m0, BM, M, K, eps, NWARPS);  // once per block
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x slice -> normalized bf16 A tile
    for (int i = tid; i < BM * (BK / 8); i += NT) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(As + r * T::kLda + c) =
          norm8(x, nw, m0 + r, M, K, k0 + c, rstd[r]);
    }
    // W slice -> B tile
    for (int i = tid; i < BK * (BN / 8); i += NT) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const int col = n0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (col < N) v = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * N + col);
      *reinterpret_cast<uint4*>(Bs + r * T::kLdb + c) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * WM + i * 16) * T::kLda + kk, T::kLda);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * T::kLdb + wn * WN + j * 16, T::kLdb);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // ---- epilogue: f32 tile through shared memory, one bf16 rounding
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * WM + i * 16) * T::kLdc + wn * WN + j * 16,
                              acc[i][j], T::kLdc, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * (BN / 8); i += NT) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const int row = m0 + r, col = n0 + c;
    if (row < M && col < N)
      *reinterpret_cast<uint4*>(y + (size_t)row * N + col) = pt::pack8(Cs + r * T::kLdc + c);
  }
}

template <int BM, int BN, int BK, int WM, int WN>
cudaError_t launch(const bf16* x, const bf16* nw, const bf16* w, bf16* y, int M, int K,
                   int N, float eps, cudaStream_t stream) {
  using T = NmTile<BM, BN, BK, WM, WN>;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  norm_matmul_kernel<BM, BN, BK, WM, WN><<<grid, T::kThreads, 0, stream>>>(x, nw, w, y, M, K,
                                                                           N, eps);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) bf16, nw (K,) bf16, w (K, N) bf16 row-major, y (M, N) bf16.
// Requires K % 128 == 0 and N % 8 == 0 (checked by the Python wrapper).
PT_EXPORT int pt_norm_matmul(const void* x, const void* nw, const void* w, void* y, int M,
                             int K, int N, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const bf16*>(x);
  auto nwp = static_cast<const bf16*>(nw);
  auto wp = static_cast<const bf16*>(w);
  auto yp = static_cast<bf16*>(y);
  if (M <= small::BM) {
    norm_matmul_small_kernel<<<(N + small::BN - 1) / small::BN, small::NT, 0, s>>>(
        xp, nwp, wp, yp, M, K, N, eps);
    return cudaGetLastError();
  }
  return launch<64, 128, 32, 32, 64>(xp, nwp, wp, yp, M, K, N, eps, s);
}
