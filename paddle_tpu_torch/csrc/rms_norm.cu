// K6 rms_norm_fwd and K7 rms_norm_bwd: RMSNorm forward saving rstd, and its
// backward dx plus per-block partial dw.
//
// Replace paddle_tpu/ops/pallas/fused_norm_rope.py:_pallas_rms_fwd
// (_rms_fwd_kernel) and :_pallas_rms_bwd (_rms_bwd_kernel). The TPU tiles
// (block_rows, H) row blocks through VMEM; here K6 gives each row one block
// of 256 threads that holds the row in registers (H <= 8192, 16-byte
// vectors), and K7 gives each block a run of rows and keeps that run's dw
// partial in registers, one column slice per thread, so dw needs no atomics:
// the wrapper sums the (blocks, H) f32 partials, as the JAX package sums its
// per-block partials outside the kernel.
//
// Numerics follow the kernels, not _jnp_rms: f32 statistics,
// out = bf16((x * rstd) * w) rounded once;
// dx = rstd * (g*w - xhat * mean(g*w*xhat)), dw = sum_rows(g * xhat).
//
// Bound on an H100: bytes. K6 reads x and w and writes out and rstd; K7
// reads x, w, rstd and g and writes dx and the partials (8192 x 4096 bf16:
// ~134 MB and ~201 MB, 0.04 and 0.06 ms at 3.35 TB/s).
#include "common.cuh"

using pt::bf16;

namespace {

constexpr int NT = 256;
constexpr int NWARPS = NT / 32;
constexpr int MAXV = 4;  // 16-byte vectors per thread: H <= NT * 8 * MAXV
constexpr int BWD_ROWS = 32;

// deterministic block sum: warp sums, then every thread adds the warp
// partials in a fixed order
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = pt::warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NWARPS; ++i) s += red[i];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(NT)
rms_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ out,
               float* __restrict__ rstd, int H, float eps) {
  __shared__ float red[NWARPS];
  const size_t row = blockIdx.x;
  const int nvec = H / 8;
  float xf[MAXV][8];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int vi = threadIdx.x + i * NT;
    if (vi < nvec) {
      pt::unpack8(*reinterpret_cast<const uint4*>(x + row * H + vi * 8), xf[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) ss += xf[i][j] * xf[i][j];
    }
  }
  const float var = block_sum(ss, red) / static_cast<float>(H);
  const float r = rsqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int vi = threadIdx.x + i * NT;
    if (vi < nvec) {
      float wf[8], o[8];
      pt::unpack8(*reinterpret_cast<const uint4*>(w + vi * 8), wf);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = xf[i][j] * r * wf[j];
      *reinterpret_cast<uint4*>(out + row * H + vi * 8) = pt::pack8(o);
    }
  }
  if (threadIdx.x == 0) rstd[row] = r;
}

__global__ void __launch_bounds__(NT)
rms_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const float* __restrict__ rstd, const bf16* __restrict__ g,
               bf16* __restrict__ dx, float* __restrict__ dw_part, int N, int H) {
  __shared__ float red[NWARPS];
  const int nvec = H / 8;
  float wf[MAXV][8], acc[MAXV][8];
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int vi = threadIdx.x + i * NT;
    if (vi < nvec) pt::unpack8(*reinterpret_cast<const uint4*>(w + vi * 8), wf[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  const int r0 = blockIdx.x * BWD_ROWS;
  const int r1 = min(N, r0 + BWD_ROWS);
  for (int row = r0; row < r1; ++row) {
    const float r = rstd[row];
    float xh[MAXV][8], gw[MAXV][8];
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int vi = threadIdx.x + i * NT;
      if (vi < nvec) {
        float gf[8];
        pt::unpack8(*reinterpret_cast<const uint4*>(x + (size_t)row * H + vi * 8), xh[i]);
        pt::unpack8(*reinterpret_cast<const uint4*>(g + (size_t)row * H + vi * 8), gf);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          xh[i][j] *= r;
          gw[i][j] = gf[j] * wf[i][j];
          dot += gw[i][j] * xh[i][j];
          acc[i][j] += gf[j] * xh[i][j];
        }
      }
    }
    const float m = block_sum(dot, red) / static_cast<float>(H);
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int vi = threadIdx.x + i * NT;
      if (vi < nvec) {
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = r * (gw[i][j] - xh[i][j] * m);
        *reinterpret_cast<uint4*>(dx + (size_t)row * H + vi * 8) = pt::pack8(o);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int vi = threadIdx.x + i * NT;
    if (vi < nvec) {
      float* dst = dw_part + (size_t)blockIdx.x * H + vi * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j] = acc[i][j];
    }
  }
}

}  // namespace

// x (N, H) bf16, w (H,) bf16 -> out (N, H) bf16, rstd (N,) f32.
// Requires H % 8 == 0 and H <= 8192 (checked by the Python wrapper).
PT_EXPORT int pt_rms_norm_fwd(const void* x, const void* w, void* out, void* rstd, int N, int H,
                              float eps, void* stream) {
  if (N > 0)
    rms_fwd_kernel<<<N, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(out),
        static_cast<float*>(rstd), H, eps);
  return cudaGetLastError();
}

// x, g (N, H) bf16, w (H,) bf16, rstd (N,) f32 -> dx (N, H) bf16 and
// dw_part (ceil(N / 32), H) f32, one row of partial sums per block.
PT_EXPORT int pt_rms_norm_bwd(const void* x, const void* w, const void* rstd, const void* g,
                              void* dx, void* dw_part, int N, int H, void* stream) {
  const int blocks = (N + BWD_ROWS - 1) / BWD_ROWS;
  if (blocks > 0)
    rms_bwd_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const float*>(rstd), static_cast<const bf16*>(g), static_cast<bf16*>(dx),
        static_cast<float*>(dw_part), N, H);
  return cudaGetLastError();
}
