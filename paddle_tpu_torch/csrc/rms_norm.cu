// K6 rms_norm_fwd and K7 rms_norm_bwd: RMSNorm forward saving rstd, and its
// backward dx and dw.
//
// Replace paddle_tpu/ops/pallas/fused_norm_rope.py:_pallas_rms_fwd
// (_rms_fwd_kernel) and :_pallas_rms_bwd (_rms_bwd_kernel). The TPU tiles
// (block_rows, H) row blocks through VMEM; here K6 gives each row one block
// of 256 threads that holds the row in registers (H <= 8192, 16-byte
// vectors).
//
// K7 is two launches. rms_bwd_kernel runs one CTA an SM (a grid of
// min(N, SMs)), each over a contiguous run of rows, 8 worker warps and a
// producer warp:
//   - the producer's lane 0 bulk-copies each row's x and g (cp.async.bulk,
//     2H bytes each) into a ring of `slots` row slots in shared memory
//     (~128 KB, 8 slots at H = 4096), one full and one empty mbarrier a
//     slot, so the next rows' bytes are in flight while a row is reduced;
//   - row i belongs to warp i % 8: it reads the row from its slot (w staged
//     in shared memory once), sums g*w*xhat over its lanes and with warp
//     shuffles (no block barrier), then writes dx;
//   - every worker thread also adds g * xhat of each row into its own
//     columns' dw partial (t + 256 v, in registers), in row order; each
//     warp then releases the slot on its empty barrier;
// and writes the CTA's partial, one (H,) f32 row. rms_dw_sum_kernel then
// sums the min(N, SMs) partials of each column in a fixed order (CTA
// chunks of 8, then the chunks in order). No float atomics: two calls give
// the same bits.
//
// Numerics follow the kernels, not _jnp_rms: f32 statistics,
// out = bf16((x * rstd) * w) rounded once;
// dx = rstd * (g*w - xhat * mean(g*w*xhat)), dw = sum_rows(g * xhat).
//
// Bound on an H100: bytes. K6 reads x and w and writes out and rstd; K7
// reads x, w, rstd and g and writes dx and dw (8192 x 4096 bf16: ~134 MB
// and ~201 MB, 0.04 and 0.06 ms at 3.35 TB/s); its partials (132 x H f32,
// 2.2 MB at H = 4096) stay in L2 for the sum.
#include "common.cuh"
#include "wgmma_tiles.cuh"  // mbarrier and bulk-copy PTX

using pt::bf16;

namespace {

constexpr int NT = 256;
constexpr int NWARPS = NT / 32;
constexpr int MAXV = 4;  // 16-byte vectors per thread: H <= NT * 8 * MAXV
// K7: worker warps (a row each in turn) and the producer warp
constexpr int BWD_WARPS = 8, BWD_NT = 32 * (BWD_WARPS + 1);
constexpr int MAX_SLOTS = 16, SLOT_BUDGET = 128 << 10;  // the ring's bytes

// K7's ring: row slots of x and g (4H bytes each) in ~SLOT_BUDGET
inline int bwd_slots(int H) {
  const int s = SLOT_BUDGET / (4 * H);
  return s < 2 ? 2 : (s > MAX_SLOTS ? MAX_SLOTS : s);
}

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

// dw_part[blockIdx.x] = this CTA's rows' sum of g * xhat; dx written
__global__ void __launch_bounds__(BWD_NT, 1)
rms_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const float* __restrict__ rstd, const bf16* __restrict__ g,
               bf16* __restrict__ dx, float* __restrict__ dw_part, int N, int H, int slots) {
  namespace wg = pt::wg;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[MAX_SLOTS], empty[MAX_SLOTS];
  const int nvec = H / 8, row_bytes = 2 * H;
  const uint4* ws = reinterpret_cast<const uint4*>(smem);  // w, then the slots
  unsigned char* ring = smem + row_bytes;
  const int r0 = (int)((long)N * blockIdx.x / gridDim.x);
  const int rows = (int)((long)N * (blockIdx.x + 1) / gridDim.x) - r0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      wg::mbar_init(&full[s], 1);           // the producer's arrive + the row's bytes
      wg::mbar_init(&empty[s], BWD_WARPS);  // one arrive per worker warp
    }
    wg::fence_barrier_init();
  }
  for (int v = threadIdx.x; v < nvec; v += BWD_NT)
    reinterpret_cast<uint4*>(smem)[v] = reinterpret_cast<const uint4*>(w)[v];
  __syncthreads();

  if (warp == BWD_WARPS) {  // the producer: row i into slot i % slots
    if (lane == 0)
      for (int i = 0; i < rows; ++i) {
        const int s = i % slots;
        if (i >= slots) wg::mbar_wait(&empty[s], (i / slots - 1) & 1);
        unsigned char* dst = ring + (size_t)s * 2 * row_bytes;
        const size_t at = (size_t)(r0 + i) * H;
        wg::mbar_arrive_expect_tx(&full[s], 2 * row_bytes);
        wg::bulk_load(dst, x + at, row_bytes, &full[s]);
        wg::bulk_load(dst + row_bytes, g + at, row_bytes, &full[s]);
      }
    return;
  }

  float acc[MAXV][8];  // dw of columns 8 (t + 256 v) ..
#pragma unroll
  for (int v = 0; v < MAXV; ++v)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[v][j] = 0.f;
  for (int i = 0; i < rows; ++i) {
    const int s = i % slots;
    wg::mbar_wait(&full[s], (i / slots) & 1);
    const uint4* xs = reinterpret_cast<const uint4*>(ring + (size_t)s * 2 * row_bytes);
    const uint4* gs = xs + nvec;
    const float r = rstd[r0 + i];
    if (i % BWD_WARPS == warp) {  // this warp's row: the mean, then dx
      float dot = 0.f;
      for (int v = lane; v < nvec; v += 32) {
        float xf[8], gf[8], wf[8];
        pt::unpack8(xs[v], xf);
        pt::unpack8(gs[v], gf);
        pt::unpack8(ws[v], wf);
#pragma unroll
        for (int j = 0; j < 8; ++j) dot += gf[j] * wf[j] * (xf[j] * r);
      }
      const float m = pt::warp_sum(dot) / static_cast<float>(H);
      bf16* out = dx + (size_t)(r0 + i) * H;
      for (int v = lane; v < nvec; v += 32) {
        float xf[8], gf[8], wf[8], o[8];
        pt::unpack8(xs[v], xf);
        pt::unpack8(gs[v], gf);
        pt::unpack8(ws[v], wf);
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = r * (gf[j] * wf[j] - (xf[j] * r) * m);
        reinterpret_cast<uint4*>(out)[v] = pt::pack8(o);
      }
    }
#pragma unroll
    for (int v = 0; v < MAXV; ++v) {  // every worker: its columns' dw
      const int vi = threadIdx.x + v * BWD_WARPS * 32;
      if (vi < nvec) {
        float xf[8], gf[8];
        pt::unpack8(xs[vi], xf);
        pt::unpack8(gs[vi], gf);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[v][j] += gf[j] * (xf[j] * r);
      }
    }
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&empty[s]);
  }
#pragma unroll
  for (int v = 0; v < MAXV; ++v) {
    const int vi = threadIdx.x + v * BWD_WARPS * 32;
    if (vi < nvec) {
      float4* dst = reinterpret_cast<float4*>(dw_part + (size_t)blockIdx.x * H + vi * 8);
      dst[0] = make_float4(acc[v][0], acc[v][1], acc[v][2], acc[v][3]);
      dst[1] = make_float4(acc[v][4], acc[v][5], acc[v][6], acc[v][7]);
    }
  }
}

// dw[c] = the sum of the P partials' column c: 8 chunks of every 8th
// partial (32 float4 columns a block), then the chunks in order
__global__ void __launch_bounds__(256)
rms_dw_sum_kernel(const float* __restrict__ parts, float* __restrict__ dw, int P, int H) {
  __shared__ float4 red[8][32];
  const int lane = threadIdx.x % 32, chunk = threadIdx.x / 32;
  const int cv = blockIdx.x * 32 + lane, nv = H / 4;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (cv < nv)
    for (int b = chunk; b < P; b += 8) {
      const float4 p = reinterpret_cast<const float4*>(parts + (size_t)b * H)[cv];
      s.x += p.x, s.y += p.y, s.z += p.z, s.w += p.w;
    }
  red[chunk][lane] = s;
  __syncthreads();
  if (chunk == 0 && cv < nv) {
    for (int k = 1; k < 8; ++k) {
      const float4 p = red[k][lane];
      s.x += p.x, s.y += p.y, s.z += p.z, s.w += p.w;
    }
    reinterpret_cast<float4*>(dw)[cv] = s;
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

// x, g (N, H) bf16, w (H,) bf16, rstd (N,) f32 -> dx (N, H) bf16 and dw
// (H,) f32, through dw_part (grid, H) f32 scratch: rms_bwd_kernel on
// `grid` CTAs (min(N, SMs), fused_norm_rope.bwd_plan), then
// rms_dw_sum_kernel. Requires H % 8 == 0, H <= 8192 and 16-byte-aligned
// x and g (checked by the Python wrapper).
PT_EXPORT int pt_rms_norm_bwd(const void* x, const void* w, const void* rstd, const void* g,
                              void* dx, void* dw_part, void* dw, int N, int H, int grid,
                              void* stream) {
  if (N <= 0 || grid <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const int slots = bwd_slots(H), smem = 2 * H + slots * 4 * H;
  cudaError_t err =
      cudaFuncSetAttribute(rms_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  rms_bwd_kernel<<<grid, BWD_NT, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(rstd),
      static_cast<const bf16*>(g), static_cast<bf16*>(dx), static_cast<float*>(dw_part), N, H,
      slots);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rms_dw_sum_kernel<<<(H / 4 + 31) / 32, 256, 0, s>>>(static_cast<const float*>(dw_part),
                                                      static_cast<float*>(dw), grid, H);
  return cudaGetLastError();
}
