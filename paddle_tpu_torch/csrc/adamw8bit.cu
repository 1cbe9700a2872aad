// K8 adamw8bit: the one-sweep AdamW update with float8 (e4m3) blockwise
// moments, in place.
//
// Replaces paddle_tpu/ops/pallas/fused_optimizer_update.py:_pallas_adamw8bit
// (_adamw8bit_kernel). The TPU streams (32, 2048) tiles of the padded flat
// layout; here one block of 256 threads owns one 2048-element quantization
// block, 8 elements a thread: it reads the grad (bf16 or f32, no f32 copy),
// the f32 master (or the param itself), the two code blocks and their
// scales once, and writes the new master, the bf16 param, the codes and the
// scales over the old ones. Each thread rewrites only the elements it read
// and the scale is written after the block's max reduction, so updating in
// place is race-free and saves a second copy of the optimizer state.
//
// Numerics: the codes must be BIT-IDENTICAL to adamw8bit_reference. Every
// operation is the reference's, in its order, with one rounding each:
// __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn keep nvcc from contracting
// a*b + c into an FMA. The scalars (beta1, 1 - beta1, lr * lr_scale,
// 1 - beta1^t, ...) arrive rounded once to f32 from Python doubles, as the
// reference's scalar-times-array ops round them. The block scale is an
// exact max (order-free); codes are __nv_cvt_float_to_fp8 with round to
// nearest even, saturating (|m / scale| <= 448 by construction).
//
// Bound on an H100: bytes. Per element it reads 2 (bf16 grad) + 4 (master)
// + 2 (codes) and writes 4 + 2 + 2: 16 B per parameter, ~45 GB for the 2.8B
// parameters of the 8-layer Llama-3-8B train step (~13 ms at 3.35 TB/s).
#include <cuda_fp8.h>

#include "common.cuh"

using pt::bf16;

namespace {

constexpr int QB = 2048;  // elements per quantization block
constexpr int NT = 256;
constexpr int PER = QB / NT;  // 8 elements a thread

__device__ __forceinline__ float fp8_to_float(uint8_t c) {
  __half_raw h = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(c), __NV_E4M3);
  return __half2float(__half(h));
}

__device__ __forceinline__ uint8_t float_to_fp8(float x) {
  return static_cast<uint8_t>(__nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3));
}

__device__ __forceinline__ void block_max2(float& a, float& b, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  if (threadIdx.x % 32 == 0) {
    red[threadIdx.x / 32] = a;
    red[NT / 32 + threadIdx.x / 32] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) {
    a = fmaxf(a, red[i]);
    b = fmaxf(b, red[NT / 32 + i]);
  }
}

struct Scalars {
  float b1, omb1, b2, omb2, lrls, bc1, bc2, eps, wdm;
  int wd;
};

__global__ void __launch_bounds__(NT)
adamw8bit_kernel(const void* __restrict__ grad, int grad_f32, float* p32, bf16* pb,
                 uint8_t* mq, float* ms, uint8_t* vq, float* vs, long long n, Scalars sc) {
  __shared__ float red[2 * (NT / 32)];
  const long long base = (long long)blockIdx.x * QB + threadIdx.x * PER;
  const bool full = base + PER <= n;

  float g[PER], p[PER];
  if (full) {
    if (grad_f32) {
      const float4* src = reinterpret_cast<const float4*>(static_cast<const float*>(grad) + base);
      const float4 a = src[0], b = src[1];
      g[0] = a.x; g[1] = a.y; g[2] = a.z; g[3] = a.w;
      g[4] = b.x; g[5] = b.y; g[6] = b.z; g[7] = b.w;
    } else {
      pt::unpack8(*reinterpret_cast<const uint4*>(static_cast<const bf16*>(grad) + base), g);
    }
    if (p32 != nullptr) {
      const float4* src = reinterpret_cast<const float4*>(p32 + base);
      const float4 a = src[0], b = src[1];
      p[0] = a.x; p[1] = a.y; p[2] = a.z; p[3] = a.w;
      p[4] = b.x; p[5] = b.y; p[6] = b.z; p[7] = b.w;
    } else {
      pt::unpack8(*reinterpret_cast<const uint4*>(pb + base), p);
    }
  } else {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const long long e = base + j;
      const bool in = e < n;
      g[j] = !in ? 0.f
             : grad_f32 ? static_cast<const float*>(grad)[e]
                        : __bfloat162float(static_cast<const bf16*>(grad)[e]);
      p[j] = !in ? 0.f : p32 != nullptr ? p32[e] : __bfloat162float(pb[e]);
    }
  }

  const uint2 mcodes = *reinterpret_cast<const uint2*>(mq + base);
  const uint2 vcodes = *reinterpret_cast<const uint2*>(vq + base);
  const uint8_t* mc = reinterpret_cast<const uint8_t*>(&mcodes);
  const uint8_t* vc = reinterpret_cast<const uint8_t*>(&vcodes);
  const float ms_in = ms[blockIdx.x], vs_in = vs[blockIdx.x];

  float m[PER], v[PER];
  float amax_m = 0.f, amax_v = 0.f;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const float m_old = __fmul_rn(fp8_to_float(mc[j]), ms_in);
    const float v_old = __fmul_rn(fp8_to_float(vc[j]), vs_in);
    m[j] = __fadd_rn(__fmul_rn(sc.b1, m_old), __fmul_rn(sc.omb1, g[j]));
    v[j] = __fadd_rn(__fmul_rn(sc.b2, v_old), __fmul_rn(sc.omb2, __fmul_rn(g[j], g[j])));
    const float upd = __fdiv_rn(__fmul_rn(sc.lrls, __fdiv_rn(m[j], sc.bc1)),
                                __fadd_rn(__fsqrt_rn(__fdiv_rn(v[j], sc.bc2)), sc.eps));
    const float pw = sc.wd ? __fmul_rn(p[j], sc.wdm) : p[j];
    p[j] = __fsub_rn(pw, upd);
    amax_m = fmaxf(amax_m, fabsf(m[j]));
    amax_v = fmaxf(amax_v, fabsf(v[j]));
  }
  block_max2(amax_m, amax_v, red);
  const float sm = fmaxf(__fdiv_rn(amax_m, 448.f), 1e-30f);
  const float sv = fmaxf(__fdiv_rn(amax_v, 448.f), 1e-30f);

  uint2 mo, vo;
  uint8_t* mco = reinterpret_cast<uint8_t*>(&mo);
  uint8_t* vco = reinterpret_cast<uint8_t*>(&vo);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    mco[j] = float_to_fp8(__fdiv_rn(m[j], sm));
    vco[j] = float_to_fp8(__fdiv_rn(v[j], sv));
  }
  *reinterpret_cast<uint2*>(mq + base) = mo;
  *reinterpret_cast<uint2*>(vq + base) = vo;
  if (threadIdx.x == 0) {
    ms[blockIdx.x] = sm;
    vs[blockIdx.x] = sv;
  }

  if (full) {
    if (p32 != nullptr) {
      float4* dst = reinterpret_cast<float4*>(p32 + base);
      dst[0] = make_float4(p[0], p[1], p[2], p[3]);
      dst[1] = make_float4(p[4], p[5], p[6], p[7]);
    }
    if (pb != nullptr) *reinterpret_cast<uint4*>(pb + base) = pt::pack8(p);
  } else {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const long long e = base + j;
      if (e < n) {
        if (p32 != nullptr) p32[e] = p[j];
        if (pb != nullptr) pb[e] = __float2bfloat16_rn(p[j]);
      }
    }
  }
}

}  // namespace

// One parameter's update, in place. grad (n,) bf16 (grad_f32 = 0) or f32;
// p32 (n,) f32 master (or the f32 param itself), or null to read the bf16
// param; pb (n,) bf16 param to write, or null; mq/vq (nb * 2048,) e4m3 codes,
// ms/vs (nb,) f32 scales, nb = ceil(n / 2048). wd != 0 applies p *= wdm.
PT_EXPORT int pt_adamw8bit(const void* grad, int grad_f32, void* p32, void* pb, void* mq,
                           void* ms, void* vq, void* vs, long long n, float b1, float omb1,
                           float b2, float omb2, float lrls, float bc1, float bc2, float eps,
                           float wdm, int wd, void* stream) {
  const long long nb = (n + QB - 1) / QB;
  if (nb > 0x7fffffffLL) return cudaErrorInvalidValue;
  Scalars sc{b1, omb1, b2, omb2, lrls, bc1, bc2, eps, wdm, wd};
  if (nb > 0)
    adamw8bit_kernel<<<static_cast<unsigned>(nb), NT, 0, static_cast<cudaStream_t>(stream)>>>(
        grad, grad_f32, static_cast<float*>(p32), static_cast<bf16*>(pb),
        static_cast<uint8_t*>(mq), static_cast<float*>(ms), static_cast<uint8_t*>(vq),
        static_cast<float*>(vs), n, sc);
  return cudaGetLastError();
}
