// The Hopper body of K13 (grouped_matmul.cu) and K14 (segment_dw.cu): a
// persistent, warp-specialized bf16 GEMM mainloop with the PTX pieces it is
// built from — TMA tile loads (cp.async.bulk.tensor) into a 128-byte
// swizzled ring of shared-memory stages, a full and an empty mbarrier per
// stage, wgmma.mma_async.m64n256k16 from shared-memory descriptors with f32
// accumulators in registers, and an epilogue that writes whole 16-byte
// vectors from the registers.
//
// A block is three warpgroups on one SM (one block an SM, 197 KB of shared
// memory). Warpgroup 0 is the producer: after setmaxnreg hands its
// registers to the others, one thread walks the block's work items and
// keeps STAGES slices of TMA loads in flight, each stage's full barrier
// counting its bytes. Warpgroups 1 and 2 are the consumers: each owns 64
// rows of the 128 x 256 block tile (128 f32 accumulators a thread), waits
// on a stage's full barrier, issues four k16 wgmmas on it, and releases
// the stage of the slice before (one wgmma group stays in flight) through
// its empty barrier. No block-wide barrier is passed per slice. The grid is
// persistent: block b takes items b, b + grid, ... in the order the caller
// defines, so one tile's epilogue overlaps the next tile's loads, which the
// producer issues as soon as stages free up.
//
// Operands come in two shared-memory forms, both cut by TMA into boxes of
// 64 rows x 128 bytes (64 bf16) with the 128-byte swizzle (rows 8 apart
// form a 1024-byte atom):
//   K-major  (rows of the operand's M or N, 64 k each): one box of up to
//            256 rows; descriptor SBO = 1024 (the next 8 rows), a k16 step
//            is 32 bytes along the swizzled row;
//   MN-major (rows of k, 64 M or N columns each): boxes of 64 columns
//            8 KB apart (LBO = 8192), 8 k-rows a 1024-byte group (SBO), a
//            k16 step is 2048 bytes; wgmma reads them transposed.
// K13's forward takes A = x rows (K-major) against B = w[g] (K, N)
// (MN-major); its dX form B = w[g] (N, K) (K-major); K14 A = x_e^T and
// B = dy_e, both MN-major. wgmma_quant_tiles.cuh (K2's and K4's
// quantized forms) builds its own mainloop from the pieces here.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace pt {
namespace wg {
namespace {  // each including source gets its own copy

constexpr int BM = 128, BN = 256, BK = 64;  // block tile; BK = the reduction slice
constexpr int STAGES = 4;
constexpr int NT = 384;                     // producer warpgroup + two consumers
constexpr int BOX_BYTES = 64 * 128;         // one 64-row box of 128-byte rows
constexpr int A_BYTES = BM * BK * 2;        // 2 boxes
constexpr int B_BYTES = BK * BN * 2;        // 4 boxes
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int SMEM_BYTES = RING_BYTES + 1024;  // + slack to align the ring to 1024
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrive once and add `bytes` to the transactions the current phase awaits
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}
// order this thread's generic-proxy shared-memory writes before later
// async-proxy (wgmma, TMA) accesses
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// TMA: one box of `map` at element coordinates (c0 innermost) into dst,
// completing `bytes of the box` on bar; out-of-range elements land as zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// a 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global memory into shared memory, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- thread-block clusters -----------------------------------------------

// every thread of the cluster: arrive (release), then wait (acquire); the
// two halves apart let a CTA do other work between them
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// the address of p in the shared memory of cluster rank `rank`
__device__ __forceinline__ uint32_t rank_addr(const void* p, int rank) {
  uint32_t a;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

// 4 floats at p in the shared memory of cluster rank `rank`
__device__ __forceinline__ float4 ld_rank_f4(const void* p, int rank) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(rank_addr(p, rank)));
  return v;
}

// store v at p in the shared memory of cluster rank `rank`
__device__ __forceinline__ void st_rank_f32(void* p, int rank, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(rank_addr(p, rank)), "f"(v)
               : "memory");
}
__device__ __forceinline__ void st_rank_f4(void* p, int rank, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(rank_addr(p, rank)),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout 1
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(1) << 62;
}

// The descriptor of a stage's operand and its k16 step in bytes (above)
template <bool MN>
__device__ __forceinline__ uint64_t operand_desc(const void* p) {
  return MN ? sw128_desc(p, BOX_BYTES, 1024) : sw128_desc(p, 16, 1024);
}
template <bool MN>
__host__ __device__ constexpr uint32_t k16_step() {
  return MN ? 16 * 128 : 32;
}

// d (64 x 256 f32, this warpgroup's) += A (64 x 16) . B (16 x 256), both
// from shared memory; TA / TB = 1 read that operand MN-major (transposed)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110,"
      " %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124,"
      " %125, %126, %127},"
      " %128, %129, p, 1, 1, %131, %132;\n}\n"
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
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// ---- the epilogue ------------------------------------------------------------
// Thread t of a consumer warpgroup holds d[4j + 2h + e] = D[16 w + g + 8 h]
// [8 j + 2 q + e] (w = t / 32, g = t % 32 / 4, q = t % 4): each 8-column
// chunk of a row is spread over the 4 lanes of a quad. Shuffles inside the
// quad gather whole 16-byte vectors, which put(row, col, vector) writes.

// lane q of a quad gets word q of each lane's w[q] (a 4 x 4 transpose)
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&w)[4], int q) {
  uint32_t out[4] = {w[0], w[1], w[2], w[3]};  // out[q] = w[q] is already right
#pragma unroll
  for (int r = 1; r < 4; ++r) {
    const int p = q ^ r;
    uint32_t send = w[0];
#pragma unroll
    for (int c = 1; c < 4; ++c) send = p == c ? w[c] : send;
    const uint32_t got = __shfl_xor_sync(0xffffffffu, send, r);
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = p == c ? got : out[c];
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// the factors of store_bf16's column pairs: one for every column
struct Uniform {
  float s;
  __device__ __forceinline__ float2 operator()(int) const { return make_float2(s, s); }
};

// bf16, for a 64 x (NACC / 2) tile (m64n256: NACC = 128; m64n128: 64):
// columns col, col + 1 (col = 8 j + 2 q) times scale2(col); lane q writes
// chunk 4G + q of each row (8 values, 16 bytes)
template <int NACC, typename Scale2, typename Put>
__device__ __forceinline__ void store_bf16(const float (&d)[NACC], Scale2 scale2, Put put) {
  const int t = threadIdx.x % 128, w = t / 32, g = t % 32 / 4, q = t % 4;
#pragma unroll
  for (int G = 0; G < NACC / 16; ++G)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t word[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = 4 * G + c;
        const float2 s = scale2(8 * j + 2 * q);
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(d[4 * j + 2 * h] * s.x, d[4 * j + 2 * h + 1] * s.y);
        word[c] = *reinterpret_cast<const uint32_t*>(&v);
      }
      put(16 * w + g + 8 * h, 8 * (4 * G + q), quad_transpose(word, q));
    }
}

// f32: lane q writes half q % 2 of chunk 2P + q / 2 (4 values, 16 bytes),
// held by lanes 2 (q % 2) and 2 (q % 2) + 1 of the quad
template <typename Put>
__device__ __forceinline__ void store_f32(const float (&d)[128], float scale, Put put) {
  const int t = threadIdx.x % 128, w = t / 32, g = t % 32 / 4, q = t % 4;
  const int s0 = (t % 32 & ~3) + 2 * (q % 2), s1 = s0 + 1;
#pragma unroll
  for (int P = 0; P < 16; ++P)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[2][4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = 2 * P + c;
        const float a = d[4 * j + 2 * h] * scale, b = d[4 * j + 2 * h + 1] * scale;
        v[c][0] = __shfl_sync(0xffffffffu, a, s0);
        v[c][1] = __shfl_sync(0xffffffffu, b, s0);
        v[c][2] = __shfl_sync(0xffffffffu, a, s1);
        v[c][3] = __shfl_sync(0xffffffffu, b, s1);
      }
      const int c = q / 2;
      const float4 o = c ? make_float4(v[1][0], v[1][1], v[1][2], v[1][3])
                         : make_float4(v[0][0], v[0][1], v[0][2], v[0][3]);
      put(16 * w + g + 8 * h, 8 * (2 * P + c) + 4 * (q % 2), *reinterpret_cast<const uint4*>(&o));
    }
}

// ---- the persistent mainloop ----------------------------------------------
// Work (the kernel's) gives:
//   A_MN, B_MN                    operand forms (above);
//   setup(extra)                  every thread, before the block's one
//                                 barrier (extra: shared memory past the ring);
//   n_items(), item(i)            the items in walk order; an Item has
//                                 live (consumers store it) and n_k (slices);
//   load(stage, bar, item, kt)    the producer thread's TMA loads of slice
//                                 kt: A's 2 boxes at stage, B's at
//                                 stage + A_BYTES, STAGE_BYTES in all;
//   prep(stage, item, kt)         both consumer warpgroups, before the
//                                 slice's wgmmas (K14 zeroes rows there);
//   store(acc, item, c)           consumer warpgroup c's 64 rows.
template <class Work>
__device__ __forceinline__ void run(Work work) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive + the stage's bytes
      mbar_init(&empty[s], 2);  // one arrive per consumer warpgroup
    }
    fence_barrier_init();
  }
  work.setup(ring + RING_BYTES);
  __syncthreads();
  const int n_items = work.n_items();
  if (threadIdx.x < 128) {  // the producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const auto it = work.item(i);
        for (int kt = 0; kt < it.n_k; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);  // the first pass finds it free
          mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);
          work.load(ring + stage * STAGE_BYTES, &full[stage], it, kt);
          if (++stage == STAGES) stage = 0, phase ^= 1;
        }
      }
    }
  } else {  // consumer warpgroup c
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = threadIdx.x / 128 - 1;
    const bool signals = threadIdx.x % 128 == 0;
    float acc[128];
    int stage = 0;
    uint32_t phase = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
      const auto it = work.item(i);
      if (!it.live) continue;
#pragma unroll
      for (int j = 0; j < 128; ++j) acc[j] = 0.f;
      int prev = -1;
      for (int kt = 0; kt < it.n_k; ++kt) {
        mbar_wait(&full[stage], phase);
        unsigned char* st = ring + stage * STAGE_BYTES;
        work.prep(st, it, kt);
        const uint64_t da = operand_desc<Work::A_MN>(st + c * BOX_BYTES);
        const uint64_t db = operand_desc<Work::B_MN>(st + A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_m64n256k16<Work::A_MN, Work::B_MN>(acc, da + ((kk * k16_step<Work::A_MN>()) >> 4),
                                                   db + ((kk * k16_step<Work::B_MN>()) >> 4));
        wgmma_commit();
        wgmma_wait<1>();  // the slice before is done: free its stage
        if (prev >= 0 && signals) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
      wgmma_wait<0>();
      if (prev >= 0 && signals) mbar_arrive(&empty[prev]);
      work.store(acc, it, c);
    }
  }
}

// ---- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Make the current device's primary context current in this thread. The
// driver's tensor-map encoder needs one, and a thread that has made no
// runtime call yet (an autograd worker's first launch) has none.
inline cudaError_t bind_context() {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err : cudaSetDevice(dev);
}

// A map over a row-major bf16 array of `rank` (2 or 3) dims, dims[0]
// innermost, cut into 128-byte-swizzled boxes of box[0] (<= 64) x box[1]
// (x 1) elements; elements past an edge read as zeros. base must be
// 16-byte aligned and dims[0] a multiple of 8.
inline cudaError_t bf16_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                            const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cudaError_t err = bind_context();
  if (err != cudaSuccess) return err;
  const cuuint64_t strides[2] = {dims[0] * 2, dims[0] * dims[1] * 2};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides, box,
         ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline int num_sms() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// Set the kernel's shared memory and launch it on a persistent grid of
// min(items, SMs) blocks
template <typename Kernel, typename... Args>
cudaError_t launch_persistent(Kernel kern, long items, int smem, cudaStream_t stream,
                              Args... args) {
  if (items <= 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long sms = num_sms();
  kern<<<static_cast<int>(items < sms ? items : sms), NT, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace
}  // namespace wg
}  // namespace pt
