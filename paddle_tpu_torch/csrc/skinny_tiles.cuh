// The small-M (decode, M <= 16) body of K2 (norm_matmul.cu) and K4
// (quant_matmul.cu): the M <= 16 form of
// paddle_tpu/ops/pallas/fused_norm_matmul.py:_pallas_fnm (dense, int8 and
// int4 W) and of quant_matmul.py:_pallas_quant_matmul (_qmm_kernel).
//
//   y = A @ W,  A = rms_norm(x) (NORM, K2) or x (K4), x (M <= 16, K) bf16
//
// Bound on an H100 by the bytes of W: K x N x 2 dense, K x N int8, K x N / 2
// int4 (a decode step's gate/up projection, 4096 x 14336 bf16: 117 MB, 35 us
// at 3.35 TB/s), against at most 2 x 16 x K x N products. So the body is a
// W stream that keeps every SM's share of the card's bytes in flight, with
// the arithmetic fitted around it:
//
// Operands swapped: y^T = W^T . x^T. A 64-column W tile is the wgmma's A
// operand, 64 output channels in its 64 rows, read MN-major (transposed)
// from shared memory; x^T is its B operand, K-major, n8 for M <= 8 and n16
// for M <= 16 (the MB bucket), so no MMA row is padding. A dense W tile
// reaches wgmma straight from the ring (K13's forward B boxes: 64 columns x
// 128 k-rows, 128-byte swizzle). Quantized codes ride the ring as raw bytes
// (unswizzled 64-column boxes) and the consumer warpgroup turns each slice
// into a bf16 tile in the same swizzled layout (wgmma_quant_tiles.cuh
// codes8: exact; K2 also multiplies by the channel's bf16 scale there,
// _fnm_kernel's rule). K4 scales the f32 sums: per channel once at the end
// (kEnd), group-wise each group's partial sum (kGroup). wgmma rather than
// mma.sync: the tensor cores read the W tile from the stage through a
// descriptor, with no ldmatrix or register staging in between. The codes
// go through a shared-memory tile rather than registers in the A-fragment
// layout: a fragment pairs two k-rows of one channel, which lie a row of
// codes apart, and Hopper has no 8-bit ldmatrix to gather them.
//
// A block is 8 warps. Warp 0's lane 0 is the producer: into each free ring
// stage it issues one slice (128 k-rows) of the tile's 64 W columns by TMA,
// the same k-rows of x (MB rows, zeros past M: two K-major 128-byte-swizzled
// boxes) by TMA and, for K2, of w_norm by a bulk copy, all completing on
// the stage's full barrier (full/empty mbarrier pairs, wgmma_tiles.cuh).
// It fills the whole ring before anything reads x, since W does not depend
// on it. K2: rstd is computed in the block meanwhile, by all 8 warps in
// rows_rstd's order (a row gets the same bits whatever N, tile or cluster
// rank, and as norm_rstd_kernel gives the M > 16 body); then warps 1-3
// normalize each landed x slice in place (bf16(x * rstd) * w_norm, norm8)
// and arrive on the stage's normed barrier. Warps 4-7 are the consumer
// warpgroup: per slice eight k16 wgmmas (m64n8k16 or m64n16k16), one group
// in flight, the stage released when its group is done.
//
// The grid (plan_for, one rule; quant_matmul.small_plan mirrors it): T =
// ceil(N / 64) tiles; a cluster of cs CTAs (cs in 1, 2, 4, 8: the least
// whose T x cs CTAs cover 7/8 of the SMs, at most K / 128 slices) splits a
// tile's K into contiguous ranges of whole slices, so of whole scale
// groups. At the end each CTA writes its f32 partial tile into its shared
// memory, and rank 0 adds the other ranks' from distributed shared memory
// (mapa, barrier.cluster) in rank order, scales (kEnd) and writes bf16: no
// workspace, no atomics, two calls give the same bits. Where T x cs would
// exceed two CTAs an SM (the LM head), cs is 1 and 2 x SMs CTAs walk the
// tiles persistently (CTA b takes tiles b, b + grid, ...), the ring running
// on across tiles. items_kernel / quant_matmul.small_items model the walk.
//
// Shared memory: a ring of (W slice + x slice) stages, two bf16 A tiles
// when quantized (a buffer is reused two slices later, after a barrier has
// seen every warp retire its wgmmas), w_norm slices, the partial tile: at
// MB = 16, 87 KB dense (4 stages), 111 KB int8 (6), 103 KB int4 (8), so
// two CTAs an SM with 64, 48 and 32 KB of W in flight each. The tensor
// maps are encoded once per (pointer, shape) and cached: W's are static,
// and the caching allocator hands x the same few addresses step after
// step. A CUDA graph capturing these calls keeps the cache valid only as
// long as the tensors stay at their addresses.
#pragma once

#include <map>
#include <mutex>
#include <tuple>

#include "wgmma_quant_tiles.cuh"

namespace pt {
namespace sk {
namespace {  // each including source gets its own copy

using mm::kBf16;
using mm::kEnd;
using mm::kGroup;
using mm::kInt4;
using mm::kInt8;
using mm::kTile;

constexpr int BN = 64;          // output channels a tile: the wgmma's 64 rows
constexpr int BK = 128;         // k-rows a ring slice
constexpr int NT = 256;         // warp 0 producer, 1-3 normalizers, 4-7 consumers
constexpr int NORMALIZERS = 96;
constexpr int PLD = BN + 4;     // f32 row stride of the partial tile
constexpr int MAX_CS = 8;       // the largest portable cluster

template <int WT, int MB>
struct Geo {
  static constexpr bool DENSE = WT == kBf16;
  static constexpr int W_ROWS = WT == kInt4 ? BK / 2 : BK;  // rows of W's box a slice
  static constexpr int W_BYTES = W_ROWS * BN * (DENSE ? 2 : 1);
  static constexpr int X_BOX = MB * 128;                     // MB rows x 64 k, swizzled
  static constexpr int STAGE_BYTES = W_BYTES + 2 * X_BOX;    // a multiple of 1024
  static constexpr int STAGES = DENSE ? 4 : WT == kInt8 ? 6 : 8;
  static constexpr int NW_BYTES = BK * 2;                    // a slice of w_norm
  static constexpr int A_BYTES = BK * BN * 2;                // a dequantized bf16 tile
  static constexpr int A_BUFS = DENSE ? 0 : 2;
  static constexpr int SMEM_BYTES = 1024 + STAGES * (STAGE_BYTES + NW_BYTES) +
                                    A_BUFS * A_BYTES + MB * PLD * 4;
};

// ---- the walk --------------------------------------------------------------

struct Plan {
  int cs, grid;  // cluster size, CTAs
};

__host__ __device__ inline int tiles_for(int N) { return (N + BN - 1) / BN; }

// The one rule for every form (quant_matmul.small_plan): the least cluster
// size whose CTAs cover 7/8 of the SMs (K split no finer than a slice a
// rank), and a persistent grid of two CTAs an SM where the tiles alone
// exceed that (cs is then 1)
__host__ __device__ inline Plan plan_for(int N, int K, int sms) {
  const int T = tiles_for(N), S = K / BK;
  int cs = 1;
  while (cs < MAX_CS && 2 * cs <= S && 8 * T * cs < 7 * sms) cs *= 2;
  return {cs, T * cs > 2 * sms ? 2 * sms : T * cs};
}

// CTA b's cluster rank, first tile and tile stride, and its slices [lo, hi)
// of K: rank r of cs takes slices S r / cs .. S (r + 1) / cs
struct Walk {
  int rank, first, stride, lo, hi;
  __host__ __device__ Walk(int b, int grid, int cs, int S)
      : rank(b % cs), first(b / cs), stride(grid / cs), lo(S * (b % cs) / cs),
        hi(S * (b % cs + 1) / cs) {}
};

// ---- PTX -------------------------------------------------------------------

__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d (64 x MB f32) += A (64 x 16: W^T, MN-major) . B (16 x MB: x^T, K-major)
template <int MB>
__device__ __forceinline__ void wgmma_tn(float (&d)[MB / 2], uint64_t da, uint64_t db) {
  if constexpr (MB == 8) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(da), "l"(db), "r"(1));
  }
}

// ---- the stages ----------------------------------------------------------------

// K2's normalizer thread t (0-95): the landed x slice in place, rows below
// M (those past M are TMA's zeros). Vector t + 96 i is row (t + 96 i) / 16,
// 16-byte chunk c = t % 16 of the slice (box c / 8, swizzled chunk c % 8);
// nws: the slice's w_norm. All loads are in flight before the first store.
template <int MB>
__device__ __forceinline__ void normalize_x(unsigned char* xs, const unsigned char* nws,
                                            const float* rstd, int M, int t) {
  constexpr int PER = (MB * 16 + NORMALIZERS - 1) / NORMALIZERS;
  const int c = t % 16;
  const uint4 wv = *reinterpret_cast<const uint4*>(nws + c * 16);
  uint4 v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int r = (t + NORMALIZERS * i) / 16;
    if (r < M && r < MB)
      v[i] = *reinterpret_cast<const uint4*>(xs + (c / 8) * (MB * 128) + r * 128 +
                                             ((c % 8) ^ (r % 8)) * 16);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int r = (t + NORMALIZERS * i) / 16;
    if (r < M && r < MB)
      *reinterpret_cast<uint4*>(xs + (c / 8) * (MB * 128) + r * 128 + ((c % 8) ^ (r % 8)) * 16) =
          mm::norm8(v[i], wv, rstd[r]);
  }
}

// Consumer thread t (0-127): one slice's codes (the stage's unswizzled box,
// 64 bytes a row) into the bf16 A tile `at`, BK k-rows x 64 columns as two
// MN-major swizzled 64-k-row boxes (what TMA writes for a dense W). Thread
// t converts the 8-byte pieces t + 128 i: code row t / 8 + 16 i, columns
// 8 (t % 8) ..; an int4 row is k-rows 2 r (low nibbles) and 2 r + 1 (high).
// SCALE: times the columns' bf16 scales s[h] of k-rows [64 h, 64 h + 64).
template <int WT, bool SCALE>
__device__ __forceinline__ void dequant(const unsigned char* codes, unsigned char* at, int t,
                                        const uint32_t (&s)[2][4]) {
  const int j = t % 8;
  if constexpr (WT == kInt8) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int h = i / 4, rr = t / 8 + 16 * (i % 4);  // k-row 64 h + rr
      const uint2 v = *reinterpret_cast<const uint2*>(codes + (size_t)(t + 128 * i) * 8);
      *reinterpret_cast<uint4*>(at + h * wg::BOX_BYTES + rr * 128 + ((j ^ (rr % 8)) * 16)) =
          wq::codes8<SCALE>(v.x ^ 0x80808080u, v.y ^ 0x80808080u, 128.f, s[h]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i / 2, kr = 2 * (t / 8) + 32 * (i % 2);  // k-rows 64 h + kr, + 1
      const uint2 v = *reinterpret_cast<const uint2*>(codes + (size_t)(t + 128 * i) * 8);
      const uint4 lo = wq::codes8<SCALE>((v.x & 0x0F0F0F0Fu) ^ 0x08080808u,
                                         (v.y & 0x0F0F0F0Fu) ^ 0x08080808u, 8.f, s[h]);
      const uint4 hi = wq::codes8<SCALE>(((v.x >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                                         ((v.y >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 8.f, s[h]);
      unsigned char* box = at + h * wg::BOX_BYTES;
      *reinterpret_cast<uint4*>(box + kr * 128 + ((j ^ (kr % 8)) * 16)) = lo;
      *reinterpret_cast<uint4*>(box + (kr + 1) * 128 + ((j ^ ((kr + 1) % 8)) * 16)) = hi;
    }
  }
}

// ---- the kernel -------------------------------------------------------------------

template <bool NORM, int WT, int SM, int MB>
__global__ void __launch_bounds__(NT, 2)
skinny_wgmma_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
                    const bf16* __restrict__ x, const bf16* __restrict__ nw,
                    const float* __restrict__ scales, bf16* __restrict__ y, int M, int K, int N,
                    int gs, float eps, int cs) {
  using G = Geo<WT, MB>;
  constexpr bool GROUP = SM == kGroup, TILE_SCALE = SM == kTile && !G::DENSE;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[G::STAGES], normed[G::STAGES], empty[G::STAGES];
  __shared__ float rstd[MB];
  unsigned char* ring = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* atiles = ring + G::STAGES * G::STAGE_BYTES;  // 1024-aligned, as the ring
  unsigned char* nwbuf = atiles + G::A_BUFS * G::A_BYTES;
  float* part = reinterpret_cast<float*>(nwbuf + G::STAGES * G::NW_BYTES);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < G::STAGES; ++s) {
      wg::mbar_init(&full[s], 1);              // the producer's arrive + the slice's bytes
      wg::mbar_init(&normed[s], NORMALIZERS);  // NORM: every normalizer
      wg::mbar_init(&empty[s], 1);             // the consumer warpgroup, once
    }
    wg::fence_barrier_init();
  }
  __syncthreads();
  const int T = tiles_for(N);
  const Walk wk(blockIdx.x, gridDim.x, cs, K / BK);
  const int n_sl = wk.hi - wk.lo;                                   // slices a tile
  const int n_loads = (T - wk.first + wk.stride - 1) / wk.stride * n_sl;

  // rank 0's store of the tile at n0 (consumer thread v: row v / 8, columns
  // 8 (v % 8) ..): the cs partials added in rank order, scaled (kEnd), bf16
  auto store_tile = [&](int n0, int v) {
    const int m = v / 8, c = (v % 8) * 8;
    if (v >= MB * 8 || m >= M || n0 + c >= N) return;
    const float* p = part + m * PLD + c;
    float4 ra[MAX_CS], rb[MAX_CS];  // every rank's loads in flight, then the sum in rank order
#pragma unroll
    for (int r = 0; r < MAX_CS; ++r)
      if (r < cs) ra[r] = wg::ld_rank_f4(p, r), rb[r] = wg::ld_rank_f4(p + 4, r);
    float4 a = ra[0], b = rb[0];
#pragma unroll
    for (int r = 1; r < MAX_CS; ++r)
      if (r < cs) {
        a.x += ra[r].x, a.y += ra[r].y, a.z += ra[r].z, a.w += ra[r].w;
        b.x += rb[r].x, b.y += rb[r].y, b.z += rb[r].z, b.w += rb[r].w;
      }
    float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    if (SM == kEnd) {  // the column's scale times the f32 sum, once
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] *= __ldg(scales + n0 + c + e);
    }
    *reinterpret_cast<uint4*>(y + (size_t)m * N + n0 + c) = pack8(f);
  };

  if (warp == 0) {  // the producer: load i is slice lo + i % n_sl of the CTA's tile i / n_sl
    int i = 0, stage = 0;
    uint32_t phase = 0;
    auto issue = [&](int until) {
      for (; i < until; ++i) {
        const int tile = wk.first + i / n_sl * wk.stride, s = wk.lo + i % n_sl;
        wg::mbar_wait(&empty[stage], phase ^ 1);  // the first pass finds it free
        unsigned char* st = ring + stage * G::STAGE_BYTES;
        wg::mbar_arrive_expect_tx(&full[stage],
                                  G::W_BYTES + 2 * G::X_BOX + (NORM ? G::NW_BYTES : 0));
        wg::tma_load_2d(st, &tw, &full[stage], tile * BN, s * G::W_ROWS);
        wg::tma_load_2d(st + G::W_BYTES, &tx, &full[stage], s * BK, 0);
        wg::tma_load_2d(st + G::W_BYTES + G::X_BOX, &tx, &full[stage], s * BK + 64, 0);
        if (NORM)
          wg::bulk_load(nwbuf + stage * G::NW_BYTES, nw + (size_t)s * BK, G::NW_BYTES, &full[stage]);
        if (++stage == G::STAGES) stage = 0, phase ^= 1;
      }
    };
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tw)) : "memory");
      issue(n_loads < G::STAGES ? n_loads : G::STAGES);  // the whole ring, before any x is read
    }
    if (NORM) {  // its share of rstd; only the normalizers wait for all of it
      __syncwarp();
      mm::rows_rstd(x, rstd, 0, MB, M, K, eps, warp, NT / 32);
      __threadfence_block();
      named_barrier_arrive(2, NT);
    }
    if (threadIdx.x == 0) issue(n_loads);
  } else if (warp < 4) {  // K2: the normalizers
    if (NORM) {
      const int t = threadIdx.x - 32;
      mm::rows_rstd(x, rstd, 0, MB, M, K, eps, warp, NT / 32);
      wg::named_barrier(2, NT);  // every row's rstd is in
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_loads; ++i) {
        wg::mbar_wait(&full[stage], phase);
        normalize_x<MB>(ring + stage * G::STAGE_BYTES + G::W_BYTES, nwbuf + stage * G::NW_BYTES,
                        rstd, M, t);
        wg::fence_proxy_async();
        wg::mbar_arrive(&normed[stage]);
        if (++stage == G::STAGES) stage = 0, phase ^= 1;
      }
    }
  } else {  // the consumer warpgroup
    const int tw_ = threadIdx.x - 128, w = tw_ / 32, g = tw_ % 32 / 4, q = tw_ % 4;
    if (NORM) {  // its share of rstd
      mm::rows_rstd(x, rstd, 0, MB, M, K, eps, warp, NT / 32);
      __threadfence_block();
      named_barrier_arrive(2, NT);
    }
    float acc[MB / 2];
    float tot[GROUP ? MB / 2 : 1];
    uint32_t sc[2][4];  // TILE_SCALE: this thread's columns' scales, k-rows [64 h, 64 h + 64)
    int stage = 0, buf = 0;
    uint32_t phase = 0;
    for (int tile = wk.first; tile < T; tile += wk.stride) {
      const int n0 = tile * BN;
      if (TILE_SCALE && !gs) {
        wq::scales8(sc[0], scales, 0, n0 + 8 * (tw_ % 8), N);
#pragma unroll
        for (int p = 0; p < 4; ++p) sc[1][p] = sc[0][p];
      }
#pragma unroll
      for (int j = 0; j < MB / 2; ++j) acc[j] = 0.f;
      if constexpr (GROUP) {
#pragma unroll
        for (int j = 0; j < MB / 2; ++j) tot[j] = 0.f;
      }
      // kGroup: the group's f32 sums times its channels' scales join tot
      auto flush = [&](int srow) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = n0 + 16 * w + g + 8 * h;
          const float sv = col < N ? __ldg(scales + (size_t)srow * N + col) : 0.f;
#pragma unroll
          for (int j = 0; j < MB / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              tot[4 * j + 2 * h + e] += acc[4 * j + 2 * h + e] * sv;
              acc[4 * j + 2 * h + e] = 0.f;
            }
        }
      };
      int prev = -1;
      for (int s = wk.lo; s < wk.hi; ++s) {
        wg::mbar_wait(&full[stage], phase);
        unsigned char* st = ring + stage * G::STAGE_BYTES;
        unsigned char* a = G::DENSE ? st : atiles + buf * G::A_BYTES;
        if constexpr (!G::DENSE) {
          if (TILE_SCALE && gs) {
            wq::scales8(sc[0], scales, s * BK / gs, n0 + 8 * (tw_ % 8), N);
            wq::scales8(sc[1], scales, (s * BK + 64) / gs, n0 + 8 * (tw_ % 8), N);
          }
          // every warp has retired slice s - 2's wgmmas, this buffer's last reader
          wg::named_barrier(1, 128);
          dequant<WT, TILE_SCALE>(st, a, tw_, sc);
          wg::fence_proxy_async();
          wg::named_barrier(1, 128);
        }
        if (NORM) wg::mbar_wait(&normed[stage], phase);  // the x slice is normalized
        const unsigned char* xs = st + G::W_BYTES;
        if constexpr (GROUP) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            wg::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_tn<MB>(acc, wg::operand_desc<true>(a + (4 * h + kk) * wg::k16_step<true>()),
                           wg::operand_desc<false>(xs + h * G::X_BOX +
                                                   kk * wg::k16_step<false>()));
            wg::wgmma_commit();
            if ((s * BK + 64 * h + 64) % gs == 0) {  // a group ends here
              wg::wgmma_wait<0>();
              flush((s * BK + 64 * h) / gs);
            }
          }
          wg::wgmma_wait<0>();
          if (tw_ == 0) wg::mbar_arrive(&empty[stage]);
        } else {
          wg::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_tn<MB>(acc, wg::operand_desc<true>(a + kk * wg::k16_step<true>()),
                         wg::operand_desc<false>(xs + (kk / 4) * G::X_BOX +
                                                 (kk % 4) * wg::k16_step<false>()));
          wg::wgmma_commit();
          wg::wgmma_wait<1>();  // the slice before is done: free its stage
          if (prev >= 0 && tw_ == 0) wg::mbar_arrive(&empty[prev]);
          prev = stage;
        }
        if (++stage == G::STAGES) stage = 0, phase ^= 1;
        if (++buf == 2) buf = 0;
      }
      if constexpr (!GROUP) {
        wg::wgmma_wait<0>();
        if (prev >= 0 && tw_ == 0) wg::mbar_arrive(&empty[prev]);
      }
      // this CTA's partial: d[4 j + 2 h + e] = D[channel 16 w + g + 8 h][row 8 j + 2 q + e]
      wg::named_barrier(1, 128);  // the tile before is stored
#pragma unroll
      for (int j = 0; j < MB / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            part[(8 * j + 2 * q + e) * PLD + 16 * w + g + 8 * h] =
                GROUP ? tot[4 * j + 2 * h + e] : acc[4 * j + 2 * h + e];
      if (cs == 1) {
        wg::named_barrier(1, 128);
        store_tile(n0, tw_);
      }
    }
  }
  if (cs > 1) {  // one tile a CTA: rank 0 reads every rank's partial
    wg::cluster_sync();
    if (warp >= 4 && wk.rank == 0) store_tile(wk.first * BN, threadIdx.x - 128);
    wg::cluster_sync();  // no rank exits while rank 0 reads its shared memory
  }
}

// The walk as the CTAs decode it: row tile * cs + rank of out (4 ints a
// row) = (CTA, its step at that tile, first slice, end slice)
__global__ void items_kernel(int T, int S, int cs, int grid, int* out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= grid) return;
  const Walk wk(b, grid, cs, S);
  int step = 0;
  for (int tile = wk.first; tile < T; tile += wk.stride, ++step) {
    int* o = out + 4 * (tile * cs + wk.rank);
    o[0] = b, o[1] = step, o[2] = wk.lo, o[3] = wk.hi;
  }
}

// ---- host side ---------------------------------------------------------------

inline int sms() {
  static const int n = wg::num_sms();
  return n;
}

// A tensor map encoded on first use and cached by everything the encode
// reads: W's (weight type kBf16 / kInt8 / kInt4: boxes of 64 columns x one
// slice) and x's (kind kX: (M, K) bf16, boxes of 64 k x MB rows, rows past M
// zeros).
constexpr int kX = 3;
struct CachedMap {
  CUtensorMap map;
};
inline cudaError_t cached_map(CUtensorMap* out, int kind, const void* base, int rows, int cols,
                              int box_rows) {
  using Key = std::tuple<uintptr_t, int, int, int, int>;
  static std::mutex mu;
  static std::map<Key, CachedMap> cache;
  const Key key{reinterpret_cast<uintptr_t>(base), kind, rows, cols, box_rows};
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it == cache.end()) {
    CachedMap e;
    cudaError_t err;
    if (kind == kBf16 || kind == kX) {
      const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
      const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
      err = wg::bf16_map(&e.map, base, 2, dims, box);
    } else {
      err = wq::u8_map(&e.map, base, cols, rows, box_rows, BN);
    }
    if (err != cudaSuccess) return err;
    if (cache.size() >= 4096) cache.clear();
    it = cache.emplace(key, e).first;
  }
  *out = it->second.map;
  return cudaSuccess;
}

template <bool NORM, int WT, int SM, int MB>
cudaError_t launch_mb(const void* x, const void* nw, const void* w, const void* scales, void* y,
                      int M, int K, int N, int gs, float eps, cudaStream_t stream) {
  using G = Geo<WT, MB>;
  CUtensorMap tw, tx;
  cudaError_t err = cached_map(&tw, WT, w, K / (WT == kInt4 ? 2 : 1), N, G::W_ROWS);
  if (err != cudaSuccess) return err;
  err = cached_map(&tx, kX, x, M, K, MB);
  if (err != cudaSuccess) return err;
  const void* kern = reinterpret_cast<const void*>(skinny_wgmma_kernel<NORM, WT, SM, MB>);
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  Plan p = plan_for(N, K, sms());
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = p.cs;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = G::SMEM_BYTES;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  auto xp = static_cast<const bf16*>(x);
  auto nwp = static_cast<const bf16*>(nw);
  auto sp = static_cast<const float*>(scales);
  auto yp = static_cast<bf16*>(y);
  void* args[] = {&tw, &tx, &xp, &nwp, &sp, &yp, &M, &K, &N, &gs, &eps, &p.cs};
  err = cudaLaunchKernelExC(&cfg, kern, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// y (M, N) bf16 = A @ W for 1 <= M <= 16; w: the dense (K, N) bf16 W (WT
// kBf16, SM kTile) or the codes; nw (NORM): w_norm. Requires K % 128 == 0,
// K % gs == 0, N % 8 == 0 (dense) or N % 16 == 0, and 16-byte-aligned x,
// nw and w.
template <bool NORM, int WT, int SM>
cudaError_t launch(const void* x, const void* nw, const void* w, const void* scales, void* y,
                   int M, int K, int N, int gs, float eps, cudaStream_t stream) {
  return M <= 8 ? launch_mb<NORM, WT, SM, 8>(x, nw, w, scales, y, M, K, N, gs, eps, stream)
                : launch_mb<NORM, WT, SM, 16>(x, nw, w, scales, y, M, K, N, gs, eps, stream);
}

// the walk's items into out (tiles_for(N) * 8 rows of 4 ints; rows past
// tiles x cs untouched)
inline cudaError_t items(int K, int N, int* out, cudaStream_t stream) {
  const Plan p = plan_for(N, K, sms());
  items_kernel<<<(p.grid + 127) / 128, 128, 0, stream>>>(tiles_for(N), K / BK, p.cs, p.grid, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sk
}  // namespace pt
