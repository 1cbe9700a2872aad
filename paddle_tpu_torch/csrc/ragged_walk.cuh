// The ragged two-source attention shared by K11 (ragged_paged_attention.cu)
// and K3's ragged form (rope_append_attend.cu, FUSED).
//
// A wave of T query rows; slot b owns rows [q_start[b], q_start[b] +
// q_lens[b]). Each row of slot b attends, in one f32 softmax, to
//   * page keys: the slot's cells at positions < page_lens[b], through
//     its block table (no per-row causal mask: page_lens never exceeds a
//     live row's own position + 1);
//   * fresh keys: rows q_start[b] + u of the wave's own K/V with
//     u <= the row's offset and u < fresh_lens[b] (causal in the chunk),
//     non-finite values read as 0 (a 0-weight times NaN must not leak).
// Rows with no visible key and rows of no segment are exact zeros. It
// computes what _ragged_kernel (ragged_paged_attention.py) and
// _fused_kernel's ragged use (fused_rope_attend.py) compute; the TPU
// kernels walk (kv head, slot, q-row block, page) as a sequential grid
// with the softmax state in VMEM scratch.
//
// FUSED (K3's ragged form) adds: q rows rotated at their positions
// (apply_rotary_rows: f32 rotate-half with separately rounded products,
// cast to bf16); every segment row writes its cell (rotated k, raw v) into
// the pool at (its slot, row_pos[row]); and the fresh keys are the rotated
// k rows. One launch is legal because no row reads a cell that another CTA
// writes in the same wave: a decode row (q_lens 1, page_lens = old length
// + 1) reads back only its own new cell, which the CTA that reads its page
// writes and patches into the landed copy of that page; chunk rows read
// pages only below the old length and take their own chunk from the fresh
// source; slots own disjoint pages.
//
// Bound on an H100: bytes (every live cell's K and V read once), also at
// the batcher's 256-row chunks, whose 4 D flops a query row and visible
// key take less time on the tensor cores. The earlier body ran one block
// a (row tile, kv head, slot), most of them empty, each walking a slot's
// pages alone behind dependent loads and scoring one key a lane on the
// CUDA cores. This body:
//
// A grid that depends on shapes only; work decoded on the device. The
// grid is (clusters x cs, Hk), clusters of cs CTAs (paged_walk.cuh's
// cluster_size, one rule for every walk), `clusters` a kv head the most
// any wave of T rows over B slots can need (clusters_per_head). Each CTA
// reads the B slots' q_lens / fresh_lens and decodes its item (decode):
//   * walk items, clusters 0..W-1: the W slots with q_lens 1 and
//     fresh_lens 0, in slot order: the slot's g heads walk its page_lens
//     cells, split in whole pages across the cluster's ranks
//     (pw::range_of); the ranks' partial (m, l, acc) merge in rank order
//     on rank 0 through distributed shared memory (no workspace, no
//     atomics);
//   * tile items, the clusters after them: every other slot with rows,
//     in tiles of R = 64 / g wave rows (R x g = 64 MMA rows, 16 a warp),
//     cs consecutive tiles a cluster; a tile walks the slot's pages, then
//     its fresh keys up to its last row, alone;
//   * empty CTAs past the last item, which exit at once.
// Every CTA first reads the B slots' lengths into shared memory (one round
// of loads) and writes zeros to its stripe of the wave's rows of no
// segment, so the wrappers allocate the output without a memset.
//
// Pages in flight. The slot's block-table row comes by cp.async; the
// first pages of the CTA's range go in flight at once into a ring of
// stages whose rows are padded to 272 bytes, so that ldmatrix reads 8 rows
// without a bank conflict. A page's reader warps share its copies: each
// lane copies 16-byte pieces of the page's K and V rows (cp.async), then
// arrives on the stage's mbarrier when its copies land
// (cp.async.mbarrier.arrive), so the stage completes when all the readers'
// pieces have. A warp that finishes a stage counts itself out of it; once
// all its readers are out, each puts its share of the page `stages` ahead
// in flight there; that page's readers wait for the same count before the
// stage's barrier. No block barrier is passed a page. (Tried on the card
// and slower: a bulk copy a row, 32 a page, whose completions bound a
// tile's page walk; one bulk copy a page into unpadded rows, which makes
// ldmatrix conflict 8 ways; one warp issuing a whole page's pieces.)
//
// The fresh source (tile items): the wave's k/v rows are Hk D apart, so
// 16-row sub-chunks come by 16-byte cp.async copies into the ring once the
// pages are done, four in flight (K11), or two with the rows' f32 cos and
// sin beside them (FUSED, so that no global load waits in the loop); then,
// in shared memory, FUSED rotates k (bf16, then non-finite -> 0) and
// non-finite v becomes 0 (K11: k and v). (The cos / sin rows of a
// sub-chunk are contiguous: two bulk copies.)
//
// The arithmetic, on the tensor cores (mma.sync.m16n8k16, bf16 in, f32
// sums), flash-attention style: each warp keeps 16 query rows (tile items:
// its own 16 of the tile's 64; walk items: the g <= 8 heads padded to 16,
// the four warps taking every fourth 16-key sub-chunk) as A fragments in
// registers and walks 16 keys at a time: S = Q K^T (bf16 q values: K11's
// q, K3's rotated q), scaled in f32, masked per row (page keys below the
// stage's cells, fresh keys causal), an online softmax in registers, and
// O += P V with P split into bf16 hi + lo (f32-grade sums). A walk's four
// warps merge in warp order, then its ranks in rank order.
//
// On an int8 pool (Pool = signed char: codes, with one f32 scale a (head,
// token) cell in the (L, Hk, P, page, 1) scale pools) a stage holds a
// page's K and V codes in 144-byte rows (8 rows on distinct banks for the
// fragment loads below) and its K and V scales, all cp.async pieces on the
// stage's one mbarrier (the scales of a page whose cells end inside it are
// read up to the next multiple of 4 cells: page % 4 == 0). The codes go to
// mma.sync as exact bf16 operands, built from 2-byte code pairs (K, along
// the row) and from two codes a row apart (V); S is scaled per key column
// by the K scale and the V scale folds into P, as paged_walk.cuh does.
// FUSED quantizes each written cell as kv_cache._quantize_cells does
// (absmax over the row's 128 dims, shared by the row's 8 threads through
// shuffles; f32 division by the scale, round half to even), and a walk's
// own cell is patched into its landed stage as codes and scales. The fresh
// source stays bf16: the wave's own rows are never read through the cache
// dtype (ragged_paged_attention.py's TWO-SOURCE contract), but in the slots
// that the (B,) bool fresh_pool_read marks (speculative verify segments).
//
// fresh_pool_read. A verify segment's rows must attend to one another as the
// plain decode step would read them back from the pool. The TPU kernels take
// that from an f32 fresh source that plain ops roundtripped through the pool
// (fused_rope_attend.py _pool_roundtrip; _fused_kernel's static `spec`
// variant selects it per slot by fq_ref[b]); an f32 operand cannot feed the
// bf16 mma.sync path exactly, so here the kernel does the roundtrip. On a
// bf16 pool it is the identity, bit for bit (a bf16 row cast to bf16;
// FUSED's rotated k is rounded to bf16 as apply_rotary_rows rounds it), so
// the flag changes nothing and is not read. On an int8 pool a flag launches
// the FLAGGED instance, whose CTAs copy the flags with the lens block. Once
// a flagged tile's fresh sub-chunk has landed (and FUSED has rotated it),
// the row's 8 threads quantize its K and V rows with the cell writer's rule
// (codes_in_place: absmax, pw::cell_scale, pw::quantize), write the codes
// back in place as bf16 values (exact) and each row's K and V scales into
// its row's padding; attend16 then scales S by the K scale per key and
// folds the V scale into P, as it does for page cells: the flagged fresh
// keys are exactly the cells the pool holds, codes and scales. A verify
// segment has fresh_lens = q_lens >= 1, so it is always a tile item, never
// a walk.
#pragma once

#include "paged_walk.cuh"

namespace pt {
namespace rw {
namespace {  // each including source gets its own copy

constexpr int kD = 128;
constexpr int HALF = kD / 2;
constexpr int NW = 4;                       // warps
constexpr int NT = NW * 32;
constexpr int ROWS = 16 * NW;               // a tile item's MMA rows
constexpr int MAX_G = 8;
constexpr int RSTR = kD + 8;                // a staged row, in bf16
constexpr int ROW_BYTES = RSTR * 2;         // 272: 8 rows hit 32 distinct banks
constexpr int I8_ROW = kD + 16;             // 144: a staged row of int8 codes
constexpr int RING_BYTES = 52 * 1024;
constexpr int MAX_STAGES = 16;
// a fresh sub-chunk: 16 K and 16 V rows and, FUSED, the rows' cos and sin
// (f32); NF of them in flight
template <bool FUSED>
__host__ __device__ constexpr int fresh_bytes() {
  return 2 * 16 * ROW_BYTES + (FUSED ? 2 * 16 * kD * 4 : 0);
}
template <bool FUSED>
__host__ __device__ constexpr int fresh_depth() {
  return FUSED ? 2 : 4;
}

enum { kEmpty = 0, kWalk = 1, kTile = 2 };

// ---- the plan (ragged_paged_attention.ragged_plan / ragged_items mirror it) ---

// the most tiles of r rows that `rows` wave rows make over at most `slots`
// slots of at least one row each
__host__ __device__ inline int max_tiles(int rows, int slots, int r) {
  if (rows <= 0 || slots <= 0) return 0;
  return rows <= slots ? rows : slots + (rows - slots) / r;
}

// clusters a kv head: the most any wave of T rows over B slots needs (w
// walk clusters, then the tiles in clusters of cs), at least one
__host__ __device__ inline int clusters_per_head(int T, int B, int r, int cs) {
  int best = 1;
  for (int w = 0; w <= B && w <= T; ++w) {
    const int c = w + (max_tiles(T - w, B - w, r) + cs - 1) / cs;
    best = c > best ? c : best;
  }
  return best;
}

struct Item {
  int kind, b, idx;  // idx: the rank (walk) or the tile of the slot (tile)
};

// The item of cluster `cluster`, rank `rank` (tiles of r rows)
__device__ inline Item decode(const int* q_lens, const int* fresh_lens, int B, int r, int cs,
                              int cluster, int rank) {
  int w = 0;
  for (int b = 0; b < B; ++b)
    if (q_lens[b] == 1 && fresh_lens[b] == 0) {
      if (w == cluster) return {kWalk, b, rank};
      ++w;
    }
  int tau = (cluster - w) * cs + rank;
  for (int b = 0; b < B; ++b) {
    const int q = q_lens[b];
    if (q <= 0 || (q == 1 && fresh_lens[b] == 0)) continue;
    const int nt = (q + r - 1) / r;
    if (tau < nt) return {kTile, b, tau};
    tau -= nt;
  }
  return {kEmpty, -1, 0};
}

// Dynamic shared memory, by byte offset: the ring of stages (K rows | V
// rows, rows16 each, bf16 or int8 codes | on an int8 pool, K scales | V
// scales, rows16 each; after the pages, the fresh sub-chunks; after the
// walk, the warps' partials); the query rows (ROWS x RSTR bf16), which on
// a walk's rank 0 become the ranks' partial slots (acc [g][kD], m[MAX_G],
// l[MAX_G] each); the slot's block-table row; the B slots' q_lens,
// fresh_lens, q_start, page_lens and fresh_pool_read flags. esz: the pool's
// element size.
struct Geo {
  int rows16, row_bytes, kv_bytes, sc_bytes, stage_bytes, stages, q_off, slot, table, lens, smem;
  __host__ __device__ Geo(int page, int pps, int cs, int g, int B, int esz) {
    rows16 = (page + 15) / 16 * 16;
    row_bytes = esz == 1 ? I8_ROW : ROW_BYTES;
    kv_bytes = rows16 * row_bytes;
    sc_bytes = esz == 1 ? rows16 * 4 : 0;
    stage_bytes = 2 * (kv_bytes + sc_bytes);
    stages = RING_BYTES / stage_bytes;
    stages = stages < 2 ? 2 : stages > MAX_STAGES ? MAX_STAGES : stages;
    // the ring also holds NF fresh sub-chunks and the warps' partials
    const int fresh = fresh_depth<true>() * fresh_bytes<true>();
    q_off = stages * stage_bytes > fresh ? stages * stage_bytes : fresh;
    slot = (g * kD + 2 * MAX_G) * 4;
    const int qb = ROWS * ROW_BYTES, pb = cs * slot;
    table = q_off + (qb > pb ? qb : pb);
    lens = table + (pps * 4 + 15) / 16 * 16;
    smem = lens + 5 * B * 4;
  }
};

struct Shared {
  uint64_t full[MAX_STAGES];
  int done[MAX_STAGES];          // reader warps that finished the stage, ever
  // K3's own cell of a walk: rotated k, raw v (bf16), or their codes (int8,
  // the first kD bytes) and scales
  alignas(16) bf16 kself[kD];
  alignas(16) bf16 vself[kD];
  float self_sc[2];
  float wm[NW][MAX_G], wl[NW][MAX_G];  // a walk's warp partials: m, l
  uint64_t trig_full[2];               // FUSED: a fresh sub-chunk's cos and sin landed
};

// Pool = bf16 (the verbatim cache) or signed char (int8 codes; k_sc / v_sc
// the scale pools (L, Hk, P, page, 1), else unused). K11 passes layer 0,
// its pools (Hk, P, page, D), and no cos / sin / row_pos.
template <typename Pool>
struct Args {
  const bf16 *q, *k, *v;  // (T, H, D); (T, Hk, D): fresh K (raw k under FUSED) and V
  const float *cos, *sin;  // (T, D), FUSED only
  Pool *k_pages, *v_pages;  // (L, Hk, P, page, D); written under FUSED
  float *k_sc, *v_sc;       // int8 only; written under FUSED
  const int *block_tables, *row_pos, *page_lens, *q_start, *q_lens, *fresh_lens;
  const bool* fresh_pool_read;  // (B,) or null: no slot flagged
  bf16* out;  // (T, H, D)
  int T, B, H, Hk, P, page, pps, layer, cs, clusters;
  float scale;
};

// ---- helpers --------------------------------------------------------------------

__device__ __forceinline__ float rope(float x, float partner, int d, float c, float s) {
  const float r = d < HALF ? -partner : partner;
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(r, s));
}

__device__ __forceinline__ float finite_or_zero(float x) { return isfinite(x) ? x : 0.f; }

__device__ __forceinline__ uint4 ld16(const void* p) { return *reinterpret_cast<const uint4*>(p); }
__device__ __forceinline__ void st16(void* p, uint4 v) { *reinterpret_cast<uint4*>(p) = v; }

// 8 bf16 values with non-finite ones replaced by 0
__device__ __forceinline__ uint4 zero_non_finite8(uint4 u) {
  float f[8];
  unpack8(u, f);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = finite_or_zero(f[i]);
  return pack8(f);
}

// cos or sin of one row at dims [d0, d0 + 8) and [d0 + 64, d0 + 72)
struct Trig {
  float lo[8], hi[8];
  __device__ __forceinline__ void load(const float* row, int d0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(row + d0 + 4 * i);
      const float4 b = *reinterpret_cast<const float4*>(row + d0 + HALF + 4 * i);
      lo[4 * i] = a.x, lo[4 * i + 1] = a.y, lo[4 * i + 2] = a.z, lo[4 * i + 3] = a.w;
      hi[4 * i] = b.x, hi[4 * i + 1] = b.y, hi[4 * i + 2] = b.z, hi[4 * i + 3] = b.w;
    }
  }
};

// Rotate dims [d0, d0 + 8) (lo) and their partners [d0 + 64, d0 + 72) (hi)
// of one row: each result rounded to bf16 (apply_rotary_rows); FIN: then
// non-finite -> 0 (the fresh source's rule)
template <bool FIN>
__device__ __forceinline__ void rotate8(uint4& lo, uint4& hi, const Trig& c, const Trig& s,
                                        int d0) {
  float a[8], b[8];
  unpack8(lo, a);
  unpack8(hi, b);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float x = a[e], y = b[e];
    a[e] = __bfloat162float(__float2bfloat16(rope(x, y, d0 + e, c.lo[e], s.lo[e])));
    b[e] = __bfloat162float(__float2bfloat16(rope(y, x, d0 + HALF + e, c.hi[e], s.hi[e])));
    if (FIN) a[e] = finite_or_zero(a[e]), b[e] = finite_or_zero(b[e]);
  }
  lo = pack8(a);
  hi = pack8(b);
}

// The codes of 8 values of a cell whose scale is sc (pw::quantize), packed
__device__ __forceinline__ uint2 codes8(const float* x, float sc) {
  uint2 u;
  signed char* c = reinterpret_cast<signed char*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) c[e] = pw::quantize(x[e], sc);
  return u;
}

// The absmax of a row's 128 values, of which this thread holds 16 and
// the row's other 7 threads (the 8 lanes of an aligned group) the rest
__device__ __forceinline__ float row_absmax(const float* x) {
  float m = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) m = fmaxf(m, fabsf(x[e]));
  const unsigned group = 0xffu << (threadIdx.x % 32 & 24);
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) m = fmaxf(m, __shfl_xor_sync(group, m, o));
  return m;
}

// A flagged fresh row's 16 values of this thread (bf16 lo, hi: dims
// [8c, 8c + 8) and [8c + 64, 8c + 72)) replaced by their int8 codes as
// bf16 values (exact), and the row's scale returned: kv_cache.
// _quantize_cells' rule, the row's 8 threads (an aligned group of 8 lanes)
// together, as the cell writer quantizes
__device__ __forceinline__ float codes_in_place(uint4& lo, uint4& hi) {
  float x[16];
  unpack8(lo, x), unpack8(hi, x + 8);
  const float sc = pw::cell_scale(row_absmax(x));
#pragma unroll
  for (int e = 0; e < 16; ++e) x[e] = (float)pw::quantize(x[e], sc);
  lo = pack8(x), hi = pack8(x + 8);
  return sc;
}

// FUSED: dims [8c, 8c + 8) and [8c + 64, 8c + 72) of a row's cell (kv
// head kh, slot b, position pos), from the row's raw k (klo, khi), v (vlo,
// vhi) and cos / sin there: rotated k and raw v into the pool (int8: their
// codes, and from c == 0 the cell's scales), and into self (a walk's own
// cell) when given. On an int8 pool the row's 8 threads (c = 0..7, an
// aligned group of 8 lanes) call it together.
template <typename Pool>
__device__ __forceinline__ void write_cell(const Args<Pool>& a, int b, int kh, int pos, int c,
                                           uint4 klo, uint4 khi, uint4 vlo, uint4 vhi,
                                           const Trig& cs, const Trig& sn, Shared* self) {
  const size_t plane = ((size_t)a.layer * a.Hk + kh) * a.P;
  const size_t cell =
      (plane + a.block_tables[(size_t)b * a.pps + min(pos / a.page, a.pps - 1)]) * a.page +
      pos % a.page;
  rotate8<false>(klo, khi, cs, sn, 8 * c);
  Pool* kd = a.k_pages + cell * kD + 8 * c;
  Pool* vd = a.v_pages + cell * kD + 8 * c;
  if constexpr (sizeof(Pool) == 1) {
    float k[16], v[16];
    unpack8(klo, k), unpack8(khi, k + 8), unpack8(vlo, v), unpack8(vhi, v + 8);
    const float ks = pw::cell_scale(row_absmax(k)), vs = pw::cell_scale(row_absmax(v));
    const uint2 kq[2] = {codes8(k, ks), codes8(k + 8, ks)};
    const uint2 vq[2] = {codes8(v, vs), codes8(v + 8, vs)};
    *reinterpret_cast<uint2*>(kd) = kq[0], *reinterpret_cast<uint2*>(kd + HALF) = kq[1];
    *reinterpret_cast<uint2*>(vd) = vq[0], *reinterpret_cast<uint2*>(vd + HALF) = vq[1];
    if (c == 0) a.k_sc[cell] = ks, a.v_sc[cell] = vs;
    if (self) {
      signed char* sk = reinterpret_cast<signed char*>(self->kself) + 8 * c;
      signed char* sv = reinterpret_cast<signed char*>(self->vself) + 8 * c;
      *reinterpret_cast<uint2*>(sk) = kq[0], *reinterpret_cast<uint2*>(sk + HALF) = kq[1];
      *reinterpret_cast<uint2*>(sv) = vq[0], *reinterpret_cast<uint2*>(sv + HALF) = vq[1];
      if (c == 0) self->self_sc[0] = ks, self->self_sc[1] = vs;
    }
  } else {
    st16(kd, klo), st16(kd + HALF, khi), st16(vd, vlo), st16(vd + HALF, vhi);
    if (self) {
      st16(self->kself + 8 * c, klo), st16(self->kself + HALF + 8 * c, khi);
      st16(self->vself + 8 * c, vlo), st16(self->vself + HALF + 8 * c, vhi);
    }
  }
}

// Zeros to this CTA's stripe of the wave rows that belong to no segment
// (the g heads of kv head kh): row blockIdx.x * NW + warp, then every
// clusters * cs * NW rows
template <typename Pool>
__device__ void zero_rows(const Args<Pool>& a, const int* q_lens, const int* q_start, int kh,
                          int g) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int step = a.clusters * a.cs * NW;
  for (int row = blockIdx.x * NW + warp; row < a.T; row += step) {
    bool in = false;
    for (int b = lane; b < a.B; b += 32) in |= row >= q_start[b] && row < q_start[b] + q_lens[b];
    if (__any_sync(0xffffffffu, in)) continue;
    uint4* o = reinterpret_cast<uint4*>(a.out + ((size_t)row * a.H + kh * g) * kD);
    for (int i = lane; i < g * kD / 8; i += 32) o[i] = make_uint4(0, 0, 0, 0);
  }
}

// arrive on bar once this thread's cp.async copies so far have landed (the
// barrier counts the arrival in its initial count)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(wg::smem_u32(bar))
               : "memory");
}

// Put share `share` of `shares` of page i of the CTA's walk (cnt cells,
// block-table entry bts[i]) in flight into stage i % stages: its first cnt
// K and V rows in 16-byte pieces (int8: then the scales of its first cnt
// cells, rounded up to whole pieces), then each lane arrives on the
// stage's barrier (initial count 32 shares). Every lane of the calling
// warp calls it.
template <typename Pool>
__device__ __forceinline__ void issue(Shared& sh, unsigned char* dyn, const Args<Pool>& a,
                                      const Geo& geo, const int* bts, size_t plane, int i,
                                      int cnt, int share, int shares) {
  constexpr int PR = kD * (int)sizeof(Pool) / 16;  // pieces a row
  const int lane = threadIdx.x % 32, s = i % geo.stages;
  unsigned char* st = dyn + (size_t)s * geo.stage_bytes;
  const size_t cell0 = (plane + bts[i]) * a.page;
  const int rows = 2 * PR * cnt, nsc = sizeof(Pool) == 1 ? (cnt + 3) / 4 : 0;
  for (int p = 32 * share + lane; p < rows + 2 * nsc; p += 32 * shares) {
    if (p < rows) {  // (K or V, row, piece)
      const int kv = p >= PR * cnt, q = kv ? p - PR * cnt : p, r = q / PR, c = q % PR;
      const Pool* src = (kv ? a.v_pages : a.k_pages) + (cell0 + r) * kD + 16 / sizeof(Pool) * c;
      cp_async16(st + (size_t)kv * geo.kv_bytes + (size_t)r * geo.row_bytes + 16 * c, src, true);
    } else {  // (K or V scales, piece)
      const int kv = p - rows >= nsc, c = p - rows - kv * nsc;
      const float* src = (kv ? a.v_sc : a.k_sc) + cell0 + 4 * c;
      cp_async16(st + 2 * geo.kv_bytes + kv * geo.sc_bytes + 16 * c, src, true);
    }
  }
  cp_async_arrive(&sh.full[s]);
}

// Two adjacent int8 codes (2-byte aligned) as a bf16x2 MMA operand
// register, the first in the low half (exact in bf16)
__device__ __forceinline__ unsigned code_pair(const signed char* p) {
  const unsigned short u = *reinterpret_cast<const unsigned short*>(p);
  return pw::pack2((float)(signed char)(u & 0xffu), (float)(signed char)(u >> 8));
}

// One sub-chunk of 16 keys against the warp's 16 query rows (qa): this
// lane's rows gr and gr + 8 see the sub-chunk's first vis0 / vis1 keys; V
// rows from vmax on are masked (the stage may hold anything there). The
// online softmax update of m, l (this lane's share of the row sums) and acc
// (16 n8 tiles of O). Q8 = false: bf16 K rows at kst, V rows at vst, RSTR
// apart; Q8: int8 codes I8_ROW bytes apart, each key's K and V scales at
// ksc / vsc (rows of the stage's page; vis0 = vis1 = vmax). Q8 = false
// with ksc / vsc given: the rows hold codes as bf16 values (a flagged
// fresh sub-chunk), each key's scales in its row's padding (ksc / vsc the
// first key's, RSTR / 2 floats apart), the rows from vmax on masked.
template <bool Q8>
__device__ __forceinline__ void attend16(const void* kst, const void* vst, const float* ksc,
                                         const float* vsc, int vis0, int vis1, int vmax,
                                         const unsigned (&qa)[8][4], float scale,
                                         float (&acc)[16][4], float (&m)[2], float (&l)[2]) {
  constexpr int SC = Q8 ? 1 : RSTR / 2;  // floats from a key's scale to the next key's
  const int lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
  const bf16* kbf = static_cast<const bf16*>(kst);
  const signed char* k8 = static_cast<const signed char*>(kst) + gr * I8_ROW + 2 * tq;
  // S = Q K^T in four independent accumulator chains (n8 tile t, even or
  // odd k16 step), issued in turn, so that no mma waits on the one before
  // it (the asm statements keep their order)
  float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  float s2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int k = 0; k < 8; k += 2) {
    // b0 / b1: keys gr / gr + 8, dims 16 k + 8 j + 2 tq (+1), j = 0..3
    unsigned b0[4], b1[4];
    if constexpr (Q8) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b0[j] = code_pair(k8 + 16 * k + 8 * j);
        b1[j] = code_pair(k8 + 8 * I8_ROW + 16 * k + 8 * j);
      }
    } else {
      ldsm4(b0, kbf + (lane % 8) * RSTR + 16 * k + (lane / 8) * 8);
      ldsm4(b1, kbf + (8 + lane % 8) * RSTR + 16 * k + (lane / 8) * 8);
    }
    mma16816(s[0], qa[k], b0[0], b0[1]);
    mma16816(s[1], qa[k], b1[0], b1[1]);
    mma16816(s2[0], qa[k + 1], b0[2], b0[3]);
    mma16816(s2[1], qa[k + 1], b1[2], b1[3]);
  }
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] += s2[t][e];
  // s[t][e]: row gr (e < 2) or gr + 8, key 8 t + 2 tq + (e & 1); int8: times
  // the key's K scale (read only for a visible key)
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * t + 2 * tq + (e & 1);
      const bool vis = key < (e < 2 ? vis0 : vis1);
      s[t][e] = vis ? s[t][e] * scale * (Q8 || ksc ? ksc[SC * key] : 1.f) : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
    }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);
    corr[r] = expf(m[r] - mn);
    m[r] = mn;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[t][e] = expf(s[t][e] - m[e >> 1]);
      l[e >> 1] += s[t][e];
    }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    acc[j][0] *= corr[0], acc[j][1] *= corr[0];
    acc[j][2] *= corr[1], acc[j][3] *= corr[1];
  }
  // int8: the V scales fold into P (0 for the keys from vmax on, whose
  // scales may be anything)
  if (Q8 || vsc) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * t + 2 * tq + (e & 1);
        s[t][e] = key < vmax ? s[t][e] * vsc[SC * key] : 0.f;
      }
  }
  // P (16 x 16) as the A operand: rows gr / gr + 8, keys 2 tq (+1) and + 8
  unsigned ph[4], pl[4];
  pw::split2(s[0][0], s[0][1], ph[0], pl[0]);
  pw::split2(s[0][2], s[0][3], ph[1], pl[1]);
  pw::split2(s[1][0], s[1][1], ph[2], pl[2]);
  pw::split2(s[1][2], s[1][3], ph[3], pl[3]);
  const int kb = 2 * tq;
  const unsigned m0 = (kb < vmax ? 0xffffu : 0u) | (kb + 1 < vmax ? 0xffff0000u : 0u);
  const unsigned m1 = (kb + 8 < vmax ? 0xffffu : 0u) | (kb + 9 < vmax ? 0xffff0000u : 0u);
  const bf16* vbf = static_cast<const bf16*>(vst);
  // int8: keys 2 tq (+1), dim gr of each 8-dim group
  const signed char* v8 = static_cast<const signed char*>(vst) + kb * I8_ROW + gr;
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    // V (16 keys x dims 16 j .. 16 j + 31) as the B operands of four n8
    // tiles (r[h]: keys 2 tq (+1) and + 8 of dims 16 (j + h) + gr and + 8);
    // their hi products first, then the lo ones into the same four
    // accumulators (no mma right behind the one it adds to)
    unsigned r[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (Q8) {
        const signed char* c = v8 + 16 * (j + h);
        r[h][0] = pw::codes2(c, I8_ROW), r[h][1] = pw::codes2(c + 8 * I8_ROW, I8_ROW);
        r[h][2] = pw::codes2(c + 8, I8_ROW), r[h][3] = pw::codes2(c + 8 * I8_ROW + 8, I8_ROW);
      } else {
        ldsm4_t(r[h], vbf + (lane % 16) * RSTR + 16 * (j + h) + (lane / 16) * 8);
      }
      r[h][0] &= m0, r[h][1] &= m1, r[h][2] &= m0, r[h][3] &= m1;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mma16816(acc[2 * (j + h)], ph, r[h][0], r[h][1]);
      mma16816(acc[2 * (j + h) + 1], ph, r[h][2], r[h][3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mma16816(acc[2 * (j + h)], pl, r[h][0], r[h][1]);
      mma16816(acc[2 * (j + h) + 1], pl, r[h][2], r[h][3]);
    }
  }
}

// ---- the kernel --------------------------------------------------------------

// FLAGGED (int8 pools only): the instance launched when a fresh_pool_read
// flag is given, whose tiles quantize a flagged slot's fresh rows; the
// other instance is the plain wave's body unchanged (at 168 registers a
// thread, the flagged path's code would make it spill).
template <bool FUSED, typename Pool, bool FLAGGED = false>
__global__ void __launch_bounds__(NT, 3) ragged_walk_kernel(const Args<Pool> a) {
  constexpr bool Q8 = sizeof(Pool) == 1;
  static_assert(Q8 || !FLAGGED, "on a bf16 pool the flag changes nothing");
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ Shared sh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gr = lane / 4, tq = lane % 4;
  const int kh = blockIdx.y, g = a.H / a.Hk, R = ROWS / g, cs = a.cs;
  const Geo geo(a.page, a.pps, cs, g, a.B, sizeof(Pool));

  // the B slots' lengths, read once and together
  int* lens = reinterpret_cast<int*>(dyn + geo.lens);
  const int* q_lens = lens;
  const int* fresh_lens = lens + a.B;
  const int* q_start = lens + 2 * a.B;
  const int* page_lens = lens + 3 * a.B;
  for (int i = tid; i < (FLAGGED ? 5 : 4) * a.B; i += NT) {
    const int v = i / a.B;
    if (v == 4) {
      lens[i] = a.fresh_pool_read[i % a.B];
      continue;
    }
    const int* src = v == 0 ? a.q_lens : v == 1 ? a.fresh_lens : v == 2 ? a.q_start : a.page_lens;
    lens[i] = src[i % a.B];
  }
  __syncthreads();
  zero_rows(a, q_lens, q_start, kh, g);
  const Item it = decode(q_lens, fresh_lens, a.B, R, cs, blockIdx.x / cs, blockIdx.x % cs);
  if (it.kind == kEmpty) return;  // (only a tile cluster's last CTAs share a cluster with
                                  // work, and tile clusters pass no cluster barrier)
  const int b = it.b;
  int* table = reinterpret_cast<int*>(dyn + geo.table);
  for (int i = tid; i < a.pps; i += NT)
    cp_async4(table + i, a.block_tables + (size_t)b * a.pps + i, true);
  cp_async_commit();

  const bool walk = it.kind == kWalk;
  const int q0 = q_start[b], n = page_lens[b];
  const int r0 = walk ? 0 : it.idx * R, r1 = walk ? 1 : min(q_lens[b], r0 + R);
  const int np = min((n + a.page - 1) / a.page, a.pps);
  const pw::Range rg = walk ? pw::range_of(n, a.page, a.pps, it.idx, cs) : pw::Range{0, np};
  const size_t plane = ((size_t)a.layer * a.Hk + kh) * a.P;
  bf16* out_walk = a.out + ((size_t)q0 * a.H + kh * g) * kD;

  // The query rows, bf16 (FUSED: rotated), into shared memory (MMA row i:
  // wave row r0 + i / g, head i % g of a tile; head i of a walk) and,
  // FUSED, the rows' cells. A walk's cell is written by the rank whose
  // range holds its page (the last rank if none does), which also patches
  // it into the landed stage; a tile writes its rows'. A thread's task is
  // (wave row, dims pair c): its cos / sin loaded once for the g heads and
  // the cell, every load issued before the first is used.
  int self_off = -1;  // a walk's own cell's place in this CTA's range
  bool writes = !walk;
  if constexpr (FUSED) {
    if (walk) {
      const int pos = max(a.row_pos[q0], 0), sp = min(pos / a.page, a.pps - 1);
      int writer = cs - 1;
      for (int r = 0; r < cs; ++r) {
        const pw::Range x = pw::range_of(n, a.page, a.pps, r, cs);
        if (sp >= x.lo && sp < x.hi) writer = r;
      }
      writes = writer == it.idx;
      if (writes && sp >= rg.lo && sp < rg.hi) self_off = (sp - rg.lo) * a.page + pos % a.page;
    }
  }
  bf16* qs = reinterpret_cast<bf16*>(dyn + geo.q_off);
  const int nro = r1 - r0, mrows = walk ? 16 : ROWS;
  for (int i = tid; i < nro * 8; i += NT) {
    const int ro = r0 + i / 8, c = i % 8, row = q0 + ro;
    uint4 lo[MAX_G], hi[MAX_G];
#pragma unroll
    for (int j = 0; j < MAX_G; ++j)
      if (j < g) {
        const bf16* src = a.q + ((size_t)row * a.H + kh * g + j) * kD + 8 * c;
        lo[j] = ld16(src), hi[j] = ld16(src + HALF);
      }
    if constexpr (FUSED) {
      Trig cs_, sn;
      cs_.load(a.cos + (size_t)row * kD, 8 * c);
      sn.load(a.sin + (size_t)row * kD, 8 * c);
      if (writes) {
        const size_t src = ((size_t)row * a.Hk + kh) * kD + 8 * c;
        const int pos = max(a.row_pos[row], 0);
        write_cell(a, b, kh, pos, c, ld16(a.k + src), ld16(a.k + src + HALF), ld16(a.v + src),
                   ld16(a.v + src + HALF), cs_, sn, walk ? &sh : nullptr);
      }
#pragma unroll
      for (int j = 0; j < MAX_G; ++j)
        if (j < g) rotate8<false>(lo[j], hi[j], cs_, sn, 8 * c);
    }
#pragma unroll
    for (int j = 0; j < MAX_G; ++j)
      if (j < g) {
        bf16* d = qs + ((ro - r0) * g + j) * RSTR + 8 * c;
        st16(d, lo[j]), st16(d + HALF, hi[j]);
      }
  }
  for (int i = nro * g * 16 + tid; i < mrows * 16; i += NT)  // MMA rows past the item's
    st16(qs + (i / 16) * RSTR + 8 * (i % 16), make_uint4(0, 0, 0, 0));
  if (walk && n == 0) {  // the whole cluster: zeros from rank 0
    cp_async_wait<0>();  // nothing may land in a CTA's shared memory after it exits
    if (it.idx == 0)
      for (int i = tid; i < g * kD / 8; i += NT) st16(out_walk + 8 * i, make_uint4(0, 0, 0, 0));
    return;
  }
  // The pages' readers: tile, every live warp (one with query rows) reads
  // every sub-chunk; walk, warp w the sub-chunks j (in the CTA's range)
  // with j % NW == w. A page's readers put its copies in flight, each a
  // share.
  const int spp = geo.rows16 / 16;
  const int live = walk ? NW : min(NW, ((r1 - r0) * g + 15) / 16);
  const int readers = walk ? min(spp, NW) : live;
  auto reader = [&](int i) {  // this warp's place among page i's readers, or -1
    if (!walk) return warp < live ? warp : -1;
    const int ri = (warp - i * spp % NW + NW) % NW;
    return ri < readers ? ri : -1;
  };
  cp_async_wait<0>();
  if (tid == 0) {
    for (int s = 0; s < geo.stages; ++s)
      wg::mbar_init(&sh.full[s], 32 * readers), sh.done[s] = 0;
    wg::fence_barrier_init();
  }
  __syncthreads();  // the query rows, the block-table row, the barriers
  unsigned qa[8][4];
  {
    const bf16* qw = qs + ((walk ? 0 : 16 * warp) + lane % 16) * RSTR + (lane / 16) * 8;
#pragma unroll
    for (int k = 0; k < 8; ++k) ldsm4(qa[k], qw + 16 * k);
  }
  // a walk's rank 0 turns its query rows into the partials' slots
  if (walk && cs > 1) wg::cluster_arrive();

  const int* bts = table + rg.lo;
  const int npc = rg.hi - rg.lo;
  auto cells = [&](int i) { return min(a.page, n - (rg.lo + i) * a.page); };
  for (int i = 0; i < npc && i < geo.stages; ++i) {
    const int ri = reader(i);
    if (ri >= 0) issue(sh, dyn, a, geo, bts, plane, i, cells(i), ri, readers);
  }

  float acc[16][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // 1. the pages
  if (warp < live) {
    for (int i = 0; i < npc; ++i) {
      const int ri = reader(i), j0 = i * spp;
      if (ri < 0) continue;
      const int s = i % geo.stages, cnt = cells(i);
      if (i >= geo.stages) {
        // page i goes in flight only once page i - stages has no reader
        // left; until then the stage's barrier is still in that page's
        // phase, and a wait on page i's parity would pass at once (a
        // walk's reader warp rotates, so it can get here a ring ahead)
        if (lane == 0)
          while (*reinterpret_cast<volatile int*>(&sh.done[s]) < readers * (i / geo.stages)) {
          }
        __syncwarp();
      }
      wg::mbar_wait(&sh.full[s], (i / geo.stages) & 1);
      unsigned char* st = dyn + (size_t)s * geo.stage_bytes;
      float* ksc = reinterpret_cast<float*>(st + 2 * geo.kv_bytes);  // int8 only
      float* vsc = ksc + geo.rows16;
      if (self_off >= 0 && self_off / a.page == i &&
          (j0 + (self_off % a.page) / 16) % NW == warp) {
        // K3's own cell over the copy's read of it, which may have raced
        // with the pool write (int8: its codes, 4 a lane, and its scales)
        const int r = self_off % a.page;
        unsigned char* kr = st + r * geo.row_bytes;
        unsigned char* vr = kr + geo.kv_bytes;
        if constexpr (Q8) {
          reinterpret_cast<unsigned*>(kr)[lane] = reinterpret_cast<const unsigned*>(sh.kself)[lane];
          reinterpret_cast<unsigned*>(vr)[lane] = reinterpret_cast<const unsigned*>(sh.vself)[lane];
          if (lane == 0) ksc[r] = sh.self_sc[0], vsc[r] = sh.self_sc[1];
        } else {
          reinterpret_cast<uint2*>(kr)[lane] = reinterpret_cast<const uint2*>(sh.kself)[lane];
          reinterpret_cast<uint2*>(vr)[lane] = reinterpret_cast<const uint2*>(sh.vself)[lane];
        }
        __syncwarp();
      }
      for (int k = 0; k < spp; ++k) {
        if ((walk && (j0 + k) % NW != warp) || 16 * k >= cnt) continue;
        const int vis = min(16, cnt - 16 * k);
        attend16<Q8>(st + 16 * k * geo.row_bytes, st + geo.kv_bytes + 16 * k * geo.row_bytes,
                     Q8 ? ksc + 16 * k : nullptr, Q8 ? vsc + 16 * k : nullptr, vis, vis, vis,
                     qa, a.scale, acc, m, l);
      }
      // count this warp out of the stage; once every reader is out, the
      // readers put page i + stages in flight into it, each its share
      __syncwarp();
      if (lane == 0) __threadfence_block(), atomicAdd(&sh.done[s], 1);
      if (i + geo.stages < npc) {
        if (lane == 0) {
          const int want = readers * (i / geo.stages + 1);
          while (*reinterpret_cast<volatile int*>(&sh.done[s]) < want) {
          }
          __threadfence_block();
        }
        __syncwarp();
        issue(sh, dyn, a, geo, bts, plane, i + geo.stages, cells(i + geo.stages), ri, readers);
      }
    }
  }

  // 2. a tile's fresh keys: u < min(fresh_lens, r1), causal per row
  if (!walk) {
    constexpr int NF = fresh_depth<FUSED>(), FB = fresh_bytes<FUSED>();
    const int nf = min(fresh_lens[b], r1), nsub = (nf + 15) / 16;
    const int ro0 = r0 + (16 * warp + gr) / g, ro1 = r0 + (16 * warp + gr + 8) / g;
    const int wlast = min(r0 + (16 * warp + 15) / g, r1 - 1);  // the warp's last row
    auto fissue = [&](int f) {
      unsigned char* buf = dyn + (f % NF) * FB;
      for (int i = tid; i < 2 * 16 * 16; i += NT) {  // (K or V, row, 16-byte chunk)
        const int kv = i >> 8, r = (i >> 4) & 15, c = i & 15, u = 16 * f + r;
        const bool ok = u < nf;
        const bf16* src = (kv ? a.v : a.k) + ((size_t)(q0 + (ok ? u : 0)) * a.Hk + kh) * kD;
        cp_async16(buf + (kv * 16 + r) * ROW_BYTES + 16 * c, src + 8 * c, ok);
      }
      if constexpr (FUSED) {  // the rows' cos and sin, [2][16][kD] f32: two bulk copies
        if (tid == 0) {
          float* trig = reinterpret_cast<float*>(buf + 2 * 16 * ROW_BYTES);
          const uint32_t bytes = min(16, nf - 16 * f) * kD * 4;
          const size_t row = (size_t)(q0 + 16 * f) * kD;
          wg::fence_proxy_async();  // after the buffer's reads by the threads
          wg::mbar_arrive_expect_tx(&sh.trig_full[f % NF], 2 * bytes);
          wg::bulk_load(trig, a.cos + row, bytes, &sh.trig_full[f % NF]);
          wg::bulk_load(trig + 16 * kD, a.sin + row, bytes, &sh.trig_full[f % NF]);
        }
      }
    };
    if (FUSED && tid == 0) {
      wg::mbar_init(&sh.trig_full[0], 1), wg::mbar_init(&sh.trig_full[1], 1);
      wg::fence_barrier_init();
    }
    __syncthreads();  // every warp is past the pages: the ring is free
#pragma unroll 1
    for (int f = 0; f < NF - 1; ++f) {
      if (f < nsub) fissue(f);
      cp_async_commit();
    }
    // thread (tr, tc) prepares row tr's dims [8 tc, 8 tc + 8) and + 64;
    // an int8 pool's flagged slot then quantizes the row (pool_read)
    const int tr = tid / 8, tc = tid % 8;
    const bool pool_read = FLAGGED && lens[4 * a.B + b] != 0;
#pragma unroll 1
    for (int f = 0; f < nsub; ++f) {
      unsigned char* buf = dyn + (f % NF) * FB;
      bf16* kb = reinterpret_cast<bf16*>(buf);
      bf16* vb = kb + 16 * RSTR;
      const int u = 16 * f + tr;
      cp_async_wait<NF - 2>();
      if constexpr (FUSED) wg::mbar_wait(&sh.trig_full[f % NF], (f / NF) & 1);
      __syncthreads();  // sub-chunk f landed; every warp is past sub-chunk f - 1
      if (f + NF - 1 < nsub) fissue(f + NF - 1);
      cp_async_commit();
      if (u < nf) {
        bf16* kr = kb + tr * RSTR + 8 * tc;
        bf16* vr = vb + tr * RSTR + 8 * tc;
        uint4 lo = ld16(kr), hi = ld16(kr + HALF);
        if constexpr (FUSED) {
          const float* trig = reinterpret_cast<const float*>(buf + 2 * 16 * ROW_BYTES);
          Trig cs_, sn;
          cs_.load(trig + tr * kD, 8 * tc);
          sn.load(trig + (16 + tr) * kD, 8 * tc);
          rotate8<true>(lo, hi, cs_, sn, 8 * tc);
        } else {
          lo = zero_non_finite8(lo), hi = zero_non_finite8(hi);
        }
        if constexpr (FLAGGED) {
          uint4 vlo = zero_non_finite8(ld16(vr)), vhi = zero_non_finite8(ld16(vr + HALF));
          if (pool_read) {  // the row's codes in place, its scales in the rows' padding
            const float ks = codes_in_place(lo, hi), vs = codes_in_place(vlo, vhi);
            if (tc == 0)
              *reinterpret_cast<float*>(kb + tr * RSTR + kD) = ks,
              *reinterpret_cast<float*>(vb + tr * RSTR + kD) = vs;
          }
          st16(kr, lo), st16(kr + HALF, hi), st16(vr, vlo), st16(vr + HALF, vhi);
        } else {
          st16(kr, lo), st16(kr + HALF, hi);
          st16(vr, zero_non_finite8(ld16(vr))), st16(vr + HALF, zero_non_finite8(ld16(vr + HALF)));
        }
      }
      __syncthreads();
      const int u0 = 16 * f;
      if (warp < live && wlast >= u0) {
        const int cap = min(16, nf - u0);
        // pool_read: the rows past cap hold no codes and no scales
        const float* fks = pool_read ? reinterpret_cast<const float*>(kb + kD) : nullptr;
        const float* fvs = pool_read ? reinterpret_cast<const float*>(vb + kD) : nullptr;
        attend16<false>(kb, vb, fks, fvs, max(0, min(cap, ro0 - u0 + 1)),
                        max(0, min(cap, ro1 - u0 + 1)), pool_read ? cap : 16, qa, a.scale,
                        acc, m, l);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // 3. a tile's rows: acc / max(l, 1e-30) in bf16
  if (!walk) {
    if (warp < live)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 16 * warp + gr + 8 * r, ro = r0 + i / g;
        if (ro >= r1) continue;
        const float lk = fmaxf(l[r], 1e-30f);
        bf16* o = a.out + ((size_t)(q0 + ro) * a.H + kh * g + i % g) * kD + 2 * tq;
#pragma unroll
        for (int t = 0; t < 16; ++t)
          *reinterpret_cast<__nv_bfloat162*>(o + 8 * t) =
              __floats2bfloat162_rn(acc[t][2 * r] / lk, acc[t][2 * r + 1] / lk);
      }
    return;
  }

  // 3. a walk: its warps' partials merge in warp order, then (cs > 1) the
  // ranks' in rank order on rank 0
  __syncthreads();  // every warp is past the pages: the ring holds the warps' partials
  float* wp = reinterpret_cast<float*>(dyn);  // [NW][MAX_G][kD]
  if (gr < g) {
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      float* o = wp + (warp * MAX_G + gr) * kD + 8 * t + 2 * tq;
      o[0] = acc[t][0], o[1] = acc[t][1];
    }
    if (tq == 0) sh.wm[warp][gr] = m[0], sh.wl[warp][gr] = l[0];
  }
  __syncthreads();
  const int rank = it.idx;
  float* slots = reinterpret_cast<float*>(dyn + geo.q_off);  // rank 0's
  const int sl = geo.slot / 4;
  if (cs > 1) wg::cluster_wait();  // every rank is past its query rows
  for (int idx = tid; idx < g * kD / 4; idx += NT) {
    const int j = idx / (kD / 4), d = 4 * (idx % (kD / 4));
    float mt = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mt = fmaxf(mt, sh.wm[w][j]);
    float lt = 0.f, at[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = expf(sh.wm[w][j] - mt);
      const float4 x = *reinterpret_cast<const float4*>(wp + (w * MAX_G + j) * kD + d);
      lt += sh.wl[w][j] * e;
      at[0] += x.x * e, at[1] += x.y * e, at[2] += x.z * e, at[3] += x.w * e;
    }
    if (cs == 1) {
      lt = fmaxf(lt, 1e-30f);
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out_walk + (size_t)j * kD + d);
      o[0] = __floats2bfloat162_rn(at[0] / lt, at[1] / lt);
      o[1] = __floats2bfloat162_rn(at[2] / lt, at[3] / lt);
      continue;
    }
    float* slot = slots + rank * sl;
    const float4 v = make_float4(at[0], at[1], at[2], at[3]);
    if (rank == 0) {
      *reinterpret_cast<float4*>(slot + j * kD + d) = v;
      if (d == 0) slot[g * kD + j] = mt, slot[g * kD + MAX_G + j] = lt;
    } else {
      wg::st_rank_f4(slot + j * kD + d, 0, v);
      if (d == 0) {
        wg::st_rank_f32(slot + g * kD + j, 0, mt);
        wg::st_rank_f32(slot + g * kD + MAX_G + j, 0, lt);
      }
    }
  }
  if (cs == 1) return;
  wg::cluster_sync();  // every rank's partial is in rank 0's slots
  if (rank > 0) return;
  for (int idx = tid; idx < g * kD / 4; idx += NT) {
    const int j = idx / (kD / 4), d = 4 * (idx % (kD / 4));
    float mt = kNegInf;
    for (int r = 0; r < cs; ++r) mt = fmaxf(mt, slots[r * sl + g * kD + j]);
    float lt = 0.f, at[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < cs; ++r) {
      const float* slot = slots + r * sl;
      const float e = expf(slot[g * kD + j] - mt);
      const float4 x = *reinterpret_cast<const float4*>(slot + j * kD + d);
      lt += slot[g * kD + MAX_G + j] * e;
      at[0] += x.x * e, at[1] += x.y * e, at[2] += x.z * e, at[3] += x.w * e;
    }
    lt = fmaxf(lt, 1e-30f);
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out_walk + (size_t)j * kD + d);
    o[0] = __floats2bfloat162_rn(at[0] / lt, at[1] / lt);
    o[1] = __floats2bfloat162_rn(at[2] / lt, at[3] / lt);
  }
}

// The plan as the CTAs decode it: row blockIdx.y * gridDim.x + blockIdx.x
// of out (6 ints a row) = (kind, slot, kv head, rank or tile, first key,
// end key): a walk's keys are its range's cells [lo page, min(hi page, n));
// a tile's [0, page_lens + its fresh keys); an empty CTA's (0, -1, kh, 0,
// 0, 0)
__global__ void items_kernel(const int* page_lens, const int* q_lens, const int* fresh_lens,
                             int B, int g, int page, int pps, int cs, int* out) {
  const Item it =
      decode(q_lens, fresh_lens, B, ROWS / g, cs, blockIdx.x / cs, blockIdx.x % cs);
  if (threadIdx.x) return;
  int first = 0, end = 0;
  if (it.kind == kWalk) {
    const int n = page_lens[it.b];
    const pw::Range x = pw::range_of(n, page, pps, it.idx, cs);
    first = x.lo * page;
    end = min(x.hi * page, n);
  } else if (it.kind == kTile) {
    const int r1 = min(q_lens[it.b], (it.idx + 1) * (ROWS / g));
    end = page_lens[it.b] + min(fresh_lens[it.b], r1);
  }
  int* o = out + 6 * ((size_t)blockIdx.y * gridDim.x + blockIdx.x);
  o[0] = it.kind, o[1] = it.b, o[2] = blockIdx.y, o[3] = it.idx, o[4] = first, o[5] = end;
}

// ---- host side ----------------------------------------------------------------

// (cs, clusters a kv head, dynamic shared memory) of a wave's grid over a
// pool of esz-byte elements (the plan itself does not depend on it)
struct Plan {
  int cs, clusters, smem;
};
inline Plan plan(int T, int B, int H, int Hk, int page, int pps, int esz) {
  const int g = H / Hk;
  Plan p;
  p.cs = pw::cluster_size(B, Hk, pps, pw::sms());
  p.clusters = clusters_per_head(T, B, ROWS / g, p.cs);
  p.smem = Geo(page, pps, p.cs, g, B, esz).smem;
  return p;
}

// (a bf16 pool ignores a fresh_pool_read flag: its roundtrip is the
// identity; an int8 pool's flag takes the FLAGGED instance)
template <bool FUSED, typename Pool>
cudaError_t launch(Args<Pool> a, cudaStream_t stream) {
  if (a.T == 0) return cudaSuccess;
  const Plan p = plan(a.T, a.B, a.H, a.Hk, a.page, a.pps, sizeof(Pool));
  a.cs = p.cs;
  a.clusters = p.clusters;
  const dim3 grid(p.clusters * p.cs, a.Hk);
  if constexpr (sizeof(Pool) == 1)
    if (a.fresh_pool_read)
      return pw::launch_clusters(ragged_walk_kernel<FUSED, Pool, true>, grid, p.cs, NT, p.smem,
                                 stream, a);
  return pw::launch_clusters(ragged_walk_kernel<FUSED, Pool>, grid, p.cs, NT, p.smem, stream, a);
}

// The plan's items into out (clusters * cs * Hk rows of 6)
inline cudaError_t items(const int* page_lens, const int* q_lens, const int* fresh_lens, int T,
                         int B, int H, int Hk, int page, int pps, int* out, cudaStream_t stream) {
  const Plan p = plan(T, B, H, Hk, page, pps, 2);
  return pw::launch_clusters(items_kernel, dim3(p.clusters * p.cs, Hk), p.cs, 32, 0, stream,
                             page_lens, q_lens, fresh_lens, B, H / Hk, page, pps, p.cs, out);
}

// out[0..4) = (cs, clusters a kv head, dynamic shared memory bytes, the
// most clusters of the kernel this card holds at once; the FLAGGED
// instance has the same shared memory and launch bounds)
template <bool FUSED, typename Pool>
cudaError_t describe(int T, int B, int H, int Hk, int page, int pps, int* out) {
  const Plan p = plan(T, B, H, Hk, page, pps, sizeof(Pool));
  const void* fn = reinterpret_cast<const void*>(ragged_walk_kernel<FUSED, Pool>);
  cudaError_t err = pw::allow_smem(fn, p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg =
      pw::cluster_config(dim3(p.clusters * p.cs, Hk), p.cs, NT, p.smem, nullptr, &cluster);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, fn, &cfg);
  out[0] = p.cs, out[1] = p.clusters, out[2] = p.smem, out[3] = active;
  return err;
}

}  // namespace
}  // namespace rw
}  // namespace pt
