// Flash-decode attention for Hopper (sm_90a): the kernel body that
// csrc/decode_attention.cu instantiates for K3 (K/V of q's type) and K4
// (int8 K/V with f32 scales) over the slotted cache, and that
// csrc/paged_attention.cu instantiates for K2/K8a and K5/K8b over page pools
// reached through a page table.
//
// Computes, for q [B, T, Hq, Dh] and one layer of the keys and values,
//
//   out[b, t, h*G + g, :] = sum_s softmax_s(scale * q . k_s) v_s
//
// over the key positions s <= offsets[b] + t (G = Hq / Hk query heads share KV
// head h), with the semantics of the TPU kernels _kernel and _kernel_quant
// (specdec_tpu/ops/decode_attention.py, and paged_attention.py's four, whose
// math is the same): scores, running max and sum and the P.V accumulator in
// f32; the k-scale multiplies the score after (q.k) * scale; the v-scale
// multiplies the unnormalized probability, which is then rounded to q's type
// for P.V; the result is divided by max(l, 1e-38) and written in q's type.
// `scale` is the f32 1/sqrt(Dh).
//
// Where key position s of sequence b, KV head h lives is the kernel's Keys
// parameter, the index of its row (Dh elements of K and of V, one scale of
// each): Slotted, the cache [B, S, Hk, Dh], row (b*S + s)*Hk + h; Paged, pools
// [NP, Hk, page, Dh] through table [B, MP], row (table[b, s / page]*Hk + h)*
// page + s % page, with capacity S = MP * page (the table's width). The rest
// of the design does not depend on it.
//
// What bounds it on an H100: bytes, the live K and V of each sequence read
// once (0.06-0.7 us at the main path's shapes), far below the latency of one
// launch. The body it replaces (attention_tile.cuh) ran B*Hk blocks (4 on
// 132 SMs at B=1), each walking its sequence's tiles one after another,
// with serial f32 dot products from K/V staged as f32: 55-121 us a call.
// This design attacks the latency chain.
//
// Design:
//   - Spans. The cache's 64-key tiles are cut into C spans of `span`
//     consecutive tiles, span the fewest that let C <= kMaxCluster (8, the
//     portable cluster size) cover S: a function of S alone. A query row's
//     result is a fixed function of its span partials: each span's
//     (m, l, acc) over its live keys, combined in span order by the online
//     rule m' = max(m, m_v), l' = l * exp(m - m') + l_v * exp(m_v - m'),
//     acc' likewise, from the empty state (-1e30, 0, 0). A span past a
//     row's position is an exact no-op for it (masked probabilities are set
//     to 0, so m stays, alpha = exp(0) = 1; an empty partial has weight
//     exp(-1e30 - m') = 0, and no NaN), so a block may skip the spans and
//     tiles past its rows' largest position.
//   - Rows. A block holds 16 query rows of one (b, h) (row r is query head
//     h*G + r % G at position t = r / G, read straight from q's layout); its
//     4 warps each own 16 keys of every tile and keep their own running
//     (m, l, acc) per row; at the end of a span the block merges its warps'
//     partials (in warp order) into the span's partial. Every row runs the
//     same operations in the same order whatever T, B or its neighbours are
//     (the greedy oracles compare AR at T=1 with the verify at T=13, and a
//     serving sequence alone with the same sequence in a batch).
//   - Two ways to place the spans on the card, chosen at launch from the
//     grid's size alone (they give the same bits):
//     split: a thread-block cluster of C blocks per (b, h, row tile), block
//       c computing span c; it pushes its partial of row r by remote stores
//       into the shared memory of block r % C (map_shared_rank, slot c);
//       after one cluster.sync() that block combines the row's live span
//       partials in span order and writes the row. A cluster barrier arrived
//       at after the tile loop and waited on before the first remote store
//       makes sure every block is past its tiles (the inbox reuses the
//       ring). The launch takes the split when its grid fits the card at 4
//       blocks an SM (decode, verify and the serving draft steps). At B=1,
//       Hk=4, S=334 that is 6 x 4 = 24 blocks instead of 4.
//     local: one block per (b, h, row tile) walks every live span and
//       combines each span's partial as it completes: for the prefills,
//       whose many row tiles fill the card, and where split blocks whose
//       spans are dead for their rows would hold SMs at the cluster barrier.
//     One launch either way, no workspace, no atomics; the C entry point and
//     the wrapper are those of the kernel it replaces.
//   - bf16 q: Q.K^T and P.V on the tensor cores, mma.sync m16n8k16 bf16 with
//     f32 accumulation. Q's fragments are loaded from global memory into
//     registers once, every load issued before any is used (loads under a
//     branch went one after another). The 16 k-indices of an mma are
//     permuted (2t + h -> 4t + h, 2t + 8 + h -> 4t + 2 + h, shared by A and
//     B, so the sum is the same up to f32 order): a thread's Q fragment is 4
//     consecutive d of a row (one 8-byte load) and its K fragment 4
//     consecutive d of a key (8 bytes of bf16 or 4 of int8). The 16 keys of
//     a warp are assigned to the score mma's columns so that its C fragments
//     are, register for register, the A fragments of the P.V mma (the score
//     tile never leaves registers): score n-tile j, column 2t + h is key
//     4t + 2j + h. A bf16 V fragment pair of
//     two n-tiles is one ldmatrix.x4.trans. An int8 key or value converts
//     to bf16 exactly (|x| <= 128), through the f32 2^23 trick.
//     Dh % 16 == 8 pads the last k-step with zeros in registers.
//   - f32 q (the float32 oracles): the same spans, partials and merges, with
//     f32 products on the CUDA cores: lane (key k, row half) computes 8 rows'
//     scores of its key against Q staged in shared memory; the probabilities
//     go through shared memory and lane d accumulates P.V for all 16 rows.
//   - Staging: K and V (and the int8 scales) are copied in their stored type
//     with cp.async into a double-buffered ring (the copy of tile i + 1 is in
//     flight while tile i is computed, across span boundaries too), rows
//     padded by 16 bytes. Positions past the block's largest live position
//     (and past S) read as zeros (cp.async's src_bytes = 0) and are masked;
//     their rows are not computed, so a paged block reads no table entry
//     past its rows' last live page, whatever those entries hold. A masked
//     probability is exactly 0 and its zero key and value add nothing.
//   - Paged rows: the tile is 64 positions whatever the page size (a page,
//     part of one, or several). Threads 0-63 read the pages of the tile
//     after next from the table into registers while a tile is computed
//     and put their rows in shared memory after it, so a table read adds
//     no latency to a tile's copy but the first two.
// Alternatives, timed on the H100 in turns with this design (PERF.md; a
// variant is timed by `chip_smoke.py --against decode_attention=DIR/
// decode_attention.cu`, or `paged_attention=DIR/paged_attention.cu`, with
// the modified copy of this header beside it in DIR): the split for every
// call is 2-3x slower at the prefills (blocks whose spans are dead for their
// rows hold SMs at the cluster barrier), local for every call 2x slower at
// decode; neither wins at every paged shape (the split at the B=4 verify
// and S=2048, local at the serving verify, a chunk and Dh=128); at most 4
// or 2 spans make decode slower and the admission faster; at most 16 put
// more blocks of K3's bf16 K/V on the card at S=2048 than fit at once.
// Slower, or no faster, in earlier builds: pulling a row's 4C warp
// partials through distributed shared memory, one remote load after
// another; summing the warps' partials into one buffer warp after warp; a
// ring of four tiles for local blocks (a local block waits on
// instructions, not on its copies); a merge that loads four elements
// before storing them. Not done yet: cheaper span merges for local blocks
// (one per tile where a span is one tile), more warps per local block, and
// a placement that weighs the live tiles a local block walks, not only
// the grid's size (S=2048, T=64 runs local where the split is faster).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

namespace cg = cooperative_groups;

constexpr int kTile = 64;                  // keys per tile
constexpr int kWarps = 4;                  // each owns 16 keys of a tile
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpKeys = kTile / kWarps;  // 16
constexpr int kRows = 16;                  // query rows per block
constexpr int kMaxCluster = 8;             // spans (blocks of a cluster)
constexpr int kStages = 2;                 // tiles in the ring
// a split block's inbox: C * ceil(kRows / C) < kRows + C row slots
constexpr int kMaxInbox = kRows + kMaxCluster;
// per row: the warps' weights, two numbers of the span partial, then two
// coefficients per span
constexpr int kMergeFloats = kWarps + 2 + 2 * kMaxCluster;
constexpr float kNegInf = -1e30f;

// The spans of a cache of capacity S: tiles of 64 keys, `span` tiles each,
// `clusters_of` spans (ops/decode_attention.py, split)
__host__ __device__ inline int tiles_of(int S) {
  return (S + kTile - 1) / kTile;
}
__host__ __device__ inline int span_of(int S) {
  return (tiles_of(S) + kMaxCluster - 1) / kMaxCluster;
}
__host__ __device__ inline int clusters_of(int S) {
  return (tiles_of(S) + span_of(S) - 1) / span_of(S);
}

// bytes of a staged K or V row: Dh elements of kv_bytes each, plus 16
__host__ __device__ inline int row_stride(int dh, int kv_bytes) {
  return dh * kv_bytes + 16;
}

// Dynamic shared memory of one block, in order: the ring (kStages tiles of K
// and V, and for int8 their scales), which a split block's inbox (acc
// [kMaxInbox][Dh], m and l [kMaxInbox]) reuses once every block of its
// cluster is past its tiles; the warps' partials, acc [4][16][Dh], m and l
// [4][16]; for f32 q, Q [16][Dh + 4], the warps' probabilities [4][16][17]
// and their alphas [4][16]; the merge's per-row numbers [16][kMergeFloats];
// a local block's running acc [16][Dh], m and l [16]; the rows of the
// positions of the tiles in the ring [kStages][kTile] (64-bit; paged only).
// ops/attention_args.py computes the same.
struct Layout {
  int ring_v, scales, parts, parts_m, parts_l, qs, pw, alpha, merge, run,
      rows, total;
};

__host__ __device__ inline Layout layout(int dh, bool q_f32, int kv_bytes) {
  Layout o;
  const int tile_bytes = kTile * row_stride(dh, kv_bytes);
  o.ring_v = kStages * tile_bytes;
  o.scales = 2 * kStages * tile_bytes;
  const int ring = o.scales + (kv_bytes == 1 ? 2 * kStages * kTile * 4 : 0);
  const int inbox = kMaxInbox * (dh + 2) * 4;
  o.parts = ring > inbox ? ring : inbox;
  o.parts_m = o.parts + kWarps * kRows * dh * 4;
  o.parts_l = o.parts_m + kWarps * kRows * 4;
  o.qs = o.parts_l + kWarps * kRows * 4;
  o.pw = o.qs + (q_f32 ? kRows * (dh + 4) * 4 : 0);
  o.alpha = o.pw + (q_f32 ? kWarps * kRows * (kWarpKeys + 1) * 4 : 0);
  o.merge = o.alpha + (q_f32 ? kWarps * kRows * 4 : 0);
  o.run = o.merge + kRows * kMergeFloats * 4;
  o.rows = o.run + kRows * (dh + 2) * 4;
  o.total = o.rows + kStages * kTile * 8;
  return o;
}

struct Args {
  const void* q;
  const void* k;  // one layer
  const void* v;
  const float* ks;  // int8 K/V only
  const float* vs;
  const int32_t* offsets;
  void* out;
  int T, Hq, Hk, Dh, S;  // S: the capacity (paged: MP * page)
  float scale;
  const int32_t* table;  // paged only: [B, MP]
  int MP, page;
};

// The key layouts: where the row of key position s (0 <= s < S) of sequence
// b, KV head h lives, its K/V at row * Dh elements and its scales at row.
struct Slotted {  // the slotted cache [B, S, Hk, Dh]
  static constexpr bool kPaged = false;
  __device__ static long long row(const Args& a, int b, int s, int h) {
    return ((long long)b * a.S + s) * a.Hk + h;
  }
};
struct Paged {  // pools [NP, Hk, page, Dh] through table [B, MP]
  static constexpr bool kPaged = true;
  // the pool page holding position s: its table entry
  __device__ static int page_of(const Args& a, int b, int s) {
    return __ldg(a.table + (long long)b * a.MP + s / a.page);
  }
  // the row of position s on pool page pg
  __device__ static long long row_on(const Args& a, int pg, int s, int h) {
    return ((long long)pg * a.Hk + h) * a.page + s % a.page;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (4 or 16); source bytes past src_bytes read as zeros
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

// wait until at most one committed group of this thread is pending
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory, transposed: lanes 8i .. 8i + 7
// give the row addresses of matrix i, and lane (g, t) receives rows 2t and
// 2t + 1 of column g of matrix i in r_i (row 2t in the low half)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(row))
      : "memory");
}

// bf16x2 of two floats: `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&r);
}

// bf16x2 of two int8 values, exactly: 2^23 + (x + 128) as an f32, less
// 2^23 + 128, is x; an 8-bit integer's f32 has zero low halves, so its high
// half is its bf16
__device__ __forceinline__ uint32_t i8_to_bf16x2(int lo, int hi) {
  const float a = __uint_as_float(0x4B000000u | (uint32_t)(lo + 128)) -
                  8388736.0f;
  const float b = __uint_as_float(0x4B000000u | (uint32_t)(hi + 128)) -
                  8388736.0f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Copy tile `tile` of sequence b, head h (K, V and, for int8, their scales)
// into ring slot `st`. Positions past last_pos (the block's largest live
// position, < S) read as zeros from the layer's first row, and their rows
// are not computed. Slotted computes the rows; Paged takes them from `rows`
// in shared memory (-1 for such positions).
template <typename TKV, typename Keys>
__device__ __forceinline__ void stage_tile(const Args& a, int b, int h,
                                           int tile, int st, unsigned char* sm,
                                           const Layout& lo, int last_pos) {
  constexpr int kvb = sizeof(TKV);
  const int rs = row_stride(a.Dh, kvb);
  const int per_row = a.Dh * kvb / 16;
  const int s0 = tile * kTile;
  unsigned char* kd = sm + st * kTile * rs;
  unsigned char* vd = sm + lo.ring_v + st * kTile * rs;
  const char* kg = static_cast<const char*>(a.k);
  const char* vg = static_cast<const char*>(a.v);
  const long long* rows =
      reinterpret_cast<const long long*>(sm + lo.rows) + st * kTile;
  auto row_at = [&](int j) -> long long {
    if constexpr (Keys::kPaged)
      return rows[j];
    else
      return s0 + j <= last_pos ? Keys::row(a, b, s0 + j, h) : -1;
  };
  // chunk threadIdx.x + n * kThreads is 16-byte column c of row r: stepped
  // without a division (per_row <= 32)
  const int dr = kThreads / per_row, dc = kThreads - dr * per_row;
  for (int r = threadIdx.x / per_row, c = threadIdx.x - r * per_row;
       r < kTile;) {
    const long long row = row_at(r);
    const long long src = (row < 0 ? 0 : row * a.Dh * kvb) + c * 16;
    cp_async<16>(kd + r * rs + c * 16, kg + src, row < 0 ? 0 : 16);
    cp_async<16>(vd + r * rs + c * 16, vg + src, row < 0 ? 0 : 16);
    r += dr;
    c += dc;
    if (c >= per_row) c -= per_row, ++r;
  }
  if constexpr (std::is_same<TKV, int8_t>::value) {
    float* ksd = reinterpret_cast<float*>(sm + lo.scales) + st * 2 * kTile;
    for (int i = threadIdx.x; i < 2 * kTile; i += kThreads) {
      const long long row = row_at(i % kTile);
      cp_async<4>(ksd + i, (i < kTile ? a.ks : a.vs) + (row < 0 ? 0 : row),
                  row < 0 ? 0 : 4);
    }
  }
}

// the first half of the cluster barrier a split block waits on before its
// first remote store: arrived at once the block is past its tiles
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}

// The kernel. TQ: q's and out's type (float: CUDA cores; bf16: tensor
// cores); TKV: the stored K/V (TQ, or int8 with scales); kMaxDh: 64 or 128,
// the register arrays' size (Dh <= kMaxDh, a multiple of 8; of 16 for int8);
// Keys: Slotted or Paged. Launched in clusters of C blocks (split) or of 1
// (local).
// 4 blocks an SM for bf16 q up to Dh = 64 (at most 128 registers a thread;
// Dh = 128 and f32 q would spill under that cap)
template <typename TQ, typename TKV, int kMaxDh, typename Keys>
__global__ void __launch_bounds__(
    kThreads, std::is_same<TQ, __nv_bfloat16>::value && kMaxDh == 64 ? 4 : 1)
flash_decode_kernel(const Args a) {
  constexpr bool kMma = std::is_same<TQ, __nv_bfloat16>::value;
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int kvb = sizeof(TKV);
  extern __shared__ __align__(16) unsigned char sm[];
  cg::cluster_group cluster = cg::this_cluster();

  const Layout lo = layout(a.Dh, !kMma, kvb);
  const int Dh = a.Dh, S = a.S;
  const int rs = row_stride(Dh, kvb);
  const bool split = cluster.num_blocks() > 1;
  const int rank = (int)cluster.block_rank();
  const int C = clusters_of(S), span = span_of(S);
  const int G = a.Hq / a.Hk, TG = a.T * G;
  const int row0 = blockIdx.y * kRows;
  const int live_rows = min(kRows, TG - row0);
  const int b = blockIdx.z / a.Hk, h = blockIdx.z - b * a.Hk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const TQ* q = static_cast<const TQ*>(a.q);
  TQ* out = static_cast<TQ*>(a.out);
  const int off = a.offsets[b];

  // the tiles of this block: its span (split) or all spans (local), up to
  // the tile of last_pos, its rows' largest position; n_live spans hold
  // such tiles
  const int t_max = (row0 + live_rows - 1) / G;
  const int last_pos = min(off + t_max, S - 1);
  const int last = last_pos / kTile;
  const int n_live = last / span + 1;
  const int t0 = split ? rank * span : 0;
  const int t1 = split ? min(t0 + span, last + 1) : last + 1;

  // Paged: thread j < kTile reads the page of position j of a tile of this
  // block (-1 past last_pos or past the block's tiles, whose entries are
  // not read) and puts the position's row into the rows of the tile's ring
  // slot: for the first two tiles here, for tile i + 2 while tile i is
  // computed (load_page, then put_row after the tile)
  long long* rows = reinterpret_cast<long long*>(sm + lo.rows);
  auto load_page = [&](int tile) -> int {
    const int s = tile * kTile + threadIdx.x;
    if constexpr (Keys::kPaged) {
      // read without a branch, from a live position's entry
      const int pg = Keys::page_of(a, b, max(min(s, last_pos), 0));
      return tile < t1 && s <= last_pos ? pg : -1;
    } else {
      return -1;
    }
  };
  auto put_row = [&](int st, int tile, int pg) {
    if constexpr (Keys::kPaged)
      if (threadIdx.x < kTile)
        rows[st * kTile + threadIdx.x] =
            pg < 0 ? -1 : Keys::row_on(a, pg, tile * kTile + threadIdx.x, h);
  };
  if constexpr (Keys::kPaged) {
    if (threadIdx.x < kTile) {
      const int pg0 = load_page(t0), pg1 = load_page(t0 + 1);
      put_row(0, t0, pg0);
      put_row(1, t0 + 1, pg1);
    }
    __syncthreads();
  }
  if (t0 < t1) stage_tile<TKV, Keys>(a, b, h, t0, 0, sm, lo, last_pos);
  cp_async_commit();

  // element (row r, d = 0) of q and out for this block's row r
  auto q_index = [&](int r) -> size_t {
    const int R = row0 + r, t = R / G, g = R - t * G;
    return ((size_t)(b * a.T + t) * a.Hq + h * G + g) * Dh;
  };

  float* parts_acc = reinterpret_cast<float*>(sm + lo.parts);
  float* parts_m = reinterpret_cast<float*>(sm + lo.parts_m);
  float* parts_l = reinterpret_cast<float*>(sm + lo.parts_l);
  float* mg = reinterpret_cast<float*>(sm + lo.merge);  // [16][kMergeFloats]
  float* in_acc = reinterpret_cast<float*>(sm);  // split: over the ring
  float* in_m = in_acc + kMaxInbox * Dh;
  float* in_l = in_m + kMaxInbox;
  float* run_acc = reinterpret_cast<float*>(sm + lo.run);  // local
  float* run_m = run_acc + kRows * Dh;
  float* run_l = run_m + kRows;
  if (!split) {
    for (int e = threadIdx.x; e < kRows * Dh; e += kThreads) run_acc[e] = 0.f;
    if (threadIdx.x < kRows) {
      run_m[threadIdx.x] = kNegInf;
      run_l[threadIdx.x] = 0.f;
    }
  }

  // A span is complete and every warp's partial is in parts_*: the span
  // partial is their merge in warp order. Local: it is combined into the
  // running state (and, for the last span, the rows are written); split:
  // it is pushed, once every block of the cluster is past its tiles, to row
  // r's block r % C, slot (r / C) * C + rank.
  auto span_done = [&](bool final) {
    __syncthreads();
    if (threadIdx.x < live_rows) {
      const int r = threadIdx.x;
      float* w = mg + r * kMergeFloats;
      float mx = kNegInf, l = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) mx = fmaxf(mx, parts_m[k * kRows + r]);
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        w[k] = expf(parts_m[k * kRows + r] - mx);
        l = fmaf(w[k], parts_l[k * kRows + r], l);
      }
      if (split) {
        w[kWarps] = mx;
        w[kWarps + 1] = l;
      } else {
        const float m_new = fmaxf(run_m[r], mx);
        const float ca = expf(run_m[r] - m_new), cb = expf(mx - m_new);
        run_l[r] = fmaf(l, cb, run_l[r] * ca);
        run_m[r] = m_new;
        w[kWarps] = ca;
        w[kWarps + 1] = cb;
      }
    }
    __syncthreads();
    if (split) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    // element e = threadIdx.x + n * kThreads is (row r, d), stepped without
    // a division
    const int dr = kThreads / Dh, dd = kThreads - dr * Dh;
    for (int e = threadIdx.x, r = e / Dh, d = e - r * Dh; r < live_rows;
         e += kThreads) {
      const float* w = mg + r * kMergeFloats;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k)
        acc = fmaf(w[k], parts_acc[(k * kRows + r) * Dh + d], acc);
      if (split) {
        const int slot = (r / C) * C + rank, dst = r % C;
        cluster.map_shared_rank(in_acc, dst)[slot * Dh + d] = acc;
        if (d == 0) {
          cluster.map_shared_rank(in_m, dst)[slot] = w[kWarps];
          cluster.map_shared_rank(in_l, dst)[slot] = w[kWarps + 1];
        }
      } else {
        const float x = fmaf(acc, w[kWarps + 1], run_acc[e] * w[kWarps]);
        run_acc[e] = x;
        if (final) store(out + q_index(r) + d, x / fmaxf(run_l[r], 1e-38f));
      }
      r += dr;
      d += dd;
      if (d >= Dh) d -= Dh, ++r;
    }
  };

  if constexpr (kMma) {
    constexpr int kKS = kMaxDh / 16;  // k-steps of Q.K^T
    constexpr int kND = kMaxDh / 8;   // n-tiles of P.V
    const int g = lane >> 2, t = lane & 3;
    const int nks = (Dh + 15) / 16, nnd = Dh / 8;
    // Q fragments, k permuted: row g / g + 8, d = 16 ks + 4t .. + 3 (loaded
    // whether or not the block has live tiles, so as not to wait for the
    // offset first). Every load is issued, from an address clamped into
    // the block's rows and Dh, before any is used, and the fragments past
    // them are zeroed after: a load under a branch waits for its data
    // before the next one is issued.
    uint32_t qa[kKS][4];
    uint2 qw[kKS][2];
    const TQ* qrow[2] = {q + q_index(min(g, live_rows - 1)),
                         q + q_index(min(g + 8, live_rows - 1))};
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        qw[ks][half] = __ldg(reinterpret_cast<const uint2*>(
            qrow[half] + min(16 * ks + 4 * t, Dh - 4)));
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const int d = 16 * ks + 4 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const bool ok = ks < nks && d < Dh && g + 8 * half < live_rows;
        qa[ks][half] = ok ? qw[ks][half].x : 0u;      // a0 / a1: d, d + 1
        qa[ks][2 + half] = ok ? qw[ks][half].y : 0u;  // a2 / a3: d + 2, d + 3
      }
    }
    int qpos[2];
#pragma unroll
    for (int half = 0; half < 2; ++half)
      qpos[half] = off + (row0 + g + 8 * half) / G;

    float m[2], l[2], acc[kND][4];
    auto reset = [&]() {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        m[half] = kNegInf;
        l[half] = 0.f;
      }
#pragma unroll
      for (int nd = 0; nd < kND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
    };
    // this warp's partials of rows g, g + 8 into parts_*; l summed over the
    // quad
    auto write_parts = [&]() {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float x = l[half];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        if (t == 0) {
          parts_m[warp * kRows + g + 8 * half] = m[half];
          parts_l[warp * kRows + g + 8 * half] = x;
        }
      }
#pragma unroll
      for (int nd = 0; nd < kND; ++nd) {
        if (nd >= nnd) break;
        const int d = 8 * nd + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(
              parts_acc + (warp * kRows + g + 8 * half) * Dh + d) =
              make_float2(acc[nd][2 * half], acc[nd][2 * half + 1]);
      }
    };
    reset();

    for (int tile = t0; tile < t1; ++tile) {
      const int st = (tile - t0) & 1;
      if (tile + 1 < t1)
        stage_tile<TKV, Keys>(a, b, h, tile + 1, st ^ 1, sm, lo, last_pos);
      cp_async_commit();
      const int next_page =
          Keys::kPaged && threadIdx.x < kTile ? load_page(tile + 2) : -1;
      if (tile > t0 && tile % span == 0) {  // a span is complete (local)
        write_parts();
        span_done(false);
        reset();
      }
      cp_async_wait_one();
      __syncthreads();
      const unsigned char* kt = sm + st * kTile * rs;
      const unsigned char* vt = sm + lo.ring_v + st * kTile * rs;
      const float* kst =
          reinterpret_cast<const float*>(sm + lo.scales) + st * 2 * kTile;

      // scores: n-tile j, column g is key 4 (g >> 1) + 2j + (g & 1) of the
      // warp's 16
      float sc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
        const int key = kWarpKeys * warp + 4 * (g >> 1) + 2 * j + (g & 1);
        const unsigned char* kr = kt + key * rs;
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) {
          if (ks >= nks) break;
          const int d = 16 * ks + 4 * t;
          uint32_t b0 = 0u, b1 = 0u;
          if (d < Dh) {
            if constexpr (kQuant) {
              const uint32_t w = *reinterpret_cast<const uint32_t*>(kr + d);
              b0 = i8_to_bf16x2((int8_t)(w & 0xFF), (int8_t)((w >> 8) & 0xFF));
              b1 = i8_to_bf16x2((int8_t)((w >> 16) & 0xFF),
                                (int8_t)(w >> 24));
            } else {
              const uint2 w = *reinterpret_cast<const uint2*>(kr + 2 * d);
              b0 = w.x;
              b1 = w.y;
            }
          }
          mma_bf16(sc[j], qa[ks], b0, b1);
        }
      }

      // online softmax: C element (j, e) is row g + 8 (e >> 1), key
      // 4t + 2j + (e & 1) of the warp's 16
      const int kw = kWarpKeys * warp + 4 * t;  // the thread's first key
      const int kpos = tile * kTile + kw;
      bool live[2][4];
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = 2 * j + (e & 1), p = kpos + kk;
          float s = sc[j][e] * a.scale;
          if constexpr (kQuant) s *= kst[kw + kk];
          live[j][e] = p <= qpos[e >> 1] && p < S;
          sc[j][e] = live[j][e] ? s : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
        }
      float alpha[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float x = mx[half];
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float m_new = fmaxf(m[half], x);
        alpha[half] = expf(m[half] - m_new);
        m[half] = m_new;
      }
      float pv[2][4], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = live[j][e] ? expf(sc[j][e] - m[e >> 1]) : 0.f;
          psum[e >> 1] += p;
          if constexpr (kQuant)
            pv[j][e] = p * kst[kTile + kw + 2 * j + (e & 1)];
          else
            pv[j][e] = p;
        }
#pragma unroll
      for (int half = 0; half < 2; ++half)
        l[half] = l[half] * alpha[half] + psum[half];
      // P as the A fragments of P.V (k-index 2t + h: key 4t + h; 2t + 8 + h:
      // key 4t + 2 + h)
      const uint32_t pa[4] = {pack_bf16(pv[0][0], pv[0][1]),
                              pack_bf16(pv[0][2], pv[0][3]),
                              pack_bf16(pv[1][0], pv[1][1]),
                              pack_bf16(pv[1][2], pv[1][3])};
      const unsigned char* vr = vt + kw * rs;  // rows kw .. kw + 3
      // bf16 V: one ldmatrix.x4.trans gives b0 and b1 of n-tiles nd and
      // nd + 1 (matrix 2i + j: b_j of n-tile nd + i); lane l addresses row
      // l & 7 of matrix l >> 3, key 4 ((l & 7) >> 1) + (l & 1) + 2j of the
      // warp's 16 (b_j holds keys 4t + 2j, 4t + 2j + 1), its columns
      // 8 (nd + i) .. + 7. An odd last n-tile reads the row's padding.
      const unsigned char* vl =
          vt +
          (kWarpKeys * warp + 4 * ((lane & 7) >> 1) + (lane & 1) +
           2 * ((lane >> 3) & 1)) * rs +
          16 * (lane >> 4);
      uint32_t vb[4];
#pragma unroll
      for (int nd = 0; nd < kND; ++nd) {
        if (nd >= nnd) break;
        acc[nd][0] *= alpha[0];
        acc[nd][1] *= alpha[0];
        acc[nd][2] *= alpha[1];
        acc[nd][3] *= alpha[1];
        uint32_t b0, b1;
        if constexpr (kQuant) {
          const int8_t* v8 = reinterpret_cast<const int8_t*>(vr) + 8 * nd + g;
          b0 = i8_to_bf16x2(v8[0], v8[rs]);
          b1 = i8_to_bf16x2(v8[2 * rs], v8[3 * rs]);
        } else {
          if (nd % 2 == 0)
            ldmatrix_x4_trans(vb[0], vb[1], vb[2], vb[3], vl + 16 * nd);
          b0 = vb[2 * (nd % 2)];
          b1 = vb[2 * (nd % 2) + 1];
        }
        mma_bf16(acc[nd], pa, b0, b1);
      }
      put_row(st, tile + 2, next_page);  // slot st's next tile
      __syncthreads();  // the slot is consumed before it is staged again
    }
    if (split) cluster_arrive();  // this block's ring is free for the inbox
    if (t0 < t1) write_parts();
  } else {
    // f32 q on the CUDA cores. Q [16][Dh + 4] in shared memory
    constexpr int kDC = kMaxDh / 32;  // head dims per lane in P.V
    float* qs = reinterpret_cast<float*>(sm + lo.qs);
    float* pw = reinterpret_cast<float*>(sm + lo.pw) +
                warp * kRows * (kWarpKeys + 1);
    float* aw = reinterpret_cast<float*>(sm + lo.alpha) + warp * kRows;
    const int qstr = Dh + 4;
    for (int i = threadIdx.x; i < kRows * Dh / 4; i += kThreads) {
      const int r = i / (Dh / 4), c = 4 * (i - r * (Dh / 4));
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < live_rows)
        x = __ldg(reinterpret_cast<const float4*>(q + q_index(r) + c));
      *reinterpret_cast<float4*>(qs + r * qstr + c) = x;
    }
    const int kk = lane & 15, rh = lane >> 4;  // key kk, rows 8 rh .. + 7
    const int key = kWarpKeys * warp + kk;
    float m[8], l[8], acc[kRows][kDC];
    auto reset = [&]() {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        m[i] = kNegInf;
        l[i] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kDC; ++c) acc[r][c] = 0.f;
    };
    auto write_parts = [&]() {
      if (kk == 0)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          parts_m[warp * kRows + 8 * rh + i] = m[i];
          parts_l[warp * kRows + 8 * rh + i] = l[i];
        }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kDC; ++c) {
          const int d = lane + 32 * c;
          if (d < Dh) parts_acc[(warp * kRows + r) * Dh + d] = acc[r][c];
        }
    };
    reset();

    for (int tile = t0; tile < t1; ++tile) {
      const int st = (tile - t0) & 1;
      if (tile + 1 < t1)
        stage_tile<TKV, Keys>(a, b, h, tile + 1, st ^ 1, sm, lo, last_pos);
      cp_async_commit();
      const int next_page =
          Keys::kPaged && threadIdx.x < kTile ? load_page(tile + 2) : -1;
      if (tile > t0 && tile % span == 0) {  // a span is complete (local)
        write_parts();
        span_done(false);
        reset();
      }
      cp_async_wait_one();
      __syncthreads();
      const unsigned char* kt = sm + st * kTile * rs;
      const unsigned char* vt = sm + lo.ring_v + st * kTile * rs;
      const float* kst =
          reinterpret_cast<const float*>(sm + lo.scales) + st * 2 * kTile;

      float s[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = 0.f;
      const unsigned char* kr = kt + key * rs;
      for (int d = 0; d < Dh; d += 4) {
        float4 kv;
        if constexpr (kQuant) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(kr + d);
          kv = make_float4((float)(int8_t)(w & 0xFF),
                           (float)(int8_t)((w >> 8) & 0xFF),
                           (float)(int8_t)((w >> 16) & 0xFF),
                           (float)(int8_t)(w >> 24));
        } else {
          kv = *reinterpret_cast<const float4*>(kr + 4 * d);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qs + (8 * rh + i) * qstr + d);
          s[i] = fmaf(qv.x, kv.x, s[i]);
          s[i] = fmaf(qv.y, kv.y, s[i]);
          s[i] = fmaf(qv.z, kv.z, s[i]);
          s[i] = fmaf(qv.w, kv.w, s[i]);
        }
      }
      const int p_key = tile * kTile + key;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = 8 * rh + i;
        const bool live = p_key <= off + (row0 + r) / G && p_key < S;
        float x = s[i] * a.scale;
        if constexpr (kQuant) x *= kst[key];
        x = live ? x : kNegInf;
        float mx = x;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        const float p = live ? expf(x - m_new) : 0.f;
        float sum = p;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        l[i] = l[i] * alpha + sum;
        m[i] = m_new;
        if constexpr (kQuant)
          pw[r * (kWarpKeys + 1) + kk] = p * kst[kTile + key];
        else
          pw[r * (kWarpKeys + 1) + kk] = p;
        if (kk == 0) aw[r] = alpha;
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float al = aw[r];
#pragma unroll
        for (int c = 0; c < kDC; ++c) acc[r][c] *= al;
      }
      const unsigned char* vr = vt + kWarpKeys * warp * rs;
      for (int j = 0; j < kWarpKeys; ++j) {
        float v[kDC];
#pragma unroll
        for (int c = 0; c < kDC; ++c) {
          const int d = lane + 32 * c;
          v[c] = d < Dh ? to_float(reinterpret_cast<const TKV*>(
                              vr + j * rs)[d])
                        : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float p = pw[r * (kWarpKeys + 1) + j];
#pragma unroll
          for (int c = 0; c < kDC; ++c) acc[r][c] = fmaf(p, v[c], acc[r][c]);
        }
      }
      put_row(st, tile + 2, next_page);  // slot st's next tile
      __syncthreads();  // the slot (and pw) are consumed
    }
    if (split) cluster_arrive();  // this block's ring is free for the inbox
    if (t0 < t1) write_parts();
  }

  if (!split) {
    span_done(true);  // the last span; writes the rows
    return;
  }
  // split: push this block's span partial (if it has live tiles), then
  // combine the live span partials of rows rank, rank + C, ... in span
  // order, from the inbox, as a local block does
  if (t0 < t1)
    span_done(false);
  else
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  cluster.sync();  // every push has landed
  const int mine = live_rows > rank ? (live_rows - rank + C - 1) / C : 0;
  if (threadIdx.x < mine) {
    const int i = threadIdx.x;
    float* w = mg + i * kMergeFloats + kWarps + 2;  // [ca, cb] per span
    float m = kNegInf, l = 0.f;
    for (int v = 0; v < n_live; ++v) {
      const float mv = in_m[i * C + v];
      const float m_new = fmaxf(m, mv);
      const float ca = expf(m - m_new), cb = expf(mv - m_new);
      l = fmaf(in_l[i * C + v], cb, l * ca);
      m = m_new;
      w[2 * v] = ca;
      w[2 * v + 1] = cb;
    }
    mg[i * kMergeFloats] = fmaxf(l, 1e-38f);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < mine * Dh; e += kThreads) {
    const int i = e / Dh, d = e - i * Dh;
    const float* w = mg + i * kMergeFloats + kWarps + 2;
    float x = 0.f;
    for (int v = 0; v < n_live; ++v)
      x = fmaf(in_acc[(i * C + v) * Dh + d], w[2 * v + 1], x * w[2 * v]);
    store(out + q_index(rank + C * i) + d, x / mg[i * kMergeFloats]);
  }
}

// Launch flash_decode_kernel<TQ, TKV, kMaxDh, Keys> for B sequences on
// `stream`: grid (C, row tiles, B * Hk) in clusters of (C, 1, 1) (split) when
// that grid fits the card at 4 blocks an SM, else grid (1, row tiles, B * Hk)
// (local). Returns the launch's error, or cudaGetLastError() after it.
template <typename TQ, typename TKV, int kMaxDh, typename Keys>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  auto kern = flash_decode_kernel<TQ, TKV, kMaxDh, Keys>;
  const int smem = layout(a.Dh, std::is_same<TQ, float>::value,
                          (int)sizeof(TKV)).total;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int row_tiles = (a.T * (a.Hq / a.Hk) + kRows - 1) / kRows;
  const int C = clusters_of(a.S);
  const int cp =
      (long long)row_tiles * B * a.Hk * C <= 4LL * sms ? C : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cp, row_tiles, B * a.Hk);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cp;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename Keys, typename TQ, typename TKV>
cudaError_t launch_dh(const Args& a, int B, cudaStream_t stream) {
  if (a.Dh <= 64) return launch<TQ, TKV, 64, Keys>(a, B, stream);
  return launch<TQ, TKV, 128, Keys>(a, B, stream);
}

// The entry points' launch: q_dtype 0 = float32, 1 = bfloat16; kv_int8 0 =
// K/V of q's type, 1 = int8 with both scales. Dh <= 64 takes the 64
// instance, else the 128 one. cudaErrorInvalidValue for arguments the
// kernel does not take (Dh a multiple of 8, of 16 for int8, up to 128; a
// block's shared memory within an H100's), else launch's result.
template <typename Keys>
int run(const Args& a, int B, int q_dtype, int kv_int8, cudaStream_t stream) {
  const int vec = kv_int8 ? 16 : 8;
  const int kv_bytes = kv_int8 ? 1 : (q_dtype == 0 ? 4 : 2);
  if (B < 1 || a.T < 1 || a.Hk < 1 || a.Hq % a.Hk != 0 || a.Dh < vec ||
      a.Dh % vec != 0 || a.Dh > 128 || a.S < 1 || q_dtype < 0 ||
      q_dtype > 1 || (kv_int8 && (!a.ks || !a.vs)) ||
      layout(a.Dh, q_dtype == 0, kv_bytes).total > 232448)
    return (int)cudaErrorInvalidValue;
  if (q_dtype == 0)
    return (int)(kv_int8 ? launch_dh<Keys, float, int8_t>(a, B, stream)
                         : launch_dh<Keys, float, float>(a, B, stream));
  return (int)(kv_int8
                   ? launch_dh<Keys, __nv_bfloat16, int8_t>(a, B, stream)
                   : launch_dh<Keys, __nv_bfloat16, __nv_bfloat16>(
                         a, B, stream));
}

}  // namespace flash
