// MLA decode attention for Hopper (sm_90a): the absorbed form of latent
// attention (core/mla.py::absorbed, deepseek_v2) from the absorbed query on.
//
// Replaces no kernel of the JAX package, which has no latent attention. It
// was added because the absorbed form in plain PyTorch (float32 copies of
// the latent, float32 GEMMs on the SIMT cores, the page pool gathered first)
// took over half of the serving engine's device time on DeepSeek-V2-Lite at
// 4-10k-position contexts.
//
// Computes, for each sequence b and query row r = (t, h) of q [B, T, H, 576]
// (the absorbed query: 512 latent-wide values, then the 64 rope values),
//
//   out[b, t, h, :] = sum_s softmax_s(scale * q[b, t, h] . c_s) c_s[:512]
//
// over the positions s <= offsets[b] + t of one layer's latent stream c
// (576 bf16 values a position: the normed latent, then the rotated rope key
// every head shares), in float32: scores, running max and sum and the
// accumulator in f32, out written in f32 (the caller's w_uv takes it to each
// head's V width). `scale` is the model's softmax scale (YaRN's mscale
// included). The stream is read where it is stored: Slotted, one layer of
// the slotted cache, position s of sequence b at b * slot_stride + s * 576
// elements; Paged, one layer of the page pool [NP, page, 576] (one head)
// through table [B, MP], position s at page table[b, s / page], slot
// s % page. A paged sequence whose table starts at page 0 (the scheduler's
// garbage page: a dead slot) reads nothing and gets zeros.
//
// What bounds it on an H100: bytes. The live latent of each sequence, 1,152
// bytes a position, read once: at DeepSeek-V2-Lite's serving shapes (64
// sequences at 4,096-9,728 positions, ~412k live positions) ~475 MB a layer,
// ~142 us at 3.35 TB/s. A verify row block is 5 positions x 16 heads = 80
// rows over each position: 2 * 80 * (576 + 512) = 174k operations a
// position, ~151 a byte, under the card's bf16 line of ~295 but above what
// f32 SIMT feeds (the plain version's ~3.5% of the bound).
//
// Design:
//   - Rows. A block holds all rows of a sequence: MT m-tiles of 16 query
//     rows (row r = t * H + h of the sequence, in q's own layout; with 16
//     heads m-tile t is query position t), MT = ceil(T * H / 16) up to 5
//     (80 rows, a verify at gamma 4; instances of 1, 2, 3 and 5 m-tiles,
//     4 taking the 5's: a 4-tile one spilled). Rows past 80 are cut into
//     row groups of at most 80, each a work item of its own that reads the
//     stream again. So each latent byte is read once a layer and sequence:
//     a tile of 32 positions staged in shared memory serves the 576-wide
//     scores and, through its first 512 columns, the weighted sum (K and V
//     are one stream, read as one).
//   - Splits. A persistent grid of one block an SM walks the work as one
//     flat list of 32-position tiles, the items' (sequence, row group) live
//     tiles in order, block i taking tiles [i W / G, (i + 1) W / G) of W.
//     Each block finds its items from the offsets (a warp-wide scan), so the
//     host never reads a length and every SM gets the same number of live
//     tiles whatever the lengths (4,096-9,728 here). An item inside one
//     block's range is written there; an item cut by range boundaries
//     leaves unnormalized partials (acc, m, l) in a workspace, two slots a
//     block (the item its range starts in, the item it ends in), which a
//     second launch combines in block order: at most G + items partials,
//     against one a chunk for fixed-size chunks (whose partials at 80 rows
//     would weigh 160 KB each).
//   - Tensor cores: mma.sync m16n8k16 bf16 with f32 accumulation, operands
//     from shared memory by ldmatrix. Not wgmma: its tiles are 64 rows, and
//     a slot holds 16 (T = 1), 32 or 80 rows, so wgmma would compute 1.6-4x
//     the rows, and the verify is near the bf16 line already; mma.sync
//     tiles of 16 rows fit every T exactly, and the flash-decode body's
//     fragment helpers serve as they are. 16 warps. Scores S[R x 32] =
//     Q . C^T: warp w takes keys 16 (w % 2) .. + 15 over a quarter of the
//     576 columns ((w / 2) % 4) for half the m-tiles (w / 8), two at a
//     time, so each q fragment read from shared memory feeds two mmas; the
//     quarters' sums meet in shared memory. Softmax: 8 threads a row, 4 keys each, online
//     in f32; P is rounded to bf16 for P.V (l sums the f32 probabilities,
//     as the flash-decode body does). P.V: warp w owns output columns
//     32 w .. + 31 for every row, in registers (4 n-tiles x MT m-tiles x 4
//     f32: 80 at 80 rows, under the 128 a thread that 512 threads leave).
//   - Staging: q rows (576 bf16 + 16 bytes of padding, so that ldmatrix's
//     8 rows land on distinct banks) once an item; the latent in a ring of
//     tiles of 32 positions copied with cp.async, each thread's page-table
//     entry read a tile ahead of its copy. The ring holds 3 tiles (two in
//     flight while one is computed) up to 32 rows, 2 from 48 rows, whose q
//     leaves no room for a third and whose tiles take longer to compute
//     than a copy takes to land; 222 KB of shared memory at 80 rows, hence
//     32-position tiles: 64 would not fit beside q. Positions past a
//     sequence's live end read as zeros (src-size 0) and are masked; their
//     pages are never looked up.
//   - Causality per row: position s is live for row (t, h) iff s <=
//     offsets[b] + t (and s < the capacity), so rollback stays length
//     arithmetic. A masked probability is exactly 0; a row with no live
//     position in a block's part keeps (m, l) = (-1e30, 0), which the
//     combine weighs by exp(-1e30 - m) = 0.
// Alternatives, timed on the H100 at the verify (64 slots, T = 5, 4,096-
// 9,728 positions; PERF.md, `chip_smoke.py --against
// mla_decode_attention=SRC`): 8 warps owning 64 output columns each (160
// accumulator registers at 80 rows) over score halves of 288 columns, 861
// us; 16 warps over halves, 600 us; quarters with all three m-tiles a pass
// (spills 84 bytes), 568 us; one m-tile a pass, 581 us; this design, 533
// us. A 4-tile ring at 16 rows was no faster than 3. Not done yet: a
// pipeline across items (each item refills the ring), wgmma for the
// 80-row verify, score warps that keep q in registers.

#include "flash_decode.cuh"

namespace mla {

using flash::cp_async;
using flash::cp_async_commit;
using flash::ldmatrix_x4_trans;
using flash::mma_bf16;
using flash::pack_bf16;
using flash::smem_addr;

constexpr int kRank = 512;                 // the latent: V's columns
constexpr int kDim = 576;                  // latent + the shared rope key
constexpr int kKeys = 32;                  // positions a tile
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxMT = 5;                  // m-tiles of 16 rows a block
constexpr int kRowBytes = kDim * 2 + 16;   // a staged q or latent row
constexpr int kChunks = kDim * 2 / 16;     // 16-byte chunks of a row: 72
constexpr int kRowThreads = kThreads / kKeys;  // threads staging a row: 16
constexpr int kSStride = kKeys + 4;        // f32 scores a row
constexpr int kPStride = kKeys + 8;        // bf16 probabilities a row
constexpr int kParts = 4;                  // score warps over the columns
constexpr int kPart = kDim / kParts;       // score columns a warp: 144
constexpr int kCols = kRank / kWarps;      // output columns a warp: 32
constexpr float kNegInf = -1e30f;

// tiles in the ring: 3 (two in flight while one is computed) up to 32 rows;
// 2 from 48 rows, whose q leaves no room for a third and whose tiles take
// longer to compute than a copy takes to land
__host__ __device__ constexpr int stages(int mt) { return mt <= 2 ? 3 : 2; }

struct Args {
  const __nv_bfloat16* q;  // [B, T, H, kDim]
  const __nv_bfloat16* lat;
  const int32_t* offsets;  // [B]
  const int32_t* table;    // paged: [B, MP]; slotted: null
  float* out;              // [B, T, H, kRank]
  float* ws_acc;           // [G][2][rows][kRank]
  float* ws_ml;            // [G][2][rows][2]
  long long slot_stride;   // slotted: elements from one sequence to the next
  int B, T, H, S;          // S: the capacity (slotted S, paged MP * page)
  int MP, page;
  int groups, rows;        // row groups an item's sequence, rows a group
  int G;                   // the split kernel's blocks
  float scale;
};

// Dynamic shared memory of a block holding MT m-tiles: q, the ring, the
// scores of the column parts, the probabilities, then m, l and alpha a row
__host__ __device__ constexpr int smem_bytes(int mt) {
  return 16 * mt * kRowBytes + stages(mt) * kKeys * kRowBytes +
         kParts * 16 * mt * kSStride * 4 + 16 * mt * kPStride * 2 +
         3 * 16 * mt * 4;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// live 32-position tiles of item k (sequence k / groups): none for a paged
// sequence on the garbage page
__device__ __forceinline__ int item_tiles(const Args& a, int k) {
  const int b = k / a.groups;
  if (a.table && __ldg(a.table + (long long)b * a.MP) == 0) return 0;
  const int live = min(__ldg(a.offsets + b) + a.T, a.S);
  return live > 0 ? (live + kKeys - 1) / kKeys : 0;
}

// W, the live tiles of every item, summed by the block (every thread gets
// it); `before` the tiles of the items before item `k` (-1: none wanted)
__device__ __forceinline__ void block_tiles(const Args& a, int k, int* tot,
                                            int* before) {
  __shared__ int s_tot, s_before;
  if (threadIdx.x == 0) s_tot = s_before = 0;
  __syncthreads();
  int x = 0, y = 0;
  for (int j = threadIdx.x; j < a.B * a.groups; j += blockDim.x) {
    const int n = item_tiles(a, j);
    x += n;
    y += j < k ? n : 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, o);
    y += __shfl_xor_sync(0xffffffffu, y, o);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&s_tot, x);
    atomicAdd(&s_before, y);
  }
  __syncthreads();
  *tot = s_tot;
  *before = s_before;
}

// the first tile of block i's range of W tiles over G blocks
__device__ __forceinline__ int range_start(int i, int W, int G) {
  return (int)((long long)i * W / G);
}

// the block whose range holds tile x (< W)
__device__ __forceinline__ int block_of(int x, int W, int G) {
  return (int)((((long long)x + 1) * G + W - 1) / W) - 1;
}

// Warp 0: the item whose tiles hold flat tile `cur` (< W), and the flat
// index of its first tile, into s[0], s[1]
__device__ __forceinline__ void find_item(const Args& a, int cur, int* s) {
  const int lane = threadIdx.x & 31, n = a.B * a.groups;
  int base = 0;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int k = c0 + lane;
    const int tl = k < n ? item_tiles(a, k) : 0;
    int x = tl;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    const int incl = base + x, excl = incl - tl;
    const unsigned hit =
        __ballot_sync(0xffffffffu, tl > 0 && excl <= cur && cur < incl);
    if (hit) {
      const int src = __ffs(hit) - 1;
      const int kk = __shfl_sync(0xffffffffu, k, src);
      const int pk = __shfl_sync(0xffffffffu, excl, src);
      if (lane == 0) {
        s[0] = kk;
        s[1] = pk;
      }
      return;
    }
    base += __shfl_sync(0xffffffffu, x, 31);
  }
}

// The pool page of this thread's staging row (threadIdx.x / 16) in tile
// `tile` of sequence b: read a tile ahead of its copy, so that the table's
// latency is not waited for (0 where unused: slotted, or past `live`)
__device__ __forceinline__ int row_page(const Args& a, int b, int tile,
                                        int live) {
  const int pos = tile * kKeys + threadIdx.x / kRowThreads;
  return a.table && pos < live
             ? __ldg(a.table + (long long)b * a.MP + pos / a.page)
             : 0;
}

// Copy tile `tile` (positions 32 tile .. + 31) of sequence b into ring slot
// `dst`: 16 threads a row, thread j copying chunks j % 16, + 16, ... of row
// j / 16 (of page `pg` where paged). Positions at or past `live` read as
// zeros.
__device__ __forceinline__ void stage_tile(const Args& a, int b, int tile,
                                           int live, int pg,
                                           unsigned char* dst) {
  const int r = threadIdx.x / kRowThreads, c0 = threadIdx.x % kRowThreads;
  const int pos = tile * kKeys + r;
  const __nv_bfloat16* src = a.lat;
  const bool ok = pos < live;
  if (ok)
    src += a.table ? ((long long)pg * a.page + pos % a.page) * kDim
                   : b * a.slot_stride + (long long)pos * kDim;
  unsigned char* d = dst + r * kRowBytes;
#pragma unroll
  for (int c = c0; c < kChunks; c += kRowThreads)
    cp_async<16>(d + 16 * c, src + (ok ? 8 * c : 0), ok ? 16 : 0);
}

// The split kernel (see the note above). MT: m-tiles a block holds.
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
    mla_decode_kernel(const Args a) {
  constexpr int R = 16 * MT;
  constexpr int kStages = stages(MT);
  constexpr int MH = (MT + 1) / 2;  // m-tiles of a score warp
  constexpr int kPass = 2;          // of them a pass (registers)
  extern __shared__ __align__(16) unsigned char sm[];
  unsigned char* qs = sm;
  unsigned char* ring = qs + R * kRowBytes;
  float* sbuf = reinterpret_cast<float*>(ring + kStages * kKeys * kRowBytes);
  __nv_bfloat16* pbuf =
      reinterpret_cast<__nv_bfloat16*>(sbuf + kParts * R * kSStride);
  float* mrow = reinterpret_cast<float*>(pbuf + R * kPStride);
  float* lrow = mrow + R;
  float* arow = lrow + R;
  __shared__ int seg[2];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i = blockIdx.x;
  int W, unused;
  block_tiles(a, -1, &W, &unused);
  const int s_i = range_start(i, W, a.G), e_i = range_start(i + 1, W, a.G);

  // the lanes' ldmatrix rows: A operands (q, P) row (lane & 7) + 8 ((lane
  // >> 3) & 1) at column 8 (lane >> 4); score B operands (latent rows as
  // [key][d]) key (lane & 7) + 8 (lane >> 4) at column 8 ((lane >> 3) & 1);
  // P.V B operands (.trans) key (lane & 7) + 8 ((lane >> 3) & 1) at column
  // 8 (lane >> 4)
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  // scores: keys 16 jp .. + 15, columns 144 qd .. + 143, m-tiles MH mg ..
  const int jp = warp & 1, qd = (warp >> 1) & 3, mg = warp >> 3;
  const int c_out = kCols * warp;  // P.V: output columns c_out .. + 31

  for (int cur = s_i; cur < e_i;) {
    if (warp == 0) find_item(a, cur, seg);
    __syncthreads();
    const int k = seg[0], pk = seg[1];
    const int nt = item_tiles(a, k);
    const int tb = cur - pk, te = min(pk + nt, e_i) - pk;
    const bool complete = tb == 0 && te == nt;
    const int which = cur == s_i ? 0 : 1;
    const int b = k / a.groups, row0 = (k - b * a.groups) * a.rows;
    const int off = __ldg(a.offsets + b);
    const int live = min(off + a.T, a.S);
    const int rows_valid = min(R, a.T * a.H - row0);

    if (threadIdx.x < R) {
      mrow[threadIdx.x] = kNegInf;
      lrow[threadIdx.x] = 0.f;
    }
    // q rows (zeros past the item's valid rows), in the first tile's group
    for (int e = threadIdx.x; e < R * kChunks; e += kThreads) {
      const int r = e / kChunks, c = e - r * kChunks;
      const bool ok = r < rows_valid;
      const __nv_bfloat16* src =
          a.q + (ok ? ((long long)b * a.T * a.H + row0 + r) * kDim + 8 * c
                    : 0);
      cp_async<16>(qs + r * kRowBytes + 16 * c, src, ok ? 16 : 0);
    }
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (tb + st < te)
        stage_tile(a, b, tb + st, live, row_page(a, b, tb + st, live),
                   ring + st * kKeys * kRowBytes);
      cp_async_commit();
    }
    int pg_next = row_page(a, b, tb + kStages - 1, live);

    float oacc[MT][kCols / 8][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[mi][n][e] = 0.f;

    for (int tile = tb; tile < te; ++tile) {
      const int idx = tile - tb;
      cp_async_wait<kStages - 2>();
      __syncthreads();  // tile idx is in; slot idx - 1 and P are consumed
      if (tile + kStages - 1 < te)
        stage_tile(a, b, tile + kStages - 1, live, pg_next,
                   ring + ((idx + kStages - 1) % kStages) * kKeys * kRowBytes);
      cp_async_commit();
      pg_next = row_page(a, b, tile + kStages, live);
      const unsigned char* lt = ring + (idx % kStages) * kKeys * kRowBytes;

      // scores of keys 16 jp .. + 15 over columns 144 qd .. + 143 for
      // m-tiles MH mg .. (those below MT; none for mg = 1 at MT = 1), at
      // most two m-tiles a pass (a third's accumulators would spill at 80
      // rows), into this part's buffer
      if (MH * mg < MT) {
        const unsigned char* kb =
            lt + (16 * jp + (lane & 7) + 8 * (lane >> 4)) * kRowBytes +
            2 * (kPart * qd + 8 * ((lane >> 3) & 1));
        const unsigned char* qb = qs + (16 * MH * mg + a_row) * kRowBytes +
                                  2 * (kPart * qd + a_col);
        float* sp = sbuf + qd * R * kSStride;
#pragma unroll
        for (int j0 = 0; j0 < MH; j0 += kPass) {
          if (MH * mg + j0 >= MT) break;
          float sacc[kPass][2][4];
#pragma unroll
          for (int j = 0; j < kPass; ++j)
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) sacc[j][n][e] = 0.f;
#pragma unroll
          for (int ks = 0; ks < kPart / 16; ++ks) {
            uint32_t bk[4];  // b0, b1 of key n-tiles 2 jp and 2 jp + 1
            ldmatrix_x4(bk, kb + 32 * ks);
#pragma unroll
            for (int j = 0; j < kPass; ++j) {
              if (j0 + j >= MH || MH * mg + j0 + j >= MT) break;
              uint32_t aq[4];
              ldmatrix_x4(aq, qb + (j0 + j) * 16 * kRowBytes + 32 * ks);
              mma_bf16(sacc[j][0], aq, bk[0], bk[1]);
              mma_bf16(sacc[j][1], aq, bk[2], bk[3]);
            }
          }
#pragma unroll
          for (int j = 0; j < kPass; ++j) {
            if (j0 + j >= MH || MH * mg + j0 + j >= MT) break;
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int hr = 0; hr < 2; ++hr)
                *reinterpret_cast<float2*>(
                    sp + (16 * (MH * mg + j0 + j) + g + 8 * hr) * kSStride +
                    16 * jp + 8 * n + 2 * t) =
                    make_float2(sacc[j][n][2 * hr], sacc[j][n][2 * hr + 1]);
          }
        }
      }
      __syncthreads();

      // online softmax over the parts' sum: 8 threads a row, keys 4 kq ..
      // + 3
      {
        const int kq = threadIdx.x & 7;
        for (int r = threadIdx.x >> 3; r < R; r += kThreads / 8) {
          const int qpos = off + (row0 + r) / a.H;
          float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int pd = 0; pd < kParts; ++pd) {
            const float4 v = *reinterpret_cast<const float4*>(
                sbuf + (pd * R + r) * kSStride + 4 * kq);
            s[0] += v.x;
            s[1] += v.y;
            s[2] += v.z;
            s[3] += v.w;
          }
          bool ok[4];
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int pos = tile * kKeys + 4 * kq + j;
            ok[j] = pos <= qpos && pos < live;
            s[j] = ok[j] ? s[j] * a.scale : kNegInf;
            mx = fmaxf(mx, s[j]);
          }
#pragma unroll
          for (int o = 1; o < 8; o <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_old = mrow[r];
          const float m_new = fmaxf(m_old, mx);
          const float alpha = expf(m_old - m_new);
          float p[4], sum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            p[j] = ok[j] ? expf(s[j] - m_new) : 0.f;
            sum += p[j];
          }
#pragma unroll
          for (int o = 1; o < 8; o <<= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, o);
          *reinterpret_cast<uint2*>(pbuf + r * kPStride + 4 * kq) =
              make_uint2(pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]));
          if (kq == 0) {
            mrow[r] = m_new;
            lrow[r] = fmaf(lrow[r], alpha, sum);
            arow[r] = alpha;
          }
        }
      }
      __syncthreads();

      // P.V into output columns c_out .. + 31
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const float a0 = arow[16 * mi + g], a1 = arow[16 * mi + g + 8];
#pragma unroll
        for (int n = 0; n < kCols / 8; ++n) {
          oacc[mi][n][0] *= a0;
          oacc[mi][n][1] *= a0;
          oacc[mi][n][2] *= a1;
          oacc[mi][n][3] *= a1;
        }
      }
#pragma unroll
      for (int ks = 0; ks < kKeys / 16; ++ks) {
        uint32_t vb[kCols / 8][2];
#pragma unroll
        for (int np = 0; np < kCols / 16; ++np)
          ldmatrix_x4_trans(vb[2 * np][0], vb[2 * np][1], vb[2 * np + 1][0],
                            vb[2 * np + 1][1],
                            lt + (16 * ks + a_row) * kRowBytes +
                                2 * (c_out + 16 * np + a_col));
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          uint32_t ap[4];
          ldmatrix_x4(ap, pbuf + (16 * mi + a_row) * kPStride + 16 * ks +
                              a_col);
#pragma unroll
          for (int n = 0; n < kCols / 8; ++n)
            mma_bf16(oacc[mi][n], ap, vb[n][0], vb[n][1]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the last tile's m and l

    // the item's rows: final (normalized) or its partial for the combine
    const long long part = (long long)(2 * i + which) * R;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * mi + g + 8 * hr;
        if (r >= rows_valid) continue;
        const float inv = complete ? 1.f / fmaxf(lrow[r], 1e-38f) : 1.f;
        float* dst =
            complete
                ? a.out + ((long long)b * a.T * a.H + row0 + r) * kRank
                : a.ws_acc + (part + r) * kRank;
#pragma unroll
        for (int n = 0; n < kCols / 8; ++n)
          *reinterpret_cast<float2*>(dst + c_out + 8 * n + 2 * t) =
              make_float2(oacc[mi][n][2 * hr] * inv,
                          oacc[mi][n][2 * hr + 1] * inv);
      }
    if (!complete && threadIdx.x < rows_valid) {
      a.ws_ml[2 * (part + threadIdx.x)] = mrow[threadIdx.x];
      a.ws_ml[2 * (part + threadIdx.x) + 1] = lrow[threadIdx.x];
    }
    cur = pk + te;
    __syncthreads();  // m, l and seg are read before the next item's
  }
}

// The combine: block k writes item k where the split kernel left partials
// (nc of them, in block order: each row's weights exp(m - M) / L over its
// largest M and the weighted l's sum L, once into shared memory), and
// zeros for an item with no live tile; an item inside one block's range was
// written by it. Dynamic shared memory: G partial slots, then the weights
// [rows][nc].
__global__ void __launch_bounds__(kThreads)
    mla_combine_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char cm[];
  int* part = reinterpret_cast<int*>(cm);
  float* wt = reinterpret_cast<float*>(part + a.G);
  __shared__ int s_nc;
  const int k = blockIdx.x;
  int W, pk;
  block_tiles(a, k, &W, &pk);
  const int nt = item_tiles(a, k);
  const int b = k / a.groups, row0 = (k - b * a.groups) * a.rows;
  const int rows_valid = min(a.rows, a.T * a.H - row0);
  float* out = a.out + ((long long)b * a.T * a.H + row0) * kRank;
  if (nt == 0) {
    for (int e = threadIdx.x; e < rows_valid * kRank; e += kThreads)
      out[e] = 0.f;
    return;
  }
  const int i0 = block_of(pk, W, a.G), i1 = block_of(pk + nt - 1, W, a.G);
  if (i0 == i1) return;
  if (threadIdx.x == 0) {  // the partial slots 2 i + which, empty blocks out
    int nc = 0;
    for (int i = i0, s = range_start(i0, W, a.G); i <= i1; ++i) {
      const int e = range_start(i + 1, W, a.G);
      if (s < e) part[nc++] = 2 * i + (i == i0 && pk != s ? 1 : 0);
      s = e;
    }
    s_nc = nc;
  }
  __syncthreads();
  const int nc = s_nc;
  for (int r = threadIdx.x; r < rows_valid; r += kThreads) {
    float m = kNegInf, l = 0.f;
    for (int c = 0; c < nc; ++c)
      m = fmaxf(m, a.ws_ml[2 * ((long long)part[c] * a.rows + r)]);
    for (int c = 0; c < nc; ++c) {
      const float* ml = a.ws_ml + 2 * ((long long)part[c] * a.rows + r);
      const float w = expf(ml[0] - m);
      wt[r * nc + c] = w;
      l = fmaf(ml[1], w, l);
    }
    const float inv = 1.f / fmaxf(l, 1e-38f);
    for (int c = 0; c < nc; ++c) wt[r * nc + c] *= inv;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows_valid * kRank; e += kThreads) {
    const int r = e / kRank, c0 = e - r * kRank;
    float x = 0.f;
    for (int c = 0; c < nc; ++c)
      x = fmaf(a.ws_acc[((long long)part[c] * a.rows + r) * kRank + c0],
               wt[r * nc + c], x);
    out[e] = x;
  }
}

template <int MT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kern = mla_decode_kernel<MT>;
  constexpr int smem = smem_bytes(MT);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<a.G, kThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int csmem = a.G * (1 + a.rows) * 4;
  if ((err = cudaFuncSetAttribute(mla_combine_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  csmem)) != cudaSuccess)
    return err;
  mla_combine_kernel<<<a.B * a.groups, kThreads, csmem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace mla

// C interface, loaded with ctypes. q [B, T, H, 576] bf16; lat: slotted, the
// base of one layer with sequence b at b * slot_stride elements (table
// null), or paged, one layer of the pool [NP, page, 576] with table [B, MP]
// int32; offsets [B] int32; out [B, T, H, 512] f32; ws_acc [grid][2][16 mt]
// [512] and ws_ml [grid][2][16 mt][2] f32 scratch; S the capacity (slotted:
// positions a sequence; paged: MP * page); rows of a sequence cut into
// `groups` groups of 16 mt rows (mt 1..5); `grid` blocks of the split
// kernel. Every array 16-byte aligned. Returns cudaGetLastError() after
// the launches (0 on success), cudaErrorInvalidValue for arguments it does
// not take.
extern "C" int mla_decode_attention(const void* q, const void* lat,
                                    const void* offsets, const void* table,
                                    void* out, void* ws_acc, void* ws_ml,
                                    int B, int T, int H, int S,
                                    long long slot_stride, int MP, int page,
                                    int groups, int mt, int grid, float scale,
                                    void* stream) {
  if (B < 1 || T < 1 || H < 1 || S < 1 || groups < 1 || mt < 1 ||
      mt > mla::kMaxMT || grid < 1 ||
      (long long)groups * 16 * mt < (long long)T * H ||
      (table && (MP < 1 || page < 1 || (long long)MP * page != S)))
    return (int)cudaErrorInvalidValue;
  const mla::Args a{static_cast<const __nv_bfloat16*>(q),
                    static_cast<const __nv_bfloat16*>(lat),
                    static_cast<const int32_t*>(offsets),
                    static_cast<const int32_t*>(table),
                    static_cast<float*>(out),
                    static_cast<float*>(ws_acc),
                    static_cast<float*>(ws_ml),
                    slot_stride, B, T, H, S, MP, page, groups, 16 * mt, grid,
                    scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mt) {
    case 1: return (int)mla::launch<1>(a, st);
    case 2: return (int)mla::launch<2>(a, st);
    case 3: return (int)mla::launch<3>(a, st);
    case 5: return (int)mla::launch<5>(a, st);
    default: return (int)cudaErrorInvalidValue;  // 4: the 5 instance's
  }
}
