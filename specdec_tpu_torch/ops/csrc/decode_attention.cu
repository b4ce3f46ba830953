// Flash-decode attention over the slotted KV cache for Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernels of specdec_tpu/ops/decode_attention.py:
//   _kernel        (flash_decode_attention: K/V [B, S, Hk, Dh] of q's type),
//   _kernel_quant  (flash_decode_attention_quant: int8 K/V with f32 scales
//                   [B, S, Hk]).
// Both are instantiations of the kernel body in csrc/attention_tile.cuh (the
// int8 one takes the two scale pointers). The kernel reads one layer of the
// slotted cache IN PLACE: the base pointers are cache.k[i] and cache.v[i], and
// the keys of a KV head are Hk * Dh elements apart, their scales Hk apart.
// Unlike the TPU wrapper there are no transposes, no padding of S to a tile
// multiple and no copies. A key tile is kTile consecutive positions; a block
// reads tiles 0 .. min(offsets[b] + t_max, S - 1) / kTile, so tiles past the
// live length are never read, as on the TPU, and the last tile's positions at
// or past S are masked.
//
// What bounds it on an H100: bytes. A call must read the live K and V (for
// each sequence, offsets[b] + T positions x Hk x Dh, twice; int8 a quarter of
// f32's bytes plus 4 bytes of scale per position, head and array) plus q and
// write out. Single-sequence decoding gives a grid of only B * Hk blocks (4 on
// 132 SMs), each streaming its head's keys alone, so a call is latency-bound
// long before it is bandwidth-bound; splitting S over blocks, cp.async/TMA
// staging and tensor cores for the verify's rows are later work.

#include "attention_tile.cuh"

namespace {

// keys per staged tile, equal to the serving page, so an int8 key tile here
// and a page of the paged kernel run the same operations in the same order
constexpr int kTile = 64;

template <typename TKV>
struct SlottedKeys {
  const TKV* k;
  const TKV* v;
  const float* ks;
  const float* vs;
  int S, Hk, Dh;

  __device__ int last_tile(int b, int q_last) const {
    return min(q_last, S - 1) / kTile;
  }

  __device__ attn::Tile<TKV> at(int b, int h, int lp) const {
    const int s0 = lp * kTile;
    const size_t head = ((size_t)b * S + s0) * Hk + h;
    const size_t base = head * Dh;
    return {k + base, v + base, ks ? ks + head : nullptr,
            vs ? vs + head : nullptr, (long long)Hk * Dh, Hk,
            min(kTile, S - s0)};
  }
};

template <typename TQ, typename TKV, bool kQuant>
cudaError_t run(const void* q, const void* k, const void* v,
                const void* k_scale, const void* v_scale,
                const int32_t* offsets, void* out, int B, int nT, int Hq,
                int Hk, int Dh, int S, float scale, cudaStream_t stream) {
  SlottedKeys<TKV> keys{static_cast<const TKV*>(k),
                        static_cast<const TKV*>(v),
                        kQuant ? static_cast<const float*>(k_scale) : nullptr,
                        kQuant ? static_cast<const float*>(v_scale) : nullptr,
                        S, Hk, Dh};
  return attn::launch<TQ, TKV, kQuant>(q, keys, offsets, out, B, nT, Hq, Hk,
                                       Dh, kTile, scale, stream);
}

}  // namespace

// C interface, loaded with ctypes. q/out: [B, T, Hq, Dh], q_dtype 0 = float32,
// 1 = bfloat16; k/v: one layer [B, S, Hk, Dh] of the slotted cache, of q's
// type (kv_int8 = 0, k_scale/v_scale unused) or int8 with f32 scales
// [B, S, Hk] (kv_int8 = 1); all contiguous and 16-byte aligned; offsets [B]
// int32 (query t of sequence b sits at position offsets[b] + t). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* offsets, void* out, int q_dtype,
                                int kv_int8, int B, int T, int Hq, int Hk,
                                int Dh, int S, float scale, void* stream) {
  const int vec = kv_int8 ? 16 : (q_dtype == 0 ? 4 : 8);
  if (B < 1 || T < 1 || Hk < 1 || Hq % Hk != 0 || Dh < vec ||
      Dh % vec != 0 || Dh > 32 * attn::kMaxDimPerLane || S < 1 ||
      (kv_int8 && (!k_scale || !v_scale)))
    return (int)cudaErrorInvalidValue;
  const int32_t* off = static_cast<const int32_t*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_int8 == 0 && q_dtype == 0)
    return (int)run<float, float, false>(q, k, v, k_scale, v_scale, off, out,
                                         B, T, Hq, Hk, Dh, S, scale, s);
  if (kv_int8 == 0 && q_dtype == 1)
    return (int)run<__nv_bfloat16, __nv_bfloat16, false>(
        q, k, v, k_scale, v_scale, off, out, B, T, Hq, Hk, Dh, S, scale, s);
  if (kv_int8 == 1 && q_dtype == 0)
    return (int)run<float, int8_t, true>(q, k, v, k_scale, v_scale, off, out,
                                         B, T, Hq, Hk, Dh, S, scale, s);
  if (kv_int8 == 1 && q_dtype == 1)
    return (int)run<__nv_bfloat16, int8_t, true>(
        q, k, v, k_scale, v_scale, off, out, B, T, Hq, Hk, Dh, S, scale, s);
  return (int)cudaErrorInvalidValue;
}
