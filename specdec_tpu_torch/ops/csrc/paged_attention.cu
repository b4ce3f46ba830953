// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernels of specdec_tpu/ops/paged_attention.py:
//   _kernel                (paged_decode_attention, an [NP, Hk, page, Dh]
//                           pool),
//   _kernel_stacked        (paged_decode_attention_stacked, layer `layer` of
//                           [L, NP, Hk, page, Dh] stacks),
//   _kernel_quant          (paged_decode_attention_quant, int8 pools with f32
//                           scales [NP, Hk, page]),
//   _kernel_quant_stacked  (paged_decode_attention_quant_stacked, layer
//                           `layer` of the int8 stacks and [L, NP, Hk, page]
//                           scales).
// One kernel body (csrc/attention_tile.cuh) serves all four: the layer is a
// base-pointer offset given by the layer index and the layer stride (0 for a
// 4D pool), and the int8 pools are its int8 instantiation, which takes the two
// scale pointers. Key position s of sequence b lives at slot s % page of pool
// page table[b, s / page]; a key tile is one page, the scales of a (page,
// head) are contiguous and are staged with the page. A block reads the live
// pages 0 .. min((offsets[b] + t_max) / page, MP - 1).
//
// What bounds it on an H100: bytes. A call must read the live pages of K and V
// (for each sequence, (last+1) pages x Hk x page x Dh, twice; int8 pools a
// quarter of f32's bytes plus 4 bytes of scale per position, head and array)
// plus q, the table and offsets, and write out; at T*G <= 72 rows per KV head
// the products stay far below the tensor-core line. This kernel reads each
// live page once per query-row tile (five times at the verify's T*G = 72),
// with 16-byte loads, and does the products on the CUDA cores from shared
// memory. It does no more about the bytes yet: no cp.async/TMA double
// buffering, no split over pages for long sequences at small batch, no tensor
// cores (later work).

#include "attention_tile.cuh"

namespace {

template <typename TKV>
struct PagedKeys {
  const TKV* k;
  const TKV* v;
  const float* ks;
  const float* vs;
  const int32_t* table;
  int MP, Hk, page, Dh;

  __device__ int last_tile(int b, int q_last) const {
    return min(q_last / page, MP - 1);
  }

  __device__ attn::Tile<TKV> at(int b, int h, int lp) const {
    const size_t head = (size_t)table[b * MP + lp] * Hk + h;
    const size_t base = head * page * Dh;
    const size_t sbase = head * page;
    return {k + base, v + base, ks ? ks + sbase : nullptr,
            vs ? vs + sbase : nullptr, Dh, 1, page};
  }
};

template <typename TQ, typename TKV, bool kQuant>
cudaError_t run(const void* q, const void* k, const void* v,
                const void* k_scale, const void* v_scale,
                const int32_t* table, const int32_t* offsets, void* out,
                int B, int nT, int Hq, int Hk, int Dh, int page, int MP,
                long long layer, long long layer_stride, float scale,
                cudaStream_t stream) {
  // values [.., NP, Hk, page, Dh] and scales [.., NP, Hk, page]: a scale
  // layer is a value layer over Dh
  const long long offset = layer * layer_stride;
  const long long scale_offset = layer * (layer_stride / Dh);
  PagedKeys<TKV> keys{static_cast<const TKV*>(k) + offset,
                      static_cast<const TKV*>(v) + offset,
                      kQuant ? static_cast<const float*>(k_scale) +
                                   scale_offset
                             : nullptr,
                      kQuant ? static_cast<const float*>(v_scale) +
                                   scale_offset
                             : nullptr,
                      table, MP, Hk, page, Dh};
  return attn::launch<TQ, TKV, kQuant>(q, keys, offsets, out, B, nT, Hq, Hk,
                                       Dh, page, scale, stream);
}

}  // namespace

// C interface, loaded with ctypes. q/out: [B, T, Hq, Dh], q_dtype 0 = float32,
// 1 = bfloat16; k/v: the base of [L, NP, Hk, page, Dh] (or [NP, Hk, page, Dh])
// pools, of q's type (kv_int8 = 0, k_scale/v_scale unused) or int8 with f32
// scales [L, NP, Hk, page] (kv_int8 = 1); all contiguous; table [B, MP] and
// offsets [B] int32. The layer read is `layer`, at `layer_stride` value
// elements per layer. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int paged_attention(const void* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               const void* table, const void* offsets,
                               void* out, int q_dtype, int kv_int8, int B,
                               int T, int Hq, int Hk, int Dh, int page,
                               int MP, long long layer,
                               long long layer_stride, float scale,
                               void* stream) {
  const int vec = kv_int8 ? 16 : (q_dtype == 0 ? 4 : 8);
  if (B < 1 || T < 1 || Hk < 1 || Hq % Hk != 0 || Dh < vec ||
      Dh % vec != 0 || Dh > 32 * attn::kMaxDimPerLane || page < 1 ||
      MP < 1 || (kv_int8 && (!k_scale || !v_scale)))
    return (int)cudaErrorInvalidValue;
  const int32_t* tbl = static_cast<const int32_t*>(table);
  const int32_t* off = static_cast<const int32_t*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_int8 == 0 && q_dtype == 0)
    return (int)run<float, float, false>(q, k, v, k_scale, v_scale, tbl, off,
                                         out, B, T, Hq, Hk, Dh, page, MP,
                                         layer, layer_stride, scale, s);
  if (kv_int8 == 0 && q_dtype == 1)
    return (int)run<__nv_bfloat16, __nv_bfloat16, false>(
        q, k, v, k_scale, v_scale, tbl, off, out, B, T, Hq, Hk, Dh, page, MP,
        layer, layer_stride, scale, s);
  if (kv_int8 == 1 && q_dtype == 0)
    return (int)run<float, int8_t, true>(q, k, v, k_scale, v_scale, tbl, off,
                                         out, B, T, Hq, Hk, Dh, page, MP,
                                         layer, layer_stride, scale, s);
  if (kv_int8 == 1 && q_dtype == 1)
    return (int)run<__nv_bfloat16, int8_t, true>(
        q, k, v, k_scale, v_scale, tbl, off, out, B, T, Hq, Hk, Dh, page, MP,
        layer, layer_stride, scale, s);
  return (int)cudaErrorInvalidValue;
}
