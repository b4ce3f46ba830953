// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernels of specdec_tpu/ops/paged_attention.py:
//   _kernel                (:26, paged_decode_attention, an [NP, Hk, page,
//                           Dh] pool),
//   _kernel_quant          (:136, paged_decode_attention_quant, int8 pools
//                           with f32 scales [NP, Hk, page]),
//   _kernel_stacked        (:258, paged_decode_attention_stacked, layer
//                           `layer` of [L, NP, Hk, page, Dh] stacks),
//   _kernel_quant_stacked  (:377, paged_decode_attention_quant_stacked, layer
//                           `layer` of the int8 stacks and [L, NP, Hk, page]
//                           scales).
// All four are instantiations of the flash-decode kernel in
// csrc/flash_decode.cuh (which holds the design) over its Paged key layout:
// key position s of sequence b lives at slot s % page of pool page
// table[b, s / page]; the layer is a base-pointer offset (layer *
// layer_stride value elements, stride 0 for a 4D pool; a scale layer is a
// value layer over Dh). The capacity is the table's width, MP * page, which
// fixes the spans, so a row's result depends on the table's width only, not
// on T, the batch or its neighbours; over the same keys in pages of 64 with
// MP = ceil(S / 64) it equals the slotted kernel's bit for bit. A block reads
// the table entries of its rows' live positions only.
//
// What bounds it on an H100: bytes. A call must read the live pages of K and V
// (for each sequence, offsets[b] + T positions x Hk x Dh, twice; int8 pools a
// quarter of f32's bytes plus 4 bytes of scale per position, head and array)
// plus q, the table's live entries and offsets, and write out: under a
// microsecond at the serving verify, so a call costs its latency, which the
// flash-decode body attacks.

#include "flash_decode.cuh"

// C interface, loaded with ctypes. q/out: [B, T, Hq, Dh], q_dtype 0 = float32,
// 1 = bfloat16; k/v: the base of [L, NP, Hk, page, Dh] (or [NP, Hk, page, Dh])
// pools, of q's type (kv_int8 = 0, k_scale/v_scale unused) or int8 with f32
// scales [L, NP, Hk, page] (kv_int8 = 1); all contiguous and 16-byte aligned;
// table [B, MP] and offsets [B] int32. The layer read is `layer`, at
// `layer_stride` value elements per layer. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int paged_attention(const void* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               const void* table, const void* offsets,
                               void* out, int q_dtype, int kv_int8, int B,
                               int T, int Hq, int Hk, int Dh, int page,
                               int MP, long long layer,
                               long long layer_stride, float scale,
                               void* stream) {
  if (page < 1 || MP < 1 || (long long)MP * page > 0x7fffffffLL || Dh < 1 ||
      layer < 0 || layer_stride < 0)
    return (int)cudaErrorInvalidValue;
  const long long kv_bytes = kv_int8 ? 1 : (q_dtype == 0 ? 4 : 2);
  const long long off = layer * layer_stride * kv_bytes;  // bytes
  const long long scale_off = layer * (layer_stride / Dh);
  const flash::Args a{
      q, static_cast<const char*>(k) + off,
      static_cast<const char*>(v) + off,
      k_scale ? static_cast<const float*>(k_scale) + scale_off : nullptr,
      v_scale ? static_cast<const float*>(v_scale) + scale_off : nullptr,
      static_cast<const int32_t*>(offsets), out, T, Hq, Hk, Dh, MP * page,
      scale, static_cast<const int32_t*>(table), MP, page};
  return flash::run<flash::Paged>(a, B, q_dtype, kv_int8,
                                  static_cast<cudaStream_t>(stream));
}
