// Flash-decode attention over the slotted KV cache for Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernels of specdec_tpu/ops/decode_attention.py:
//   _kernel        (:38, flash_decode_attention: K/V [B, S, Hk, Dh] of q's
//                   type),
//   _kernel_quant  (:159, flash_decode_attention_quant: int8 K/V with f32
//                   scales [B, S, Hk]).
// Both are instantiations of the kernel in csrc/flash_decode.cuh over its
// Slotted key layout; the header holds the design: each sequence's keys
// split over the blocks of a thread-block cluster and merged through
// distributed shared memory, the rows of bf16 q on the tensor cores. The
// kernel reads one layer of the slotted cache IN PLACE: the base pointers
// are cache.k[i] and cache.v[i], the keys of a KV head are Hk * Dh elements
// apart, their scales Hk apart. Unlike the TPU wrapper there are no
// transposes, no padding of S to a tile multiple and no copies; tiles past a
// sequence's live length are never read.
//
// What bounds it on an H100: bytes. A call must read the live K and V (for
// each sequence, offsets[b] + T positions x Hk x Dh, twice; int8 a quarter of
// f32's bytes plus 4 bytes of scale per position, head and array) plus q and
// write out: well under a microsecond at the main path's shapes, so a call
// costs its latency; the cluster split puts C blocks on each (b, h, row tile)
// to shorten it.

#include "flash_decode.cuh"

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
  const flash::Args a{q, k, v,
                      static_cast<const float*>(k_scale),
                      static_cast<const float*>(v_scale),
                      static_cast<const int32_t*>(offsets), out, T, Hq, Hk,
                      Dh, S, scale, nullptr, 0, 0};
  return flash::run<flash::Slotted>(a, B, q_dtype, kv_int8,
                                    static_cast<cudaStream_t>(stream));
}
