// Single-token decode attention over a contiguous KV cache: one query
// row per (batch row, head) against keys [0, cache_len) of a
// (B, S, Hkv, D) bf16 cache.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py,
//   decode_attention_kernel (pallas_call at :79).
//
// Bound on the H100: bytes.  The g = H / Hkv query heads of a KV head
// read its filled K and V once: 2 * B * cache_len * Hkv * D * 2 bytes,
// at 4 * g flops per 2 bytes of KV (g = 8 on yi-6b, 2 on granite), far
// below the ~295 flops per byte where the bf16 tensor cores would bound
// it.
//
// Design: the TPU grid (batch, KV head, kv block) walked the cache's
// blocks in order with the running max, normalizer and accumulator in
// VMEM, skipping blocks past the fill.  Here the keys are split across
// blocks as paged decode splits them (attention.cuh's split::, through
// the ContigKV addresser): the grid is (split, KV head, batch row), a
// split a run of whole KEY_BLOCK-key blocks, n_split picked by the caller
// from static shapes as for paged decode (the cache's width in key
// blocks, B * Hkv and the SM count); a second kernel merges each row's
// splits in split order.  A split that starts at or past cache_len
// writes an empty partial and reads nothing, so a decode step's cost
// follows the filled cache, not the allocated one.  A row's keys split
// at the same positions in a contiguous cache and in a page pool give
// the same bits through both kernels, so the contiguous path and the
// paged engine decode alike.  cache_len >= 1 (the wrapper checks).
#include "attention.cuh"

namespace repro {

constexpr int KEY_BLOCK = 16;   // a split is whole blocks of this many keys

}  // namespace repro

// ws: B * H * n_split * (D + 2) f32 of scratch; the cache's
// ceil(S / KEY_BLOCK) key blocks are cut into n_split splits of
// ceil(blocks / n_split) blocks.
extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     void* out, void* ws, int B, int S, int H, int Hkv,
                                     int D, int cache_len, int n_split, float scale,
                                     void* stream) {
  using namespace repro;
  if (B <= 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > attn::split::MAX_G || B > 65535 ||
      Hkv > 65535 || H > 65535 || cache_len < 1 || S < 1 || n_split <= 0)
    return (int)cudaErrorInvalidValue;
  const attn::split::ContigSource src{(const bf16*)k, (const bf16*)v, Hkv, D, S, cache_len};
  const int blocks = (S + KEY_BLOCK - 1) / KEY_BLOCK;
  const int split_keys = max(1, (blocks + n_split - 1) / n_split) * KEY_BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 160)
    return attn::split::launch<160>((const bf16*)q, src, (bf16*)out, (float*)ws, B, H,
                                    n_split, split_keys, scale, s);
  if (D == 128)
    return attn::split::launch<128>((const bf16*)q, src, (bf16*)out, (float*)ws, B, H,
                                    n_split, split_keys, scale, s);
  if (D == 64)
    return attn::split::launch<64>((const bf16*)q, src, (bf16*)out, (float*)ws, B, H,
                                   n_split, split_keys, scale, s);
  if (D == 32)
    return attn::split::launch<32>((const bf16*)q, src, (bf16*)out, (float*)ws, B, H,
                                   n_split, split_keys, scale, s);
  if (D == 16)
    return attn::split::launch<16>((const bf16*)q, src, (bf16*)out, (float*)ws, B, H,
                                   n_split, split_keys, scale, s);
  if (D == 8)
    return attn::split::launch<8>((const bf16*)q, src, (bf16*)out, (float*)ws, B, H,
                                  n_split, split_keys, scale, s);
  return (int)cudaErrorInvalidValue;
}
