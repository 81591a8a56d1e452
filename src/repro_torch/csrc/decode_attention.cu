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
// VMEM, skipping blocks past the fill.  Here one block per (KV head,
// batch row) walks the keys in a loop (attention.cuh, through the
// ContigKV addresser), 32 positions per tile, with one row per query
// head of the group, so each K/V tile is loaded once for all g heads.
// The loop stops at cache_len: keys at or past it are never read, so a
// decode step's cost follows the filled cache, not the allocated one.
// cache_len >= 1 (the wrapper checks), so every row sees key 0.
#include "attention.cuh"

namespace repro {

template <int D>
__global__ void __launch_bounds__(attn::MAX_WARPS * 32)
decode_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out, int S,
                        int H, int Hkv, int cache_len, float scale) {
  using namespace attn;
  __shared__ Smem<D> sm;
  const int hk = blockIdx.x, b = blockIdx.y, g = H / Hkv;
  const int warp = threadIdx.x >> 5;
  const ContigKV kv{k + ((long long)b * S * Hkv + hk) * D,
                    v + ((long long)b * S * Hkv + hk) * D, (long long)Hkv * D};

  Rows<D> st;
  const bf16* qrow[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int gi = warp * RW + r;
    const bool active = gi < g;
    qrow[r] = active ? q + ((long long)b * H + hk * g + gi) * D : nullptr;
    st.limit[r] = active ? 0x7fffffff : -1;
  }
  load_q<D>(sm, qrow);
  attend<D>(sm, kv, min(cache_len, S), scale, st);
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int gi = warp * RW + r;
    if (gi < g) store_row<D>(st, r, out + ((long long)b * H + hk * g + gi) * D, nullptr);
  }
}

}  // namespace repro

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     void* out, int B, int S, int H, int Hkv, int D,
                                     int cache_len, float scale, void* stream) {
  using namespace repro;
  if (B <= 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > attn::ROWS || B > 65535 || cache_len < 1)
    return (int)cudaErrorInvalidValue;
  const int g = H / Hkv;
  const dim3 grid(Hkv, B);
  const dim3 block(32 * ((g + attn::RW - 1) / attn::RW));
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 128)
    decode_attention_kernel<128><<<grid, block, 0, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, S, H, Hkv,
        cache_len, scale);
  else if (D == 64)
    decode_attention_kernel<64><<<grid, block, 0, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, S, H, Hkv,
        cache_len, scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
