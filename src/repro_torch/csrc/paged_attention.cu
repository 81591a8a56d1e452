// Attention over a block-paged KV pool: single-token decode for every
// slot, and a chunk of prompt rows for one admitting slot.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py,
//   paged_decode_attention_kernel (pallas_call at :176) and
//   paged_prefill_attention_kernel (pallas_call at :276).
//
// Bound on the H100:
//   decode  - bytes.  Each slot's g = H / Hkv query heads read the slot's
//             filled K and V once: 2 * sum(lengths) * Hkv * D * 2 bytes,
//             at 4 flops per byte, over 3.35 TB/s.
//   prefill - at C = 256 rows the work is 4 * C * filled * H * D flops
//             against the filled KV bytes, hundreds of flops per byte, so
//             the bf16 tensor-core rate bounds it; this first kernel runs
//             on the f32 CUDA cores and does not approach that bound.
//
// Design: the TPU kernels walked the block table with scalar-prefetched
// page ids over a sequential page grid axis.  Here a block reads its own
// block-table row, each key's address taken through the page it lies on
// (attention.cuh's PagedKV); any page size works.
//   decode  - split keys (flash-decoding, attention.cuh's split::): the
//             grid is (split, KV head, slot), a split a run of
//             pages_per_split whole pages of the slot, and the caller
//             picks the split count from static shapes (the block
//             table's width, the page, B * Hkv and the SM count; never
//             from the lengths, which live on the card).  A block scores
//             its split's keys for the g query heads of its KV head, so
//             each K/V page is read once for all g; a split that starts
//             at or past lengths[b] writes an empty partial and returns,
//             and no block reads a page past the fill.  A second kernel,
//             one block a (slot, head), merges the row's splits from the
//             workspace in split order by their maxima: no atomics, the
//             same bits every run.
//   prefill - one block per (KV head, slot) over all keys would not fit
//             the C * g rows (2048 at C = 256), so the grid is (row tiles
//             of 16, KV head, slot), walking the keys in tiles of 32
//             (attention.cuh's attend).  Row r is chunk row j = r / g of
//             head hk * g + r % g, at position start + j, and sees keys up
//             to that position.  Keys from start + n_valid on are never
//             loaded, so padding rows (j >= n_valid) attend only filled
//             keys: garbage the caller discards, never a read outside the
//             pools or the block table.
// Every row of both kernels sees key 0 (a decode slot attends its
// length + 1 >= 1 keys, a chunk row at start + j >= 0 sees its causal
// prefix), so no row is left with no visible key.
#include "attention.cuh"

namespace repro {

template <int D>
__global__ void __launch_bounds__(attn::MAX_WARPS * 32)
paged_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                     const bf16* __restrict__ vp, const int* __restrict__ bt,
                     const int* __restrict__ start, const int* __restrict__ n_valid,
                     bf16* __restrict__ out, int C, int H, int Hkv, int page,
                     int maxp, float scale) {
  using namespace attn;
  __shared__ Smem<D> sm;
  const int hk = blockIdx.y, b = blockIdx.z, g = H / Hkv;
  const int r0 = blockIdx.x * ROWS, n_rows = C * g;
  const int warp = threadIdx.x >> 5;
  const long long pos_stride = (long long)Hkv * D;
  const PagedKV kv{kp + (long long)hk * D, vp + (long long)hk * D,
                   bt + (long long)b * maxp, page, pos_stride,
                   (long long)page * pos_stride};
  const int st0 = start[b];
  const int filled = min(st0 + n_valid[b], maxp * page);
  const int j_last = (min(r0 + ROWS, n_rows) - 1) / g;   // last chunk row of the tile
  const int kv_end = max(0, min(filled, st0 + j_last + 1));

  Rows<D> st;
  const bf16* qrow[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int ri = r0 + warp * RW + r;
    const bool active = ri < n_rows;
    const int j = ri / g, h = hk * g + ri % g;
    qrow[r] = active ? q + (((long long)b * C + j) * H + h) * D : nullptr;
    st.limit[r] = active ? st0 + j : -1;
  }
  load_q<D>(sm, qrow);
  attend<D>(sm, kv, kv_end, scale, st);
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int ri = r0 + warp * RW + r;
    if (ri < n_rows) {
      const int j = ri / g, h = hk * g + ri % g;
      store_row<D>(st, r, out + (((long long)b * C + j) * H + h) * D);
    }
  }
}

}  // namespace repro

// ws: B * H * n_split * (D + 2) f32 of scratch; each slot's block-table
// row is cut into n_split splits of ceil(pages_per_slot / n_split) pages.
extern "C" int paged_decode_bf16(const void* q, const void* kp, const void* vp,
                                 const void* bt, const void* lengths, void* out, void* ws,
                                 int B, int H, int Hkv, int D, int page, int maxp,
                                 int n_split, float scale, void* stream) {
  using namespace repro;
  if (B <= 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > attn::ROWS || B > 65535 || Hkv > 65535 ||
      H > 65535 || page <= 0 || maxp < 0 || n_split <= 0)
    return (int)cudaErrorInvalidValue;
  const attn::split::PagedSource src{(const bf16*)kp, (const bf16*)vp, (const int*)bt,
                                     (const int*)lengths, Hkv, D, page, maxp};
  const int split_keys = max(1, (maxp + n_split - 1) / n_split) * page;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 128)
    return attn::split::launch<128>((const bf16*)q, src, (bf16*)out, (float*)ws, B, H,
                                    n_split, split_keys, scale, s);
  if (D == 64)
    return attn::split::launch<64>((const bf16*)q, src, (bf16*)out, (float*)ws, B, H,
                                   n_split, split_keys, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int paged_prefill_bf16(const void* q, const void* kp, const void* vp,
                                  const void* bt, const void* start,
                                  const void* n_valid, void* out, int B, int C,
                                  int H, int Hkv, int D, int page, int maxp,
                                  float scale, void* stream) {
  using namespace repro;
  if (B <= 0 || C <= 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || H % Hkv != 0 || Hkv > 65535 || B > 65535 || page <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((C * (H / Hkv) + attn::ROWS - 1) / attn::ROWS, Hkv, B);
  const dim3 block(attn::MAX_WARPS * 32);
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 128)
    paged_prefill_kernel<128><<<grid, block, 0, s>>>(
        (const bf16*)q, (const bf16*)kp, (const bf16*)vp, (const int*)bt,
        (const int*)start, (const int*)n_valid, (bf16*)out, C, H, Hkv, page,
        maxp, scale);
  else if (D == 64)
    paged_prefill_kernel<64><<<grid, block, 0, s>>>(
        (const bf16*)q, (const bf16*)kp, (const bf16*)vp, (const int*)bt,
        (const int*)start, (const int*)n_valid, (bf16*)out, C, H, Hkv, page,
        maxp, scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
