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
//   prefill - 4 * (keys each chunk row sees) * H * D flops against the
//             filled K and V, q and out.  At yi-6b's chunk of 256 rows at
//             start 256 (180 real, 436 keys filled) that is 1.56e9 flops,
//             1.58 us at the bf16 tensor-core peak, and 5.1 MB, 1.52 us at
//             3.35 TB/s: operations and bytes about even.
//
// Design: the TPU kernels walked the block table with scalar-prefetched
// page ids over a sequential page grid axis.  Here a block reads its own
// block-table row, each key's address taken through the page it lies on;
// any page size works.
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
//   prefill - the flash forward's body on wgmma (flash_fwd.cuh's
//             attend_rows: q tiles resident in shared memory, K and V in
//             a two-stage cp.async ring, s = q k^T and o += p v on the
//             tensor cores, the online softmax in registers, steps that
//             no row of a warpgroup sees skipped and the masks skipped on
//             steps it sees whole) with two other addressers.  Its rows
//             are GQA-packed (PackedRows), position-major as the Pallas
//             kernel's qg: row r of KV head hk is chunk row r / g of query
//             head hk * g + r % g, at position start + r / g, so the g
//             heads share every K/V tile a block stages and a 64-row
//             warpgroup tile spans 64 / g positions.  Its keys come
//             through the slot's block-table row, which the block copies
//             into shared memory once; each 16-byte copy of a key then
//             takes its page from there (PagedKeys).  The grid is (row
//             tiles, KV head, slot), the last tiles first; one warpgroup
//             a block and 64-key steps (PrefillCfg) give C * g / 64 blocks
//             a KV head: 128 at yi-6b's chunk of 256, 64 at granite's.
//             Rounding is the plain version's (ref.paged_prefill_ref):
//             s from bf16 q and k with f32 sums, the normalizer over the
//             f32 p, p rounded to bf16 once before o += p v, out rounded
//             once.  Keys at or past filled = min(start + n_valid,
//             pages_per_slot * page) are never read, so padding rows (j >=
//             n_valid) attend the filled keys only: finite garbage the
//             caller discards, never a read outside the pools or the block
//             table.
// Every row of both kernels sees key 0 (a decode slot attends its
// length + 1 >= 1 keys, a chunk row at start + j >= 0 sees its causal
// prefix), so no row is left with no visible key.
#include "attention.cuh"
#include "flash_fwd.cuh"

namespace repro {

// Paged prefill's warpgroups a block (each 64 packed rows), blocks an SM
// the compiler is held to (launch bounds) and 64-key tiles a step, by
// head dim; PERF.md has the measurements behind them
// (tools/paged_prefill_variants.py).
template <int D>
struct PrefillCfg;
template <>
struct PrefillCfg<128> {
  static constexpr int WGS = 1, MIN_BLOCKS = 2, KT = 1;
};
template <>
struct PrefillCfg<64> {
  static constexpr int WGS = 1, MIN_BLOCKS = 4, KT = 1;
};

// Block-table entries a slot may have: its row is staged in shared
// memory beside the tiles.
constexpr int MAX_PAGES = 16384;

// Grid (row tiles, head group, slot): the gp query heads h0 = y * gp ..
// h0 + gp - 1 of one KV head, C * gp packed rows.  Dynamic shared memory:
// the body's tiles, then the slot's block-table row (read whole, beside
// start and n_valid, so no load waits on another).
template <int D, int WGS, int MIN_BLOCKS, int KT>
__global__ void __launch_bounds__(hopper::WG_THREADS * WGS, MIN_BLOCKS)
paged_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                     const bf16* __restrict__ vp, const int* __restrict__ bt,
                     const int* __restrict__ start, const int* __restrict__ n_valid,
                     bf16* __restrict__ out, int C, int H, int Hkv, int gp,
                     ffwd::DivMod page, int maxp, float scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  int* pages = reinterpret_cast<int*>(smem + ffwd::smem_bytes<D, WGS, KT>());
  const int b = blockIdx.z, h0 = blockIdx.y * gp, hk = h0 / (H / Hkv);
  const int* row = bt + (long long)b * maxp;
  for (int i = threadIdx.x; i < maxp; i += blockDim.x) pages[i] = row[i];
  const int st = start[b];
  const int filled = max(0, min(st + n_valid[b], maxp * page.d));
  __syncthreads();              // the row is in place before the first key copy
  const long long qo = ((long long)b * C * H + h0) * D, ks = (long long)Hkv * D;
  const ffwd::PackedRows<D> rows{q + qo, out + qo, (long long)H * D, C * gp, gp, st};
  const ffwd::PagedKeys keys{kp + (long long)hk * D, vp + (long long)hk * D, pages, page,
                             filled, ks, (long long)page.d * ks};
  // the last row tiles see the most keys: schedule them first
  ffwd::attend_rows<D, WGS, KT>(rows, keys, gridDim.x - 1 - blockIdx.x, scale, smem);
}

template <int D>
int launch_prefill(const void* q, const void* kp, const void* vp, const void* bt,
                   const void* start, const void* n_valid, void* out, int B, int C, int H,
                   int Hkv, int gp, int page, int maxp, float scale, cudaStream_t s) {
  constexpr int WGS = PrefillCfg<D>::WGS, MIN_BLOCKS = PrefillCfg<D>::MIN_BLOCKS,
                KT = PrefillCfg<D>::KT;
  const int smem = ffwd::smem_bytes<D, WGS, KT>() + maxp * (int)sizeof(int);
  auto kernel = paged_prefill_kernel<D, WGS, MIN_BLOCKS, KT>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((C * gp + 64 * WGS - 1) / (64 * WGS), H / gp, B);
  kernel<<<grid, hopper::WG_THREADS * WGS, smem, s>>>(
      (const bf16*)q, (const bf16*)kp, (const bf16*)vp, (const int*)bt, (const int*)start,
      (const int*)n_valid, (bf16*)out, C, H, Hkv, gp, ffwd::DivMod::of(page), maxp,
      scale);
  return (int)cudaGetLastError();
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
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > attn::split::MAX_G || B > 65535 ||
      Hkv > 65535 || H > 65535 || page <= 0 || maxp < 0 || n_split <= 0)
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
  if (Hkv <= 0 || H % Hkv != 0 || Hkv > 65535 || B > 65535 || page <= 0 || maxp < 0 ||
      maxp > MAX_PAGES || (long long)maxp * page >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int gp = H / Hkv;       // query heads packed into a tile's rows: a KV head's g
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 128)
    return launch_prefill<128>(q, kp, vp, bt, start, n_valid, out, B, C, H, Hkv, gp, page,
                               maxp, scale, s);
  if (D == 64)
    return launch_prefill<64>(q, kp, vp, bt, start, n_valid, out, B, C, H, Hkv, gp, page,
                              maxp, scale, s);
  return (int)cudaErrorInvalidValue;
}
