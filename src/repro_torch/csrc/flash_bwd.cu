// Causal or full GQA attention backward from the saved log-sum-exp:
// dq (one kernel) and dk, dv (a second kernel), in bf16 from bf16 q, k,
// v, dO and f32 lse and delta = rowsum(out * dO) (computed by the
// wrapper, as the JAX package computes it outside its pallas_calls).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:249, flash_bwd
// (_dq_kernel, pallas_call at :278; _dkv_kernel, pallas_call at :306).
//
// Bound on the H100: the dq kernel does three S x S x D products per
// query head (s = q k^T, dp = dO v^T, dq = ds k), the dk/dv kernel four
// (s and dp again, dv = p^T dO, dk = ds^T q), halved by the causal mask.
// At yi-6b's training shape (batch 2, 4096 tokens, 32 query heads over 4
// KV heads of 128) that is 4.1e11 + 5.5e11 = 9.6e11 flops against about
// 0.2 GB of inputs and outputs: compute-bound, 0.417 + 0.556 ms at the
// 989 TFLOP/s bf16 tensor-core peak.
//
// Design: the TPU grids walked one sequential axis with the sums in
// VMEM scratch (the kv axis for dq, the q axis for dk/dv).  On Hopper
// blocks run in no order, so each sequential axis becomes a loop inside
// one block that owns its output rows, with no atomics: the result is
// the same to the bit from run to run.
//   dq:  one block per (64 query rows, query head, batch row), the last
//        rows first (they see the most keys); it walks the key tiles of
//        64 up to the causal limit.  Query head h reads KV head h / g.
//   dkv: one block per (64 keys, KV head, batch row), the first keys
//        first; it walks the g query heads of its KV head and, for each,
//        the query tiles of 64 rows that can see its keys, so GQA needs
//        no KV repeat.
// A block is one warpgroup (4 warps); every product is a wgmma m64n64k16
// (bf16 operands, f32 sums in registers), the block's 64 rows against 64
// columns, each batch committed and waited for before the elementwise
// work that reads it.  Warp w holds rows 16w..16w+15 of each
// sum.  The dk/dv kernel takes the transposed scores s^T = k q^T, so p^T
// and ds^T come out with the block's keys as rows, and their accumulator
// fragments, rounded to bf16 in registers, are the A operands of dv +=
// p^T dO and dk += ds^T q; ds is likewise the A operand of dq += ds k.
// Nothing goes back through shared memory.  The other operands are read
// by the tensor cores straight from shared memory through wgmma
// descriptors: every tile is bf16 exactly as in device memory, in the
// 128-byte swizzle (sw in wgmma.cuh), which serves both as a K-major operand
// (k, q, v, dO against the depth D) and, with the descriptor's transpose
// bit, as an MN-major B operand (k for ds k, dO and q for the dk/dv
// products).  The block's own rows (q, dO for dq; k, v for dk/dv) are
// resident; the streamed tiles (k, v; or q, dO, lse, delta) pass through
// a ring of two stages filled with cp.async, 16 bytes a thread (rows
// past the end fill with zeros), one barrier a step, so the next tile's
// copies overlap this tile's products.  Tiles are 64 rows, one wgmma's
// M: at head dim 128 a block holds 97 KB of tiles and the dk/dv sums are
// 128 floats a thread, so two blocks share an SM and one's elementwise
// work overlaps the other's products.
// A tile that every row sees whole skips the masks.  Times, and what
// the design choices are worth (tools/flash_bwd_variants.py builds the
// kernels without each), are in PERF.md.
//
// Rounding, as the reference: s and dp take bf16 q, k, dO and v as
// stored; p is rounded to bf16 once, in registers, before dv += p^T dO,
// and ds before dq += ds k and dk += ds^T q (ref.bwd, the twin of
// src/repro/kernels/flash_attention/ref.py _bwd_impl:
// p.astype(dout.dtype), ds.astype(kblk.dtype)).  The Pallas kernels keep
// both in f32.  ds = p (dp - delta) scale itself is f32 from f32 p.
//
// Masks are those of the Pallas kernels: kpos < Skv, qraw < Sq and,
// when causal, kpos <= qraw + q_offset.  Outside the first two p = 0;
// a score hidden by the causal mask is -1e30, as in the plain version,
// so p = exp(-1e30 - lse), which is 0 unless the row sees no key at all
// (causal with q_offset < 0).  Such a row's lse is -1e30 (flash_fwd gives
// it the mean of V) and its p is 1 on every key, as in the plain
// version's backward; the loops then take in every key for it.  With
// q_offset >= 0 every row sees key 0, a hidden p is exactly 0, and tiles
// wholly above the diagonal are never loaded.
#include "wgmma.cuh"

namespace repro {
namespace fbwd {

using namespace hopper;

constexpr int THREADS = WG_THREADS;  // one warpgroup
constexpr int ROWS = 64;          // query rows (dq) or keys (dk/dv) a block owns
constexpr int STEP = 64;          // keys (dq) or query rows (dk/dv) a streamed tile holds
static_assert(ROWS == 64 && STEP == 64, "every tile is 64 rows: one wgmma's M");
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of a block: two resident tiles and a ring of two stages
// of two streamed tiles, each 64 x D bf16 (TILE elements), then for dk/dv
// the two stages' lse and delta, in bytes.
template <int D>
struct Tile {
  static constexpr int TILE = 64 * D;
  static constexpr int DQ_SMEM = 6 * TILE * 2;
  static constexpr int DKV_SMEM = 6 * TILE * 2 + 2 * 2 * STEP * 4;
};

// Two blocks an SM: at head dim 128 each holds 97 KB of tiles, and the
// dk/dv kernel's 128 floats of sums a thread leave no room for a third.
template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int Sq, int Skv, int H, int Hkv,
                    int causal, int q_offset, float scale) {
  using T = Tile<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + T::TILE;
  bf16* sk = sdo + T::TILE;       // [2] streamed k tiles
  bf16* sv = sk + 2 * T::TILE;    // [2] streamed v tiles
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // the last query tiles see the most keys: schedule them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);

  const long long qs = (long long)H * D, ks = (long long)Hkv * D;
  const bf16* kb = k + (long long)b * Skv * ks + (long long)hk * D;
  const bf16* vb = v + (long long)b * Skv * ks + (long long)hk * D;
  load_tile<D>(sq, q + (long long)b * Sq * qs + (long long)h * D, qs, q0, Sq);
  load_tile<D>(sdo, dout + (long long)b * Sq * qs + (long long)h * D, qs, q0, Sq);

  // this thread's two query rows (fragment rows g and g + 8) and their
  // statistics; rows past Sq are masked
  int qr[2];
  float lse2[2], hid[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qr[i] = q0 + 16 * warp + g + 8 * i;
    const long long o = ((long long)b * Sq + qr[i]) * H + h;
    const float l = qr[i] < Sq ? lse[o] : 0.f;
    dl[i] = qr[i] < Sq ? delta[o] : 0.f;
    lse2[i] = l * LOG2E;
    hid[i] = (NEG_INF - l) * LOG2E;   // exp2 of it: p of a causally hidden key
  }
  const float scale2 = scale * LOG2E;

  // a tile whose first row sees no key takes in every key (see above)
  int kv_end = Skv;
  if (causal && q0 + q_offset >= 0)
    kv_end = max(0, min(Skv, min(q0 + ROWS, Sq) - 1 + q_offset + 1));
  const int nt = (kv_end + STEP - 1) / STEP;

  if (nt > 0) {
    load_tile<D>(sk, kb, ks, 0, Skv);
    load_tile<D>(sv, vb, ks, 0, Skv);
  }
  cp_commit();

  float acc[D / 64][8][4];
  zero<D>(acc);

  for (int it = 0; it < nt; ++it) {
    cp_wait_all();
    // tile it (and q, dO) have landed for every thread, and every warp is
    // done with tile it - 1: its stage takes tile it + 1 while this one runs
    __syncthreads();
    if (it + 1 < nt) {
      const int nxt = (it + 1) & 1;
      load_tile<D>(sk + nxt * T::TILE, kb, ks, (it + 1) * STEP, Skv);
      load_tile<D>(sv + nxt * T::TILE, vb, ks, (it + 1) * STEP, Skv);
      cp_commit();
    }
    const int k0 = it * STEP;
    const bf16* skt = sk + (it & 1) * T::TILE;
    const bf16* svt = sv + (it & 1) * T::TILE;
    float s[8][4], dp[8][4];
    wg_fence();
    wg_abt<D>(s, sq, skt);
    wg_abt<D>(dp, sdo, svt);
    wg_commit_wait();
    // ds = p (dp - delta) scale, over s's registers; a tile that every
    // row sees whole needs no mask
    if ((!causal || k0 + STEP - 1 <= q0 + q_offset) && k0 + STEP <= Skv &&
        q0 + ROWS <= Sq) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          s[j][e] = exp2f(fmaf(s[j][e], scale2, -lse2[i])) * (dp[j][e] - dl[i]) * scale;
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, kpos = k0 + 8 * j + 2 * t + (e & 1);
          const bool seen = !causal || kpos <= qr[i] + q_offset;
          const float x = seen ? fmaf(s[j][e], scale2, -lse2[i]) : hid[i];
          const float p = kpos < Skv && qr[i] < Sq ? exp2f(x) : 0.f;
          s[j][e] = p * (dp[j][e] - dl[i]) * scale;
        }
    }
    uint32_t x[4][4];
    to_a(x, s);
    wg_fence();
    wg_xb<D>(acc, x, skt);
    wg_commit_wait();
  }

  cp_wait_all();               // nothing left in flight (nt = 0 waited for none)
  store_rows<D>(dq + (long long)b * Sq * qs + (long long)h * D, qs, q0, Sq, acc);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv,
                     int H, int Hkv, int causal, int q_offset, float scale) {
  using T = Tile<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + T::TILE;
  bf16* ring = sv + T::TILE;                                   // [2] x (q, dO)
  float* stats = reinterpret_cast<float*>(ring + 4 * T::TILE);  // [2] x (lse, delta)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // the first key tiles are seen by the most queries: blocks are handed
  // out in index order, so they come first
  const int k0 = blockIdx.x * ROWS;
  const int hk = blockIdx.y, b = blockIdx.z, G = H / Hkv;

  const long long qs = (long long)H * D, ks = (long long)Hkv * D;
  const long long kv_off = (long long)b * Skv * ks + (long long)hk * D;
  const bf16* qb = q + (long long)b * Sq * qs;
  const bf16* ob = dout + (long long)b * Sq * qs;
  const float* lseb = lse + (long long)b * Sq * H;
  const float* deltab = delta + (long long)b * Sq * H;
  load_tile<D>(sk, k + kv_off, ks, k0, Skv);
  load_tile<D>(sv, v + kv_off, ks, k0, Skv);

  // the first query tile with a row that can see key k0; with q_offset
  // < 0 the first rows see no key and take in every key (see above)
  const int q_start = causal && q_offset >= 0 ? max(0, k0 - q_offset) / STEP * STEP : 0;
  const int nq = Sq > q_start ? (Sq - q_start + STEP - 1) / STEP : 0;
  const int n_it = G * nq;      // (query head, query tile) steps, head-major

  // stage the query tile of step it: rows, dO rows, lse and delta
  auto issue = [&](int it) {
    const int j = it / nq, h = hk * G + j, q0 = q_start + (it - j * nq) * STEP;
    bf16* sq = ring + (it & 1) * 2 * T::TILE;
    load_tile<D>(sq, qb + (long long)h * D, qs, q0, Sq);
    load_tile<D>(sq + T::TILE, ob + (long long)h * D, qs, q0, Sq);
    float* st = stats + (it & 1) * 2 * STEP;
    for (int i = threadIdx.x; i < 2 * STEP; i += THREADS) {
      const int r = i % STEP;
      const bool in = q0 + r < Sq;
      const float* src = i < STEP ? lseb : deltab;
      cp4(st + i, in ? src + (long long)(q0 + r) * H + h : src, in);
    }
    cp_commit();
  };
  if (n_it > 0) issue(0);       // commits k, v and step 0 as one group

  // this thread's two keys (fragment rows g and g + 8)
  const int kp[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  const float scale2 = scale * LOG2E;

  float dk_acc[D / 64][8][4], dv_acc[D / 64][8][4];
  zero<D>(dk_acc);
  zero<D>(dv_acc);

  for (int it = 0; it < n_it; ++it) {
    cp_wait_all();
    // step it (and k, v) have landed for every thread, and every warp is
    // done with step it - 1: its stage takes step it + 1 while this one runs
    __syncthreads();
    if (it + 1 < n_it) issue(it + 1);
    const int q0 = q_start + (it % nq) * STEP;
    const bf16* sq = ring + (it & 1) * 2 * T::TILE;
    const bf16* sdo = sq + T::TILE;
    const float* slse = stats + (it & 1) * 2 * STEP;
    const float* sdelta = slse + STEP;
    // s^T = k q^T and dp^T = v dO^T
    float p[8][4], ds[8][4];
    wg_fence();
    wg_abt<D>(p, sk, sq);
    wg_abt<D>(ds, sv, sdo);
    wg_commit_wait();
    // p^T, then ds^T = p^T (dp^T - delta) scale, over their registers
    // a tile whose keys every row sees needs no mask
    if ((!causal || k0 + ROWS - 1 <= q0 + q_offset) && k0 + ROWS <= Skv &&
        q0 + STEP <= Sq) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          p[j][e] = exp2f(fmaf(p[j][e], scale2, -slse[c] * LOG2E));
          ds[j][e] = p[j][e] * (ds[j][e] - sdelta[c]) * scale;
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1), qraw = q0 + c, kpos = kp[e >> 1];
          const float l = slse[c];
          const bool seen = !causal || kpos <= qraw + q_offset;
          const float x = seen ? fmaf(p[j][e], scale2, -l * LOG2E) : (NEG_INF - l) * LOG2E;
          p[j][e] = kpos < Skv && qraw < Sq ? exp2f(x) : 0.f;
          ds[j][e] = p[j][e] * (ds[j][e] - sdelta[c]) * scale;
        }
    }
    uint32_t xp[4][4], xds[4][4];
    to_a(xp, p);
    to_a(xds, ds);
    wg_fence();
    wg_xb<D>(dv_acc, xp, sdo);
    wg_xb<D>(dk_acc, xds, sq);
    wg_commit_wait();
  }

  cp_wait_all();
  store_rows<D>(dk + kv_off, ks, k0, Skv, dk_acc);
  store_rows<D>(dv + kv_off, ks, k0, Skv, dv_acc);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Sq, int Skv,
              int H, int Hkv, int causal, int q_offset, float scale, cudaStream_t s) {
  const int smem = Tile<D>::DQ_SMEM;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + ROWS - 1) / ROWS, H, B);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, Sq, Skv, H, Hkv, causal,
      q_offset, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
               int Skv, int H, int Hkv, int causal, int q_offset, float scale,
               cudaStream_t s) {
  const int smem = Tile<D>::DKV_SMEM;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Skv + ROWS - 1) / ROWS, Hkv, B);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, Sq, Skv, H, Hkv,
      causal, q_offset, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int Sq, int Skv, int H, int Hkv) {
  return Hkv <= 0 || H % Hkv != 0 || H > 65535 || Hkv > 65535 || B > 65535 ||
         Sq < 0 || Skv < 0;
}

}  // namespace fbwd
}  // namespace repro

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dq, int B, int Sq, int Skv, int H, int Hkv,
                                 int D, int causal, int q_offset, float scale,
                                 void* stream) {
  using namespace repro::fbwd;
  if (bad_shape(B, Sq, Skv, H, Hkv)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, Sq, Skv, H, Hkv, causal,
                          q_offset, scale, s);
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, Sq, Skv, H, Hkv, causal,
                         q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int Sq, int Skv, int H,
                                  int Hkv, int D, int causal, int q_offset, float scale,
                                  void* stream) {
  using namespace repro::fbwd;
  if (bad_shape(B, Sq, Skv, H, Hkv)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Skv == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, H, Hkv,
                           causal, q_offset, scale, s);
  if (D == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, H, Hkv,
                          causal, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}
