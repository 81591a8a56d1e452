// Causal or full GQA attention forward with online softmax: out (bf16)
// and the log-sum-exp of each row (f32), which the backward reads.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:86, flash_fwd
// (_fwd_kernel, pallas_call at :107).
//
// Bound on the H100: two S x S x D products per query head (s = q k^T,
// o = p v), halved by the causal mask.  At yi-6b's training shape (batch
// 2, 4096 tokens, 32 query heads over 4 KV heads of 128) that is 2.75e11
// flops against about 0.1 GB of inputs and outputs: compute-bound, 0.278
// ms at the 989 TFLOP/s bf16 tensor-core peak.  On the serving path (a
// 512-token prompt, batch 1) the bytes bound it: 2.8 us.
//
// Design: the TPU grid (batch, head, q-block, kv-block) walked the kv
// blocks in order with the running max, normalizer and sums in VMEM
// scratch.  On Hopper blocks run in no order, so the kv axis becomes a
// loop inside a block that owns its output rows, with no atomics: the
// result is the same to the bit from run to run.  A block is WGS
// warpgroups (Cfg below), each owning 64 query rows of one query head;
// the grid is (query tiles, head, batch row), the last tiles first, as
// under the causal mask they see the most keys.  Query head h reads KV
// head h / (H / Hkv) directly (no KV repeat).  The block's q tiles stay
// resident in shared memory; K and V stream in steps of KT tiles of 64
// keys through a ring of two stages filled with cp.async (rows past Skv
// fill with zeros; each thread's copy addresses are worked out once,
// TileCopy), one barrier a step, so the next step's copies overlap this
// step's products and every warpgroup of the block shares them.  Each
// step a warpgroup takes s = q k^T (wgmma m64n64k16, both operands
// K-major from shared memory), the online softmax over s's registers (a
// row's 64 columns of a tile lie in the 4 lanes 4 g..4 g + 3, so two
// shuffles give its maximum), then o += p v with p rounded to bf16 in
// registers as the A operand and v an MN-major B operand: nothing goes
// back through shared memory.  Each product batch is committed and
// waited for before the elementwise work reads it (wgmma.cuh).  The
// normalizer's sums stay per thread until the end.  A warpgroup skips
// the steps that none of its rows sees, and a step that every row of the
// warpgroup sees whole skips the masks.  Times, and what the design
// choices are worth (tools/flash_fwd_variants.py builds the kernel
// without each), are in PERF.md.
//
// Rounding, as the reference (ref.fwd, the twin of
// src/repro/kernels/flash_attention/ref.py _fwd): s is taken on bf16 q
// and k with f32 sums; the normalizer l sums the f32 p; p is rounded to
// bf16 once before o += p v (p.astype(vblk.dtype)); out = o / max(l,
// 1e-30) is rounded to bf16 and lse = m + log(max(l, 1e-30)).  The
// Pallas kernel keeps p in f32.
//
// Masks are those of the Pallas kernel: kpos < Skv and, when causal,
// kpos <= i + q_offset.  Keys at or past Skv get p = 0; a score hidden by
// the causal mask is -1e30, as in the plain version, so its p is
// exp(-1e30 - m), which is 0 unless the row sees no key at all (causal
// with i + q_offset < 0).  Such a row's running max stays -1e30, its p is
// 1 on every key, and it gets the reference's answer: the mean of
// V[0, Skv) and lse -1e30 + log(Skv), which rounds to -1e30.  A
// warpgroup whose first row sees no key therefore takes in every key.
// With q_offset >= 0 every row sees key 0 and tiles wholly above the
// diagonal are never loaded.
#include <math_constants.h>

#include "wgmma.cuh"

namespace repro {
namespace ffwd {

using namespace hopper;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// 2^x; 2^(-1e30 or less) = 0 (the flush of subnormal results changes no
// bf16 p and no normalizer beyond its float32 rounding)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Warpgroups a block (each 64 query rows), blocks an SM the compiler is
// held to (launch bounds) and 64-key tiles a step, by head dim; PERF.md
// has the measurements behind them.
template <int D>
struct Cfg;
template <>
struct Cfg<128> {
  static constexpr int WGS = 3, MIN_BLOCKS = 1, KT = 2;
};
template <>
struct Cfg<64> {
  static constexpr int WGS = 2, MIN_BLOCKS = 2, KT = 1;
};

// Shared memory: WGS resident q tiles, then two stages of KT k and KT v
// tiles, each 64 x D bf16, in bytes.
template <int D, int WGS, int KT>
constexpr int smem_bytes() {
  return (WGS + 4 * KT) * 64 * D * 2;
}

// Keys [0, end) that rows [r0, r0 + 64) can see: all of them when the
// first row sees none (see above), none when the rows lie past Sq.
__device__ __forceinline__ int key_end(int r0, int Sq, int Skv, int causal, int q_offset) {
  if (r0 >= Sq) return 0;
  if (!causal || r0 + q_offset < 0) return Skv;
  return max(0, min(Skv, min(r0 + 64, Sq) + q_offset));
}

template <int D, int WGS, int MIN_BLOCKS, int KT>
__global__ void __launch_bounds__(WG_THREADS * WGS, MIN_BLOCKS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Skv, int H, int Hkv,
                 int causal, int q_offset, float scale) {
  constexpr int NT = WG_THREADS * WGS, ROWS = 64 * WGS, TILE = 64 * D, STEP = 64 * KT;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);   // [WGS] resident q tiles
  bf16* sk = sq + WGS * TILE;                     // [2][KT] streamed k tiles
  bf16* sv = sk + 2 * KT * TILE;                  // [2][KT] streamed v tiles
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int wg = threadIdx.x / WG_THREADS;
  const int g = lane >> 2, t = lane & 3;
  // the last query tiles see the most keys: schedule them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int w0 = q0 + 64 * wg;                    // this warpgroup's first row

  const long long qs = (long long)H * D, ks = (long long)Hkv * D;
  const bf16* qb = q + (long long)b * Sq * qs + (long long)h * D;
  const bf16* kb = k + (long long)b * Skv * ks + (long long)hk * D;
  const bf16* vb = v + (long long)b * Skv * ks + (long long)hk * D;
  const TileCopy<D, NT> copy;
#pragma unroll
  for (int i = 0; i < WGS; ++i) copy(sq + i * TILE, qb, qs, q0 + 64 * i, Sq);

  const int w_end = key_end(w0, Sq, Skv, causal, q_offset);
  int kv_end = 0;
#pragma unroll
  for (int i = 0; i < WGS; ++i)
    kv_end = max(kv_end, key_end(q0 + 64 * i, Sq, Skv, causal, q_offset));
  const int nt = (kv_end + STEP - 1) / STEP;
  // keys [k0, k0 + STEP) into stage st of the ring
  auto load_step = [&](int st, int k0) {
#pragma unroll
    for (int u = 0; u < KT; ++u) {
      copy(sk + (st * KT + u) * TILE, kb, ks, k0 + 64 * u, Skv);
      copy(sv + (st * KT + u) * TILE, vb, ks, k0 + 64 * u, Skv);
    }
  };
  if (nt > 0) load_step(0, 0);
  cp_commit();

  // this thread's two query rows (fragment rows g and g + 8): running
  // max of the scaled scores, and this thread's share of the normalizer
  int qr[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qr[i] = w0 + 16 * warp + g + 8 * i;
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  const float scale2 = scale * LOG2E;
  const bf16* sqw = sq + wg * TILE;
  float o[D / 64][8][4];
  zero<D>(o);

  for (int it = 0; it < nt; ++it) {
    cp_wait_all();
    // tile it (and q) have landed for every thread, and every warp is
    // done with tile it - 1: its stage takes tile it + 1 while this one runs
    __syncthreads();
    if (it + 1 < nt) {
      load_step((it + 1) & 1, (it + 1) * STEP);
      cp_commit();
    }
    const int k0 = it * STEP;
    if (k0 >= w_end) continue;                    // no row of this warpgroup sees it
    const bf16* skt = sk + (it & 1) * KT * TILE;
    const bf16* svt = sv + (it & 1) * KT * TILE;
    float s[KT][8][4];
    wg_fence();
#pragma unroll
    for (int u = 0; u < KT; ++u) wg_abt<D>(s[u], sqw, skt + u * TILE);
    wg_commit_wait();

    // the row maxima over the keys each row sees; a tile that every row
    // of the warpgroup sees whole needs no mask
    const bool whole = (!causal || k0 + STEP - 1 <= w0 + q_offset) && k0 + STEP <= Skv;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
    if (whole) {
#pragma unroll
      for (int u = 0; u < KT; ++u)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[u][j][e]);
    } else {
#pragma unroll
      for (int u = 0; u < KT; ++u)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, kpos = k0 + 64 * u + 8 * j + 2 * t + (e & 1);
            if (kpos < Skv && (!causal || kpos <= qr[i] + q_offset))
              mx[i] = fmaxf(mx[i], s[u][j][e]);
          }
    }
    float mb2[2], hid[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL_MASK, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL_MASK, mx[i], 2));
      // a hidden score is -1e30 < any score seen, so it never raises m
      const float mn = fmaxf(m[i], mx[i] * scale);
      alpha[i] = ex2((m[i] - mn) * LOG2E);
      mb2[i] = mn * LOG2E;
      hid[i] = (NEG_INF - mn) * LOG2E;   // exp2 of it: p of a causally hidden key
      m[i] = mn;
    }
    // p over s's registers, and this thread's part of each row sum
    float rs[2] = {0.f, 0.f};
    if (whole) {
#pragma unroll
      for (int u = 0; u < KT; ++u)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[u][j][e] = ex2(fmaf(s[u][j][e], scale2, -mb2[e >> 1]));
            rs[e >> 1] += s[u][j][e];
          }
    } else {
#pragma unroll
      for (int u = 0; u < KT; ++u)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, kpos = k0 + 64 * u + 8 * j + 2 * t + (e & 1);
            const bool seen = !causal || kpos <= qr[i] + q_offset;
            const float x = seen ? fmaf(s[u][j][e], scale2, -mb2[i]) : hid[i];
            s[u][j][e] = kpos < Skv ? ex2(x) : 0.f;
            rs[e >> 1] += s[u][j][e];
          }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nb][j][e] *= alpha[e >> 1];
    uint32_t x[KT][4][4];
#pragma unroll
    for (int u = 0; u < KT; ++u) to_a(x[u], s[u]);
    wg_fence();
#pragma unroll
    for (int u = 0; u < KT; ++u) wg_xb<D>(o, x[u], svt + u * TILE);
    wg_commit_wait();
  }

  cp_wait_all();               // nothing left in flight (nt = 0 waited for none)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL_MASK, l[i], 1);
    l[i] += __shfl_xor_sync(FULL_MASK, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nb][j][e] = o[nb][j][e] / l[e >> 1];
  store_rows<D>(out + (long long)b * Sq * qs + (long long)h * D, qs, q0, Sq, o);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (qr[i] < Sq) lse[((long long)b * Sq + qr[i]) * H + h] = m[i] + logf(l[i]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B,
           int Sq, int Skv, int H, int Hkv, int causal, int q_offset, float scale,
           cudaStream_t s) {
  constexpr int WGS = Cfg<D>::WGS, MIN_BLOCKS = Cfg<D>::MIN_BLOCKS, KT = Cfg<D>::KT;
  constexpr int smem = smem_bytes<D, WGS, KT>();
  auto kernel = flash_fwd_kernel<D, WGS, MIN_BLOCKS, KT>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + 64 * WGS - 1) / (64 * WGS), H, B);
  kernel<<<grid, WG_THREADS * WGS, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, (float*)lse, Sq, Skv, H,
      Hkv, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace ffwd
}  // namespace repro

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* out, void* lse, int B, int Sq, int Skv,
                              int H, int Hkv, int D, int causal, int q_offset,
                              float scale, void* stream) {
  using namespace repro::ffwd;
  if (B <= 0 || Sq <= 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || H % Hkv != 0 || H > 65535 || B > 65535 || Skv < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 128)
    return launch<128>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, causal, q_offset, scale, s);
  if (D == 64)
    return launch<64>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, causal, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}
