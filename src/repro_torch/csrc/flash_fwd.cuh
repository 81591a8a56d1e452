// The body of the attention forward on wgmma, shared by flash_fwd.cu
// (rows of one query head over a contiguous K/V) and paged_attention.cu's
// chunk prefill (the g query heads of a KV head packed into one tile's
// rows, over a paged K/V).  flash_fwd.cu's header note says what it does;
// the two differ only in where a row and a key live:
//
// A row map (HeadRows, PackedRows) says which query rows a block holds:
//   n                    rows in all (a tile's rows at or past n are
//                        zeros and are not stored)
//   load(copy, s, r0)    rows [r0, r0 + 64) of q into the tile s
//   pos(r)               row r's position: with causal(), keys past it
//                        are hidden; nondecreasing in r
//   store(o, r0)         the block's output rows from r0
//   lse(r, x)            row r's log-sum-exp (paged prefill keeps none)
// A key source (ContigKeys, PagedKeys):
//   n                    keys; none at or past n is read
//   load(copy, sk, sv, k0)  keys [k0, k0 + 64) into the tiles sk and sv
#pragma once

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

// Shared memory: WGS resident q tiles, then two stages of KT k and KT v
// tiles, each 64 x D bf16 (64 x 64 at D = 32: wgmma.cuh), in bytes.
template <int D, int WGS, int KT>
__host__ __device__ constexpr int smem_bytes() {
  return (WGS + 4 * KT) * tile_elems<D>() * 2;
}

// Rows of batch row b and query head h of a (B, Sq, H, D) q and out, row
// i at position i + q_offset, and their lse in a (B, Sq, H) array.  Each
// address is taken where it is used, from the kernel's arguments (not
// held in registers across the key loop).
template <int D>
struct HeadRows {
  const bf16* q;
  bf16* out;
  float* lse_;
  long long stride;            // H * D
  int n, H, b, h, q_offset, causal_;   // n = Sq
  __device__ __forceinline__ long long base() const {
    return (long long)b * n * stride + (long long)h * D;
  }
  __device__ __forceinline__ int pos(int r) const { return r + q_offset; }
  __device__ __forceinline__ bool causal() const { return causal_; }
  template <class Copy>
  __device__ __forceinline__ void load(const Copy& copy, bf16* s, int r0) const {
    copy(s, q + base(), stride, r0, n);
  }
  __device__ __forceinline__ void store(const float (&o)[col_blocks<D>()][8][4],
                                        int r0) const {
    store_rows<D>(out + base(), stride, r0, n, o);
  }
  __device__ __forceinline__ void lse(int r, float x) const {
    lse_[((long long)b * n + r) * H + h] = x;
  }
};

// The chunk rows of one (slot, KV head group) of a (B, C, H, D) q and
// out, GQA-packed position-major: row r is chunk row r / gp of query head
// h0 + r % gp, at position start + r / gp, so the gp heads share every
// K/V tile and a 64-row tile spans 64 / gp positions.  Always causal.
template <int D>
struct PackedRows {
  const bf16* q;               // at (b, 0, h0, 0)
  bf16* out;                   // likewise
  long long stride;            // H * D: one chunk row
  int n, gp, start;            // n = C * gp
  __device__ __forceinline__ long long offset(int r) const {
    return (long long)(r / gp) * stride + (r % gp) * D;
  }
  __device__ __forceinline__ int pos(int r) const { return start + r / gp; }
  __device__ __forceinline__ bool causal() const { return true; }
  template <class Copy>
  __device__ __forceinline__ void load(const Copy& copy, bf16* s, int r0) const {
    copy.rows(s, q, [this](int r) { return offset(r); }, r0, n);
  }
  __device__ __forceinline__ void store(const float (&o)[col_blocks<D>()][8][4],
                                        int r0) const {
    store_rows_at<D>([this](int r) { return out + offset(r); }, r0, n, o);
  }
  __device__ __forceinline__ void lse(int, float) const {}
};

// Keys of one (batch row, KV head) of a contiguous (B, Skv, Hkv, D) K and V.
struct ContigKeys {
  const bf16* k;               // at (b, 0, hk, 0)
  const bf16* v;
  long long stride;            // Hkv * D
  int n;                       // Skv
  template <class Copy>
  __device__ __forceinline__ void load(const Copy& copy, bf16* sk, bf16* sv, int k0) const {
    copy(sk, k, stride, k0, n);
    copy(sv, v, stride, k0, n);
  }
};

// n / d and n % d for 0 <= n < 2^31 and a divisor d >= 1 known only at
// run time, by one multiply-high with d's reciprocal rounded up to 32 +
// ceil(log2 d) bits (Granlund and Montgomery; CUTLASS's FastDivmod): a
// division by a run-time int costs some twenty dependent instructions.
struct DivMod {
  int d;
  unsigned mul;
  int shr;
  static DivMod of(int d) {
    if (d == 1) return {1, 0u, 0};
    int l = 0;
    while ((1LL << l) < d) ++l;
    return {d, (unsigned)(((1ULL << (31 + l)) + d - 1) / d), l - 1};
  }
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : (int)(__umulhi((unsigned)n, mul) >> shr);
  }
};

// Keys of one slot and KV head in (P, page, Hkv, D) page pools, through
// the slot's block-table row (in shared memory): key pos lies on page
// pages[pos / page], row pos % page.  One lookup a 16-byte copy serves
// its K and its V.
struct PagedKeys {
  const bf16* k;               // at (0, 0, hk, 0)
  const bf16* v;
  const int* pages;            // the slot's block-table row
  DivMod page;                 // tokens a page
  int n;                       // the fill
  long long pos_stride;        // Hkv * D
  long long page_stride;       // page * Hkv * D
  template <class Copy>
  __device__ __forceinline__ void load(const Copy& copy, bf16* sk, bf16* sv, int k0) const {
    copy.pair(sk, sv, k, v,
              [this](int pos) {
                const int pg = page.div(pos);
                return (long long)pages[pg] * page_stride +
                       (long long)(pos - pg * page.d) * pos_stride;
              },
              k0, n);
  }
};

// Keys [0, end) that rows [r0, r0 + 64) can see: all of them when the
// first row sees none (flash_fwd.cu's note), none when the rows lie past
// the last.
template <class Rows>
__device__ __forceinline__ int key_end(const Rows& rows, int r0, int nk) {
  if (r0 >= rows.n) return 0;
  if (!rows.causal() || rows.pos(r0) < 0) return nk;
  return max(0, min(nk, rows.pos(min(r0 + 64, rows.n) - 1) + 1));
}

// One block: WGS warpgroups, each owning 64 rows of row tile `tile` (rows
// [tile * 64 * WGS, ...)), against the keys, in steps of KT tiles of 64
// keys.  smem holds smem_bytes<D, WGS, KT>() bytes, 1024-byte aligned.
template <int D, int WGS, int KT, class Rows, class Keys>
__device__ __forceinline__ void attend_rows(const Rows& rows, const Keys& keys, int tile,
                                            float scale, unsigned char* smem) {
  constexpr int NT = WG_THREADS * WGS, ROWS = 64 * WGS, TILE = tile_elems<D>();
  constexpr int STEP = 64 * KT;
  bf16* sq = reinterpret_cast<bf16*>(smem);       // [WGS] resident q tiles
  bf16* sk = sq + WGS * TILE;                     // [2][KT] streamed k tiles
  bf16* sv = sk + 2 * KT * TILE;                  // [2][KT] streamed v tiles
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int wg = threadIdx.x / WG_THREADS;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = tile * ROWS;
  const int w0 = q0 + 64 * wg;                    // this warpgroup's first row

  const TileCopy<D, NT> copy;
#pragma unroll
  for (int i = 0; i < WGS; ++i) rows.load(copy, sq + i * TILE, q0 + 64 * i);

  const int w_end = key_end(rows, w0, keys.n);
  int kv_end = 0;
#pragma unroll
  for (int i = 0; i < WGS; ++i) kv_end = max(kv_end, key_end(rows, q0 + 64 * i, keys.n));
  const int nt = (kv_end + STEP - 1) / STEP;
  // keys [k0, k0 + STEP) into stage st of the ring
  auto load_step = [&](int st, int k0) {
#pragma unroll
    for (int u = 0; u < KT; ++u)
      keys.load(copy, sk + (st * KT + u) * TILE, sv + (st * KT + u) * TILE, k0 + 64 * u);
  };
  if (nt > 0) load_step(0, 0);
  cp_commit();

  // this thread's two query rows (fragment rows g and g + 8): running
  // max of the scaled scores, and this thread's share of the normalizer
  // and the positions the masks hold keys to, taken once (a row map's
  // pos may divide)
  int qr[2], qp[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qr[i] = w0 + 16 * warp + g + 8 * i;
    qp[i] = rows.pos(qr[i]);
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  const int wpos = rows.pos(w0);
  const float scale2 = scale * LOG2E;
  const bf16* sqw = sq + wg * TILE;
  float o[col_blocks<D>()][8][4];
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
    const bool whole =
        (!rows.causal() || k0 + STEP - 1 <= wpos) && k0 + STEP <= keys.n;
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
            if (kpos < keys.n && (!rows.causal() || kpos <= qp[i]))
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
            const bool seen = !rows.causal() || kpos <= qp[i];
            const float x = seen ? fmaf(s[u][j][e], scale2, -mb2[i]) : hid[i];
            s[u][j][e] = kpos < keys.n ? ex2(x) : 0.f;
            rs[e >> 1] += s[u][j][e];
          }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int nb = 0; nb < col_blocks<D>(); ++nb)
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
  for (int nb = 0; nb < col_blocks<D>(); ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nb][j][e] = o[nb][j][e] / l[e >> 1];
  rows.store(o, q0);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (qr[i] < rows.n) rows.lse(qr[i], m[i] + logf(l[i]));
  }
}

}  // namespace ffwd
}  // namespace repro
