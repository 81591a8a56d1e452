// The online-softmax cores of the port's decode and paged attention
// kernels (paged_attention.cu, decode_attention.cu): `attend`, which one
// block runs over all of a row group's keys (paged prefill), and
// split::, which cuts one query row group's keys into splits that run in
// separate blocks and merges them (paged decode and decode over a
// contiguous cache, one kernel behind either KV addresser).
//
// attend:
// A block of up to MAX_WARPS warps owns up to RW query rows per warp,
// all of one KV head.  It walks the keys in tiles of TK = 32 positions:
// the whole block loads a tile of K and V (16-byte bf16 vectors,
// converted to f32) into shared memory, then each warp scores its rows
// with one key per lane, updates each row's running max and normalizer
// with warp shuffles, and accumulates p @ V with each lane owning D/32
// output columns.  Where a key lives is the caller's affair: a KV
// addresser maps a key position to its element offset, which is how one
// core serves both a contiguous cache and a page pool behind a block
// table.  Keys at or past `kv_end` are never read.
#pragma once

#include "wgmma.cuh"

namespace repro {
namespace attn {

constexpr int TK = 32;         // keys per tile: one per lane
constexpr int RW = 4;          // query rows per warp
constexpr int MAX_WARPS = 4;   // rows per block <= RW * MAX_WARPS
constexpr int ROWS = RW * MAX_WARPS;
constexpr float NEG_INF = -1e30f;

template <int D>
struct Smem {
  float q[MAX_WARPS][RW][D];
  float k[TK][D + 1];          // +1: lanes read column d of 32 rows
  float v[TK][D];
};

// Keys of one (batch row, KV head) of a contiguous (B, S, Hkv, D) cache.
struct ContigKV {
  const bf16* k;               // already offset to (b, 0, hk, 0)
  const bf16* v;
  long long pos_stride;        // Hkv * D
  __device__ long long offset(int pos) const { return (long long)pos * pos_stride; }
};

// Keys of one slot and KV head in a (P, page, Hkv, D) page pool.
struct PagedKV {
  const bf16* k;               // already offset to (0, 0, hk, 0)
  const bf16* v;
  const int* pages;            // the slot's block-table row
  int page;                    // tokens per page
  long long pos_stride;        // Hkv * D
  long long page_stride;       // page * Hkv * D
  __device__ long long offset(int pos) const {
    return (long long)pages[pos / page] * page_stride
         + (long long)(pos % page) * pos_stride;
  }
};

// Per-warp state of RW rows: running max, normalizer, accumulator.
template <int D>
struct Rows {
  float m[RW], l[RW], acc[RW][D / 32];
  int limit[RW];               // key pos <= limit is visible; -1: inactive row
};

// Load this warp's RW query rows (bf16, D wide) into shared memory as
// f32; a null pointer marks an inactive row, loaded as zeros.
template <int D>
__device__ __forceinline__ void load_q(Smem<D>& sm, const bf16* const (&qrow)[RW]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < RW; ++r)
    for (int d = lane; d < D; d += 32)
      sm.q[warp][r][d] = qrow[r] ? __bfloat162float(qrow[r][d]) : 0.f;
}

// Every thread of the block must call this with the same kv_end.
template <int D, class KV>
__device__ void attend(Smem<D>& sm, const KV& kv, int kv_end, float scale,
                       Rows<D>& st) {
  static_assert(D % 32 == 0 && D % 8 == 0, "head dim must be a multiple of 32");
  constexpr int VPR = D / 8;   // 16-byte vectors per key row
  constexpr int NC = D / 32;   // output columns per lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    st.m[r] = NEG_INF;
    st.l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) st.acc[r][c] = 0.f;
  }

  for (int t0 = 0; t0 < kv_end; t0 += TK) {
    __syncthreads();           // the previous tile (and q) is consumed
    for (int vi = threadIdx.x; vi < TK * VPR; vi += blockDim.x) {
      const int j = vi / VPR, c = (vi % VPR) * 8, pos = t0 + j;
      float kf[8], vf[8];
      if (pos < kv_end) {
        const long long o = kv.offset(pos) + c;
        unpack8(*reinterpret_cast<const uint4*>(kv.k + o), kf);
        unpack8(*reinterpret_cast<const uint4*>(kv.v + o), vf);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sm.k[j][c + e] = kf[e];
        sm.v[j][c + e] = vf[e];
      }
    }
    __syncthreads();

    // scores: lane j takes key t0 + j against the warp's RW rows
    float s[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = sm.k[lane][d];
#pragma unroll
      for (int r = 0; r < RW; ++r) s[r] = fmaf(sm.q[warp][r][d], kd, s[r]);
    }
    const int pos = t0 + lane;
    float p[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const bool valid = pos < kv_end && pos <= st.limit[r];
      const float sr = valid ? s[r] * scale : NEG_INF;
      const float m_new = fmaxf(st.m[r], warp_max(sr));
      p[r] = valid ? expf(sr - m_new) : 0.f;
      const float alpha = expf(st.m[r] - m_new);
      st.l[r] = st.l[r] * alpha + warp_sum(p[r]);
      st.m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) st.acc[r][c] *= alpha;
    }

    // p @ V: lane owns columns lane + 32 c
    for (int j = 0; j < TK; ++j) {
      float vj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vj[c] = sm.v[j][lane + 32 * c];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float pj = __shfl_sync(FULL_MASK, p[r], j);
#pragma unroll
        for (int c = 0; c < NC; ++c) st.acc[r][c] = fmaf(pj, vj[c], st.acc[r][c]);
      }
    }
  }
}

// Write row r of this warp: out = acc / max(l, 1e-30) in bf16.
template <int D>
__device__ __forceinline__ void store_row(const Rows<D>& st, int r, bf16* out) {
  const int lane = threadIdx.x & 31;
  const float l = fmaxf(st.l[r], 1e-30f);
#pragma unroll
  for (int c = 0; c < D / 32; ++c) out[lane + 32 * c] = __float2bfloat16(st.acc[r][c] / l);
}

// ---------------------------------------------------------------------------
// Split-key decode (flash-decoding): the keys of one (slot, KV head) are
// cut into splits of whole pages, each split a block of WARPS warps.
// The block stages its keys in chunks of CK = 16 positions, one chunk a
// warp at a time (chunk c goes to warp c % WARPS), K and V as bf16 in a
// two-stage cp.async ring of the warp's own, each key's address taken
// through the KV addresser.  A warp scores its chunk for the g <= G query
// rows of the KV head with two mma.sync m16n8k16 products a 16-deep
// slice (the rows padded to 16 with zeros, q in registers as A
// fragments, K read as B fragments from rows padded by 16 bytes so the 8
// rows of a fragment read hit distinct banks), keeps its own f32 running
// max and normalizer per row, and adds p V with p in f32 on the CUDA
// cores, each lane owning D / 32 adjacent output columns of every row.
// The warps' partials merge in shared memory by their maxima, and the
// block writes its split's partial: the f32 sums (D a row), the max and
// the normalizer.  `combine` then merges a row's splits in split order.
// Scores are masked as the reference masks them (-1e30, and p = 0).
// ---------------------------------------------------------------------------
namespace split {

constexpr int CK = 16;            // keys a chunk
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int PS = CK + 4;        // floats a row of a warp's p tile; column CK holds alpha

template <int D>
struct Layout {
  static constexpr int KROW = D + 8;                // bf16 a staged key row
  static constexpr int STAGE = 2 * CK * KROW;       // a chunk's K then V
  static constexpr int WARP = 2 * STAGE;            // two stages a warp
  static constexpr int P = 16 * PS;                 // a warp's p tile, f32
  static constexpr int BYTES = WARPS * (WARP * 2 + P * 4);
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a b for one 16 x 8 x 16 step: a row-major 16 x 16, b 16 x 8 given
// by columns, both bf16 pairs packed in 32-bit registers.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// NC bf16 at p (8 or 4 bytes, aligned) to f32.
template <int NC>
__device__ __forceinline__ void load_cols(const bf16* p, float (&v)[NC]) {
  if constexpr (NC == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else {
    static_assert(NC == 2, "head dim 64 or 128");
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x; v[1] = f.y;
  }
}

// One split: keys [k_lo, k_hi) of kv against the g <= G query rows at q
// (row r at q + r * D).  Writes row r's partial: its f32 sums to
// acc + r * acc_stride (D of them), its max and normalizer to ml + r *
// ml_stride.  An empty split writes max -1e30 and normalizer 0 and
// returns.  Every thread of the block calls it; smem holds
// Layout<D>::BYTES, 16-byte aligned.
template <int D, int G, class KV>
__device__ void decode_split(const KV& kv, const bf16* __restrict__ q, int g, int k_lo,
                             int k_hi, float scale, float* __restrict__ acc,
                             long long acc_stride, float* __restrict__ ml,
                             long long ml_stride, unsigned char* smem) {
  using L = Layout<D>;
  constexpr int NC = D / 32;      // output columns a lane
  constexpr int VPR = D / 8;      // 16-byte copies a key row
  static_assert(G >= 1 && G <= 16, "at most 16 query rows a KV head");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t = lane & 3;   // fragment row group, pair
  if (k_lo >= k_hi) {
    for (int r = threadIdx.x; r < g; r += THREADS) {
      ml[r * ml_stride] = NEG_INF;
      ml[r * ml_stride + 1] = 0.f;
    }
    return;
  }
  bf16* ring = reinterpret_cast<bf16*>(smem) + warp * L::WARP;
  float* ps = reinterpret_cast<float*>(smem + WARPS * L::WARP * 2) + warp * L::P;

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = 16 * kk + 2 * t;
    qa[kk][0] = gq < g ? ld32(q + gq * D + c) : 0u;
    qa[kk][1] = gq + 8 < g ? ld32(q + (gq + 8) * D + c) : 0u;
    qa[kk][2] = gq < g ? ld32(q + gq * D + c + 8) : 0u;
    qa[kk][3] = gq + 8 < g ? ld32(q + (gq + 8) * D + c + 8) : 0u;
  }

  const int nchunk = (k_hi - k_lo + CK - 1) / CK;
  // chunk c's keys into stage st of this warp's ring; past k_hi, zeros
  auto load = [&](int st, int c) {
    bf16* sk = ring + st * L::STAGE;
    bf16* sv = sk + CK * L::KROW;
    const int base = k_lo + c * CK;
#pragma unroll
    for (int u = 0; u < CK * VPR / 32; ++u) {
      const int i = lane + 32 * u, j = i / VPR, col = (i % VPR) * 8, pos = base + j;
      const bool in = pos < k_hi;
      const long long o = in ? kv.offset(pos) + col : 0;
      hopper::cp16(sk + j * L::KROW + col, kv.k + o, in);
      hopper::cp16(sv + j * L::KROW + col, kv.v + o, in);
    }
  };

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[G][NC];
#pragma unroll
  for (int r = 0; r < G; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) o[r][c] = 0.f;

  if (warp < nchunk) load(0, warp);
  hopper::cp_commit();
  int it = 0;
  for (int c = warp; c < nchunk; c += WARPS, ++it) {
    if (c + WARPS < nchunk) load((it + 1) & 1, c + WARPS);
    hopper::cp_commit();
    hopper::cp_wait<1>();       // chunk c has landed for this lane ...
    __syncwarp();               // ... and for every lane of the warp
    const bf16* sk = ring + (it & 1) * L::STAGE;
    const bf16* sv = sk + CK * L::KROW;

    // s = q k^T: s[j][e] is row gq + 8 (e / 2), key 8 j + 2 t + e % 2
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bf16* kr = sk + (8 * j + gq) * L::KROW + 16 * kk + 2 * t;
        const uint32_t b[2] = {ld32(kr), ld32(kr + 8)};
        mma16816(s[j], qa[kk], b);
      }
    const int base = k_lo + c * CK;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = base + 8 * j + 2 * t + (e & 1) < k_hi;
        s[j][e] = in ? s[j][e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL_MASK, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL_MASK, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - mn);
      m[i] = mn;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = base + 8 * j + 2 * t + (e & 1) < k_hi;
        s[j][e] = in ? expf(s[j][e] - m[e >> 1]) : 0.f;
        l[e >> 1] += s[j][e];
      }
    // p (and each row's alpha) to the warp's tile, for every lane
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = gq + 8 * half;
      if (row < G) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
          *reinterpret_cast<float2*>(ps + row * PS + 8 * j + 2 * t) =
              make_float2(s[j][2 * half], s[j][2 * half + 1]);
        if (t == 0) ps[row * PS + CK] = alpha[half];
      }
    }
    __syncwarp();
    // o = o * alpha + p V, key by key in order
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const float a = ps[r * PS + CK];
#pragma unroll
      for (int c2 = 0; c2 < NC; ++c2) o[r][c2] *= a;
    }
#pragma unroll
    for (int k2 = 0; k2 < CK / 2; ++k2) {
      float v[2][NC];
      load_cols<NC>(sv + (2 * k2) * L::KROW + lane * NC, v[0]);
      load_cols<NC>(sv + (2 * k2 + 1) * L::KROW + lane * NC, v[1]);
#pragma unroll
      for (int r = 0; r < G; ++r) {
        const float2 p2 = *reinterpret_cast<const float2*>(ps + r * PS + 2 * k2);
#pragma unroll
        for (int c2 = 0; c2 < NC; ++c2) {
          o[r][c2] = fmaf(p2.x, v[0][c2], o[r][c2]);
          o[r][c2] = fmaf(p2.y, v[1][c2], o[r][c2]);
        }
      }
    }
    __syncwarp();               // the stage and the p tile are consumed
  }
  hopper::cp_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL_MASK, l[i], 1);
    l[i] += __shfl_xor_sync(FULL_MASK, l[i], 2);
  }

  // merge the warps' partials by their maxima; a warp that had no chunk
  // has max -1e30 and weighs 0
  __syncthreads();              // every warp is done with its ring
  float* wo = reinterpret_cast<float*>(smem);   // [WARPS][G][D]
  float* wml = wo + WARPS * G * D;              // [WARPS][G][2]
#pragma unroll
  for (int r = 0; r < G; ++r)
#pragma unroll
    for (int c2 = 0; c2 < NC; ++c2) wo[(warp * G + r) * D + lane * NC + c2] = o[r][c2];
  if (t == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = gq + 8 * half;
      if (row < G) {
        wml[(warp * G + row) * 2] = m[half];
        wml[(warp * G + row) * 2 + 1] = l[half];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g * D; i += THREADS) {
    const int r = i / D, d = i % D;
    float mm = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, wml[(w * G + r) * 2]);
    float a = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float x = expf(wml[(w * G + r) * 2] - mm);
      a = fmaf(x, wo[(w * G + r) * D + d], a);
      ll = fmaf(x, wml[(w * G + r) * 2 + 1], ll);
    }
    acc[r * acc_stride + d] = a;
    if (d == 0) {
      ml[r * ml_stride] = mm;
      ml[r * ml_stride + 1] = ll;
    }
  }
}

// One output row from its first n splits' partials (acc: D sums a split,
// ml: max and normalizer a split): out[d] = sum_s w_s acc_s[d] / sum_s
// w_s l_s with w_s = exp(m_s - max_s m_s), in split order.  D threads.
template <int D>
__device__ __forceinline__ void combine(const float* __restrict__ acc,
                                        const float* __restrict__ ml, int n,
                                        bf16* __restrict__ out) {
  const int d = threadIdx.x;
  float mm = NEG_INF;
  for (int s = 0; s < n; ++s) mm = fmaxf(mm, ml[2 * s]);
  float a = 0.f, ll = 0.f;
  for (int s = 0; s < n; ++s) {
    const float x = expf(ml[2 * s] - mm);
    a = fmaf(x, acc[(long long)s * D + d], a);
    ll = fmaf(x, ml[2 * s + 1], ll);
  }
  out[d] = __float2bfloat16(a / fmaxf(ll, 1e-30f));
}

// Where a row group's keys come from: each (slot, KV head)'s addresser
// and its visible length.
// A (P, page, Hkv, D) page pool behind a (B, maxp) block table, per-slot
// lengths (clamped to the table's width).
struct PagedSource {
  const bf16* kp;
  const bf16* vp;
  const int* bt;
  const int* lengths;
  int Hkv, D, page, maxp;
  __device__ PagedKV kv(int b, int hk) const {
    const long long pos_stride = (long long)Hkv * D;
    return PagedKV{kp + (long long)hk * D, vp + (long long)hk * D,
                   bt + (long long)b * maxp, page, pos_stride, (long long)page * pos_stride};
  }
  __device__ int length(int b) const { return max(0, min(lengths[b], maxp * page)); }
};

// A contiguous (B, S, Hkv, D) cache, one length for every row.
struct ContigSource {
  const bf16* k;
  const bf16* v;
  int Hkv, D, S, len;
  __device__ ContigKV kv(int b, int hk) const {
    const long long o = ((long long)b * S * Hkv + hk) * D;
    return ContigKV{k + o, v + o, (long long)Hkv * D};
  }
  __device__ int length(int) const { return max(0, min(len, S)); }
};

// One split of one (KV head, slot): keys [s * split_keys, (s + 1) *
// split_keys) up to the slot's length, for each of its g query rows, into
// the workspace ws: [B][H][n_split] rows of D f32 sums, then
// [B][H][n_split] pairs (max, normalizer).  Grid (n_split, Hkv, B).
template <int D, int G, class Src>
__global__ void __launch_bounds__(THREADS)
split_kernel(const bf16* __restrict__ q, Src src, float* __restrict__ ws, int H,
             int split_keys, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, hk = blockIdx.y, b = blockIdx.z, g = H / src.Hkv;
  const int n_split = gridDim.x;
  const int k_lo = s * split_keys, k_hi = min(src.length(b), k_lo + split_keys);
  const long long row0 = (long long)b * H + hk * g;          // the group's first row
  const long long part = row0 * n_split + s;
  const long long n_part = (long long)gridDim.z * H * n_split;
  decode_split<D, G>(src.kv(b, hk), q + row0 * D, g, k_lo, k_hi, scale, ws + part * D,
                     (long long)n_split * D, ws + n_part * D + 2 * part, 2LL * n_split,
                     smem);
}

// Row (b, h) of the output from its splits that hold keys.  Grid (H, B).
template <int D, class Src>
__global__ void __launch_bounds__(D)
combine_kernel(const float* __restrict__ ws, Src src, bf16* __restrict__ out, int H,
               int n_split, int split_keys) {
  const int h = blockIdx.x, b = blockIdx.y;
  const long long row = (long long)b * H + h;
  const long long n_part = (long long)gridDim.y * H * n_split;
  combine<D>(ws + row * n_split * D, ws + n_part * D + 2 * row * n_split,
             (src.length(b) + split_keys - 1) / split_keys, out + row * D);
}

template <int D, int G, class Src>
int launch_g(const bf16* q, const Src& src, bf16* out, float* ws, int B, int H, int n_split,
             int split_keys, float scale, cudaStream_t s) {
  constexpr int smem = Layout<D>::BYTES;
  auto kernel = split_kernel<D, G, Src>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(n_split, src.Hkv, B), THREADS, smem, s>>>(q, src, ws, H, split_keys, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  combine_kernel<D, Src><<<dim3(H, B), D, 0, s>>>(ws, src, out, H, n_split, split_keys);
  return (int)cudaGetLastError();
}

// Split decode of every (slot, head) row: the split kernel, then the
// merge, on stream s.  G, the query rows a KV head, is rounded up to a
// power of two.  ws holds B * H * n_split * (D + 2) floats.
template <int D, class Src>
int launch(const bf16* q, const Src& src, bf16* out, float* ws, int B, int H, int n_split,
           int split_keys, float scale, cudaStream_t s) {
  const int g = H / src.Hkv;
  if (g <= 1) return launch_g<D, 1>(q, src, out, ws, B, H, n_split, split_keys, scale, s);
  if (g <= 2) return launch_g<D, 2>(q, src, out, ws, B, H, n_split, split_keys, scale, s);
  if (g <= 4) return launch_g<D, 4>(q, src, out, ws, B, H, n_split, split_keys, scale, s);
  if (g <= 8) return launch_g<D, 8>(q, src, out, ws, B, H, n_split, split_keys, scale, s);
  if (g <= 16) return launch_g<D, 16>(q, src, out, ws, B, H, n_split, split_keys, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace split

}  // namespace attn
}  // namespace repro
