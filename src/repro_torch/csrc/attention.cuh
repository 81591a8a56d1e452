// The split-key core of the port's decode kernels (paged_attention.cu's
// paged decode, decode_attention.cu): split:: cuts one query row group's
// keys into splits that run in separate blocks and merges them, one
// kernel behind either KV addresser.  Where a key lives is the caller's
// affair: a KV addresser maps a key position to its element offset, which
// is how one core serves both a contiguous cache and a page pool behind a
// block table.
#pragma once

#include "wgmma.cuh"

namespace repro {
namespace attn {

constexpr float NEG_INF = -1e30f;

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
// cores, each lane owning D / 32 output columns of every row: adjacent
// ones where they make one 2- or 4-byte load; at head dim 160 (5
// columns, 10 bytes, which no aligned load takes) columns lane, lane +
// 32, ..., lane + 128, a 2-byte load each with neighbouring lanes on
// neighbouring columns; at head dims 16 and 8, one column on each of
// lanes 0..D-1 (the other lanes read column 0, hold garbage and store
// nothing).  A head dim
// below 16 (8) takes one 16-deep step with the q fragment's depth 8..15
// zero and the K fragment's too: the mma's depth is 16.
// The warps' partials merge in shared memory by their maxima, and the
// block writes its split's partial: the f32 sums (D a row), the max and
// the normalizer.  `combine` then merges a row's splits in split order.
// Scores are masked as the reference masks them (-1e30, and p = 0).
// ---------------------------------------------------------------------------
namespace split {

constexpr int CK = 16;            // keys a chunk
constexpr int MAX_G = 16;         // query rows a KV head: one m16n8k16 A operand
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int PS = CK + 4;        // floats a row of a warp's p tile; column CK holds alpha

template <int D>
struct Layout {
  // bf16 a staged key row: a multiple of 8 (16-byte copies stay aligned
  // at every head dim, 8 and 16 too) that is not one of 64 (the 8 rows of
  // a fragment read fall in distinct banks at D = 32, 64, 128 and 160)
  static constexpr int KROW = D + 8;
  static constexpr int STAGE = 2 * CK * KROW;       // a chunk's K then V
  static constexpr int WARP = 2 * STAGE;            // two stages a warp
  static constexpr int P = 16 * PS;                 // a warp's p tile, f32
  static constexpr int BYTES = WARPS * (WARP * 2 + P * 4);
};

// Output column c < NC of a lane: lane * NC + c; at D = 160 (NC = 5)
// lane + 32 c; at a head dim below 32 column `lane` for lanes 0..D-1 and
// column 0 (read, never stored) for the rest.  A function of the lane
// taken where it is used, so at D = 32..128 the code is the same as
// before the other head dims came.
template <int D, int NC>
__device__ __forceinline__ int lane_col(int lane, int c) {
  if constexpr (D < 32) return lane < D ? lane : 0;
  else if constexpr (NC == 5) return lane + 32 * c;
  else return lane * NC + c;
}

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

// A lane's NC columns of the bf16 row (lane_col: 8, 4 or 2 aligned
// bytes, one value, or at D = 160 five values 32 apart) to f32.
template <int D, int NC>
__device__ __forceinline__ void load_cols(const bf16* row, int lane, float (&v)[NC]) {
  const bf16* p = row + lane_col<D, NC>(lane, 0);
  if constexpr (NC == 5) {
#pragma unroll
    for (int c = 0; c < NC; ++c) v[c] = __bfloat162float(p[32 * c]);
  } else if constexpr (NC == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else if constexpr (NC == 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x; v[1] = f.y;
  } else {
    static_assert(NC == 1, "head dim 8, 16, 32, 64, 128 or 160");
    v[0] = __bfloat162float(*p);
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
  constexpr int NC = D >= 32 ? D / 32 : 1;   // output columns a lane
  constexpr int VPR = D / 8;      // 16-byte copies a key row
  constexpr int COPIES = CK * VPR;            // ... a chunk's K (and its V)
  constexpr int KQ = (D + 15) / 16;           // 16-deep steps of q k^T
  // columns c + 8, c + 9 of a fragment exist: at D = 8 (the one head dim
  // not a multiple of 16) no lane's do, and the fragment's upper half is 0
  constexpr bool HI = D % 16 == 0;
  static_assert(G >= 1 && G <= MAX_G, "at most 16 query rows a KV head");
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

  uint32_t qa[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    const int c = 16 * kk + 2 * t;
    qa[kk][0] = gq < g ? ld32(q + gq * D + c) : 0u;
    qa[kk][1] = gq + 8 < g ? ld32(q + (gq + 8) * D + c) : 0u;
    qa[kk][2] = HI && gq < g ? ld32(q + gq * D + c + 8) : 0u;
    qa[kk][3] = HI && gq + 8 < g ? ld32(q + (gq + 8) * D + c + 8) : 0u;
  }

  const int nchunk = (k_hi - k_lo + CK - 1) / CK;
  // chunk c's keys into stage st of this warp's ring; past k_hi, zeros
  auto load = [&](int st, int c) {
    bf16* sk = ring + st * L::STAGE;
    bf16* sv = sk + CK * L::KROW;
    const int base = k_lo + c * CK;
#pragma unroll
    for (int u = 0; u < (COPIES + 31) / 32; ++u) {
      const int i = lane + 32 * u, j = i / VPR, col = (i % VPR) * 8, pos = base + j;
      if (COPIES % 32 != 0 && i >= COPIES) break;   // D = 8: 16 copies a chunk
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
    for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bf16* kr = sk + (8 * j + gq) * L::KROW + 16 * kk + 2 * t;
        const uint32_t b[2] = {ld32(kr), HI ? ld32(kr + 8) : 0u};
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
    // unrolled whole at D >= 32; below it one key pair an iteration
    // (unrolled, the G = 16 contiguous-cache instances spill).  Whole,
    // ptxas spills 4 B in paged split_kernel<64,8>, at no measured cost;
    // four pairs an iteration drop that spill but spill 24 B in
    // split_kernel<32,16> (tools/paged_decode_variants.py, PERF.md)
#pragma unroll (D >= 32 ? CK / 2 : 1)
    for (int k2 = 0; k2 < CK / 2; ++k2) {
      float v[2][NC];
      load_cols<D, NC>(sv + (2 * k2) * L::KROW, lane, v[0]);
      load_cols<D, NC>(sv + (2 * k2 + 1) * L::KROW, lane, v[1]);
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
  if (D >= 32 || lane < D) {
#pragma unroll
    for (int r = 0; r < G; ++r)
#pragma unroll
      for (int c2 = 0; c2 < NC; ++c2)
        wo[(warp * G + r) * D + lane_col<D, NC>(lane, c2)] = o[r][c2];
  }
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
  if (g <= MAX_G)
    return launch_g<D, MAX_G>(q, src, out, ws, B, H, n_split, split_keys, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace split

}  // namespace attn
}  // namespace repro
