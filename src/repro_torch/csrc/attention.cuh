// The online-softmax core shared by the port's decode and paged
// attention kernels (paged_attention.cu, decode_attention.cu).
//
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

#include "common.cuh"

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

}  // namespace attn
}  // namespace repro
