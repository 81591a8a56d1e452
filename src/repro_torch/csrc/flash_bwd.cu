// Causal or full GQA attention backward from the saved log-sum-exp:
// dq (one kernel) and dk, dv (a second kernel), in bf16 from bf16 q, k,
// v, dO and f32 lse and delta = rowsum(out * dO) (computed by the
// wrapper, as the JAX package computes it outside its pallas_calls).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, flash_bwd
// (_dq_kernel, pallas_call at :278; _dkv_kernel, pallas_call at :306).
//
// Bound on the H100: at yi-6b's training shape (4096 tokens, 32 query
// heads over 4 KV heads of 128) the two kernels do five S x S x D
// products per head (s and dp in each kernel, then dq, dk and dv),
// halved by the causal mask: about 3.4e11 flops per batch row against
// 0.2 GB of inputs and outputs, so the least time is set by the bf16
// tensor-core rate.  These first kernels do their arithmetic on the f32
// CUDA cores and make no attempt at that bound (wgmma and TMA are later
// work).
//
// Design: the TPU grids walked one sequential axis with the sums in
// VMEM scratch (the kv axis for dq, the q axis for dk/dv).  On Hopper
// blocks run in no order, so each sequential axis becomes a loop inside
// one block that owns its output rows:
//   dq:  one block per (query tile of 64 rows, query head, batch row);
//        it walks the key tiles up to the causal limit.  Query head h
//        reads KV head h / g.
//   dkv: one block per (key tile of 64 keys, KV head, batch row); it
//        walks the g query heads of its KV head and, for each, the
//        query tiles that can see its keys.  Each block owns its dk and
//        dv rows in registers, so there are no atomics, the result is
//        deterministic and GQA needs no KV repeat.
// Each (64 x 64) tile step stages its operands in shared memory as f32
// (rows padded to D + 1 floats, so the 16 lanes that read one column of
// 16 rows hit 16 banks); 256 threads each own a 4 x 4 patch of the
// score tile (rows ty + 16 i, keys tx + 16 j) and then a 4 x D/16 patch
// of the output tile.  p and ds stay f32, as in the Pallas kernels.
// Masks are those of the Pallas kernels: kpos < Skv, qraw < Sq and,
// when causal, kpos <= qraw + q_offset.  Outside the first two p = 0;
// a score hidden by the causal mask is -1e30, as in the plain version,
// so p = exp(-1e30 - lse), which is 0 unless the row sees no key at all
// (causal with q_offset < 0).  Such a row's lse is -1e30 (flash_fwd gives
// it the mean of V) and its p is 1 on every key, as in the plain
// version's backward; the loops then take in every key for it.  On the
// served and trained paths (q_offset = 0) every row sees key 0 and the
// result does not change by a bit.
#include "common.cuh"

namespace repro {
namespace fbwd {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16: (ty, tx)
constexpr float NEG_INF = -1e30f;

template <int D>
struct DqSmem {
  float q[BQ][D + 1];
  float dO[BQ][D + 1];
  float k[BK][D + 1];
  float v[BK][D + 1];
  float ds[BQ][BK + 1];
  float lse[BQ];
  float delta[BQ];
};

template <int D>
struct DkvSmem {
  float k[BK][D + 1];
  float v[BK][D + 1];
  float q[BQ][D + 1];
  float dO[BQ][D + 1];
  float p[BQ][BK + 1];
  float ds[BQ][BK + 1];
  float lse[BQ];
  float delta[BQ];
};

// Rows [r0, r0 + R) of a bf16 tensor whose row r starts at
// base + r * stride, as f32; rows at or past n load as zeros.
template <int D, int R>
__device__ __forceinline__ void load_rows(float (*dst)[D + 1], const bf16* base,
                                          long long stride, int r0, int n) {
  constexpr int VPR = D / 8;    // 16-byte vectors per row
  for (int vi = threadIdx.x; vi < R * VPR; vi += THREADS) {
    const int r = vi / VPR, c = (vi % VPR) * 8;
    float f[8];
    if (r0 + r < n) {
      unpack8(*reinterpret_cast<const uint4*>(base + (long long)(r0 + r) * stride + c), f);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[r][c + e] = f[e];
  }
}

// lse and delta of query rows [r0, r0 + BQ) of head h ((B, Sq, H) f32,
// already offset to batch row b); rows past Sq load as zeros.
__device__ __forceinline__ void load_stats(float* lse_s, float* delta_s,
                                           const float* lse, const float* delta,
                                           int r0, int Sq, int H, int h) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const bool in = r0 + r < Sq;
    const long long o = (long long)(r0 + r) * H + h;
    lse_s[r] = in ? lse[o] : 0.f;
    delta_s[r] = in ? delta[o] : 0.f;
  }
}

// p and ds of this thread's 4 x 4 patch of the (query tile q0, key tile
// k0) score tile: s = q k^T * scale, dp = dO v^T, p = exp(s - lse),
// ds = p (dp - delta) scale.
template <int D>
__device__ __forceinline__ void tile_p_ds(const float (*q)[D + 1], const float (*dO)[D + 1],
                                          const float (*k)[D + 1], const float (*v)[D + 1],
                                          const float* lse, const float* delta,
                                          int q0, int k0, int Sq, int Skv, int causal,
                                          int q_offset, float scale,
                                          float (&p)[4][4], float (&ds)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = q[ty + 16 * i][d];
      oa[i] = dO[ty + 16 * i][d];
      kb[i] = k[tx + 16 * i][d];
      vb[i] = v[tx + 16 * i][d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qraw = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      // two exps, not one exp of a selected score: selecting s * scale
      // first would round it before the subtraction that it otherwise
      // fuses into, and move a seen key's p by an ulp
      const bool seen = !causal || kpos <= qraw + q_offset;
      p[i][j] = kpos < Skv && qraw < Sq
                    ? (seen ? expf(s[i][j] * scale - lse[r]) : expf(NEG_INF - lse[r]))
                    : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - delta[r]) * scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int Sq, int Skv, int H, int Hkv,
                    int causal, int q_offset, float scale) {
  extern __shared__ float4 smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(smem_raw);
  constexpr int NC = D / 16;    // output columns per thread
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  // the last query tiles see the most keys: schedule them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);

  const long long qs = (long long)H * D, ks = (long long)Hkv * D;
  const bf16* qb = q + (long long)b * Sq * qs + (long long)h * D;
  const bf16* ob = dout + (long long)b * Sq * qs + (long long)h * D;
  const bf16* kb = k + (long long)b * Skv * ks + (long long)hk * D;
  const bf16* vb = v + (long long)b * Skv * ks + (long long)hk * D;
  load_rows<D, BQ>(sm.q, qb, qs, q0, Sq);
  load_rows<D, BQ>(sm.dO, ob, qs, q0, Sq);
  load_stats(sm.lse, sm.delta, lse + (long long)b * Sq * H,
             delta + (long long)b * Sq * H, q0, Sq, H, h);

  // a tile whose first row sees no key takes in every key (see above)
  int kv_end = Skv;
  if (causal && q0 + q_offset >= 0)
    kv_end = max(0, min(Skv, min(q0 + BQ, Sq) - 1 + q_offset + 1));

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();            // the previous tile's k, v and ds are consumed
    load_rows<D, BK>(sm.k, kb, ks, k0, Skv);
    load_rows<D, BK>(sm.v, vb, ks, k0, Skv);
    __syncthreads();
    float p[4][4], ds[4][4];
    tile_p_ds<D>(sm.q, sm.dO, sm.k, sm.v, sm.lse, sm.delta, q0, k0, Sq, Skv,
                 causal, q_offset, scale, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sm.ds[ty + 16 * i][tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dq[r][c] += sum_j ds[r][j] k[j][c]
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float kv[NC], dsv[4];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = sm.k[j][tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sm.ds[ty + 16 * i][j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qraw = q0 + ty + 16 * i;
    if (qraw < Sq) {
      bf16* row = dq + ((long long)b * Sq + qraw) * qs + (long long)h * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) row[tx + 16 * c] = __float2bfloat16(acc[i][c]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv,
                     int H, int Hkv, int causal, int q_offset, float scale) {
  extern __shared__ float4 smem_raw[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(smem_raw);
  constexpr int NC = D / 16;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  // the first key tiles are seen by the most queries: blocks are handed
  // out in index order, so they come first
  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y, b = blockIdx.z, g = H / Hkv;

  const long long qs = (long long)H * D, ks = (long long)Hkv * D;
  const long long kv_off = (long long)b * Skv * ks + (long long)hk * D;
  load_rows<D, BK>(sm.k, k + kv_off, ks, k0, Skv);
  load_rows<D, BK>(sm.v, v + kv_off, ks, k0, Skv);

  // the first query tile with a row that can see key k0; with q_offset
  // < 0 the first rows see no key and take in every key (see above)
  const int q_start = causal && q_offset >= 0 ? max(0, k0 - q_offset) / BQ * BQ : 0;

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int j = 0; j < g; ++j) {
    const int h = hk * g + j;
    const bf16* qb = q + (long long)b * Sq * qs + (long long)h * D;
    const bf16* ob = dout + (long long)b * Sq * qs + (long long)h * D;
    for (int q0 = q_start; q0 < Sq; q0 += BQ) {
      __syncthreads();          // the previous tile's q, dO, p and ds are consumed
      load_rows<D, BQ>(sm.q, qb, qs, q0, Sq);
      load_rows<D, BQ>(sm.dO, ob, qs, q0, Sq);
      load_stats(sm.lse, sm.delta, lse + (long long)b * Sq * H,
                 delta + (long long)b * Sq * H, q0, Sq, H, h);
      __syncthreads();
      float p[4][4], ds[4][4];
      tile_p_ds<D>(sm.q, sm.dO, sm.k, sm.v, sm.lse, sm.delta, q0, k0, Sq, Skv,
                   causal, q_offset, scale, p, ds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          sm.p[ty + 16 * i][tx + 16 * jj] = p[i][jj];
          sm.ds[ty + 16 * i][tx + 16 * jj] = ds[i][jj];
        }
      __syncthreads();
      // key row kr = ty + 16 i:  dv[kr] += sum_r p[r][kr] dO[r],
      //                          dk[kr] += sum_r ds[r][kr] q[r]
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[4], dsv[4], ov[NC], qv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = sm.p[r][ty + 16 * i];
          dsv[i] = sm.ds[r][ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          ov[c] = sm.dO[r][tx + 16 * c];
          qv[c] = sm.q[r][tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv_acc[i][c] = fmaf(pv[i], ov[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(dsv[i], qv[c], dk_acc[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos < Skv) {
      const long long o = kv_off + (long long)kpos * ks;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        dk[o + tx + 16 * c] = __float2bfloat16(dk_acc[i][c]);
        dv[o + tx + 16 * c] = __float2bfloat16(dv_acc[i][c]);
      }
    }
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Sq, int Skv,
              int H, int Hkv, int causal, int q_offset, float scale, cudaStream_t s) {
  const int smem = (int)sizeof(DqSmem<D>);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
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
  const int smem = (int)sizeof(DkvSmem<D>);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Skv + BK - 1) / BK, Hkv, B);
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
