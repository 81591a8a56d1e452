// Causal or full GQA attention forward with online softmax: out (bf16)
// and the log-sum-exp of each row (f32).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, flash_fwd (the
// Pallas forward, pallas_call at :107).
//
// Bound on the H100: on the main path (a 512-token causal prompt, 32
// heads of 128) the work is 4 * Sq * Skv * H * D / 2 flops, about 2.1
// GFLOP, against 4 MB of q, k, v and out: ~500 flops/byte, so the least
// time is set by the bf16 tensor-core rate (989 TFLOP/s).  This first
// kernel does its arithmetic on the f32 CUDA cores and makes no attempt
// at that bound (wgmma and TMA are later work).
//
// Design: the TPU grid (batch, head, q-block, kv-block) walked the kv
// blocks in order with the running max, normalizer and accumulator in
// VMEM scratch.  On Hopper blocks run in no order, so the kv axis becomes
// a loop inside the block (attention.cuh): grid (q tiles of 16 rows,
// head, batch), one warp per 4 query rows, K/V tiles of 32 keys staged in
// shared memory.  Query head h reads KV head h / (H / Hkv) directly (no
// KV repeat).  Under the causal mask the loop stops after the last key
// any row of the tile can see (q_offset included), so tiles wholly above
// the diagonal are never loaded; keys past Skv are never read.  A row
// that sees no key (causal, i + q_offset < 0) gets the plain version's
// answer, the mean of V (attend_unseen); on the served and trained
// paths every row sees key 0 and that pass changes nothing.
#include "attention.cuh"

namespace repro {

template <int D>
__global__ void __launch_bounds__(attn::MAX_WARPS * 32)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Skv, int H, int Hkv,
                 int causal, int q_offset, float scale) {
  using namespace attn;
  __shared__ Smem<D> sm;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5;

  const ContigKV kv{k + ((long long)b * Skv * Hkv + hk) * D,
                    v + ((long long)b * Skv * Hkv + hk) * D,
                    (long long)Hkv * D};
  int kv_end = Skv;
  if (causal) {
    const int last = min(q0 + ROWS, Sq) - 1;       // last query row of the tile
    kv_end = max(0, min(Skv, last + q_offset + 1));
  }

  Rows<D> st;
  const bf16* qrow[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int i = q0 + warp * RW + r;
    const bool active = i < Sq;
    qrow[r] = active ? q + (((long long)b * Sq + i) * H + h) * D : nullptr;
    st.limit[r] = !active ? -1 : (causal ? i + q_offset : 0x7fffffff);
  }
  load_q<D>(sm, qrow);
  attend<D>(sm, kv, kv_end, scale, st);
  bool empty[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) empty[r] = qrow[r] != nullptr && st.m[r] == NEG_INF;
  attend_unseen<D>(sm, kv, Skv, empty, st);
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int i = q0 + warp * RW + r;
    if (i < Sq) {
      const long long row = ((long long)b * Sq + i) * H + h;
      store_row<D>(st, r, out + row * D, lse + row);
    }
  }
}

}  // namespace repro

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* out, void* lse, int B, int Sq, int Skv,
                              int H, int Hkv, int D, int causal, int q_offset,
                              float scale, void* stream) {
  using namespace repro;
  if (B <= 0 || Sq <= 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || H % Hkv != 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Sq + attn::ROWS - 1) / attn::ROWS, H, B);
  const dim3 block(attn::MAX_WARPS * 32);
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 128)
    flash_fwd_kernel<128><<<grid, block, 0, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, (float*)lse,
        Sq, Skv, H, Hkv, causal, q_offset, scale);
  else if (D == 64)
    flash_fwd_kernel<64><<<grid, block, 0, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, (float*)lse,
        Sq, Skv, H, Hkv, causal, q_offset, scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
