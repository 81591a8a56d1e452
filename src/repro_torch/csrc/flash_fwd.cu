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
// result is the same to the bit from run to run.  The block's work is
// flash_fwd.cuh's attend_rows, which paged chunk prefill shares
// (paged_attention.cu); here its rows are one query head's (HeadRows)
// and its keys a contiguous K and V (ContigKeys).  A block is WGS
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
#include "flash_fwd.cuh"

namespace repro {
namespace ffwd {

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

template <int D, int WGS, int MIN_BLOCKS, int KT>
__global__ void __launch_bounds__(WG_THREADS * WGS, MIN_BLOCKS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Skv, int H, int Hkv,
                 int causal, int q_offset, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const long long ks = (long long)Hkv * D;
  const long long ko = (long long)b * Skv * ks + (long long)hk * D;
  const HeadRows<D> rows{q, out, lse, (long long)H * D, Sq, H, b, h, q_offset, causal};
  const ContigKeys keys{k + ko, v + ko, ks, Skv};
  // the last query tiles see the most keys: schedule them first
  attend_rows<D, WGS, KT>(rows, keys, gridDim.x - 1 - blockIdx.x, scale, smem_raw);
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
