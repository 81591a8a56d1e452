// Grouped expert GEMM: out[e] = a[e] @ b[e] for every expert e in one
// launch, a (E, M, K) and b (E, K, N) bf16 with any strides, f32
// accumulation on the tensor cores, out (E, M, N) bf16 and contiguous.
//
// Replaces: src/repro/kernels/moe_gemm/kernel.py, moe_gemm_kernel
// (pallas_call at :51).
//
// Bound on the H100, at granite-moe-1b-a400m's widths (E = 32 experts,
// D = 1024, F = 512; one launch per expert product):
//   decode, M = 8 rows (8 slots x capacity 1) - bytes: every expert's
//     (1024 x 512) weight is read once, 33.5 MB, ~0.010 ms at 3.35 TB/s;
//   legacy prefill, M = 160 (the capacity of a 512-token group) - bytes,
//     ~0.015 ms;
//   train, M = 5120 (4 groups x capacity 1280) - operations: 2 E M D F =
//     1.72e11 flops, ~0.174 ms at the bf16 tensor-core rate (its bytes,
//     0.54 GB, take ~0.160 ms: the two bounds nearly meet).
//
// Design: the Pallas grid (expert, token block, f block, d block) walked
// the d blocks in order with the sum in VMEM scratch and padded every
// ragged edge.  Here one block owns a BM x BN output tile of one expert,
// BM = 128 and BN = 256 where such blocks still fill 3/4 of the SMs, else
// 128 (grid: n tiles, m tiles, experts; the n tiles of one m tile run
// side by side and share its A rows in L2), and loops over K in steps of
// BK = 64, one 128-byte swizzled row of bf16 (wgmma.cuh's layout).  The
// block is three warpgroups.  The first is the producer: one thread
// keeps a ring of STAGES A and B tiles filled by the Tensor Memory
// Accelerator (TMA), each stage's copies completing on its "full"
// mbarrier.  The other two are consumers, 64 output rows each: they wait on a stage's
// full barrier, run its products as wgmma m64nBNk16 with both operands
// read from shared memory through descriptors and the f32 sums in
// registers, leave them in flight while waiting for the next stage, and
// hand a stage back on its "empty" barrier once its products are done.
// No block-wide barrier runs in the loop.  The sums stay in one block
// (no split-K), so the bits repeat.
//
// Operands come with their strides, so the backward's transposed views
// (dY W^T, X^T dY) need no copy, and nothing is transposed on the way:
//   K-major  - the depth is contiguous: a 3-D tensor map (depth, rows,
//              experts) copies 64 depths x BM or BN rows into a K-major
//              tile;
//   MN-major - the rows are contiguous: a map (rows, depth, experts)
//              copies 64 rows x 64 depths into each 64-row column block
//              of an MN-major tile, read by the product with its
//              transpose bit set;
//   element  - a view that TMA cannot take (an odd stride, a pointer off
//              16 bytes): the producer warpgroup stages it element by
//              element into the K-major tile, synchronously.
// Ragged M, N and K edges are filled with zeros by the TMA (out-of-range
// elements) or the element staging, so no padding lives in device
// memory.  The epilogue rounds each warp's 16 rows to bf16 through
// shared memory and writes them 16 bytes a lane, whole rows side by side,
// masking the ragged edges (stores straight from the registers, two
// columns a thread, made the train shape's forward 22% and its dX 39%
// slower on an H100: tools/moe_gemm_variants.py).
#include <cudaTypedefs.h>   // CUtensorMap, cuTensorMapEncodeTiled

#include "wgmma.cuh"

namespace repro {
namespace moe {

using namespace hopper;

constexpr int BM = 128;         // output rows a block: two consumer warpgroups of 64
constexpr int BK = 64;          // depth a step
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * WG_THREADS;   // the producer first
constexpr int STAGES = 4;

// shared memory: the ring's A and B tiles (BM and BN rows), then a full
// and an empty barrier a stage, in bytes
template <int BN>
constexpr int smem_bytes() {
  return STAGES * (BM + BN) * BK * 2 + 2 * STAGES * 8;
}

enum Mode { K_MAJOR = 0, MN_MAJOR = 1, ELEMENT = 2 };

// One operand seen as rows x depth: element (r, k) of expert e lies at
// p + e * s_e + r * s_r + k * s_k.  For a, rows are m; for b, rows are n.
struct Operand {
  const bf16* p;
  long long s_e, s_r, s_k;
  int mode;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// The calling thread arrives, and the phase also waits for `bytes` of
// copies to complete on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Arrive where pred holds (a predicate, not a branch: a branch around it
// would put the products in flight on a divergent path).
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_addr(bar)),
      "r"((int)pred)
      : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One TMA copy of a box of the map at coordinates (c0, c1, c2) into dst,
// completing on bar.
__device__ __forceinline__ void tma_load(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// Rows [r0, r0 + ROWS) x depths [k0, k0 + BK) of an element-mode operand
// into the K-major tile t, zeros outside [0, nr) x [0, K); the producer
// warpgroup's threads share it.
template <int ROWS>
__device__ __forceinline__ void stage_elements(bf16* t, const Operand& op, const bf16* p,
                                               int r0, int nr, int k0, int K) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < ROWS * BK; i += WG_THREADS) {
    const int r = i >> 6, c = i & 63, gr = r0 + r, gk = k0 + c;
    t[sw(r, c)] =
        gr < nr && gk < K ? p[(long long)gr * op.s_r + (long long)gk * op.s_k] : zero;
  }
}

// ROWS rows of a vector-mode operand's tile at depth k0: one TMA box
// (K-major) or one a 64-row column block (MN-major).
template <int ROWS, int MN>
__device__ __forceinline__ void tma_tile(bf16* t, const CUtensorMap* map, uint64_t* bar,
                                         int r0, int k0, int e) {
  if constexpr (MN) {
#pragma unroll
    for (int i = 0; i < ROWS / 64; ++i) tma_load(t + i * 64 * 64, map, bar, r0 + 64 * i, k0, e);
  } else {
    tma_load(t, map, bar, k0, r0, e);
  }
}

// BN output columns a block (128 or 256: one m64nBNk16 a consumer and
// depth step of 16); AMN, BMN: A, B staged MN-major (else K-major, by
// TMA or elements).  map_a and map_b are the operands' tensor maps
// (unused for an element-mode operand).
template <int BN, int AMN, int BMN>
__global__ void __launch_bounds__(THREADS, 1)
moe_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, Operand a, Operand b,
                bf16* __restrict__ out, int M, int N, int K) {
  constexpr int TA = BM * BK, TB = BN * BK;       // bf16 of a stage's tiles
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);   // [STAGES] A tiles
  bf16* sb = sa + STAGES * TA;                    // [STAGES] B tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + STAGES * TB);
  uint64_t* empty = full + STAGES;
  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wg = threadIdx.x / WG_THREADS;
  const int nk = (K + BK - 1) / BK;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);                     // the producer's arrival, and the bytes
      mbar_init(empty + s, CONSUMERS * 4);        // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    const bool ea = a.mode == ELEMENT, eb = b.mode == ELEMENT;
    if (!ea && !eb && threadIdx.x != 0) return;   // one thread issues the copies
    const int tx = (ea ? 0 : TA * 2) + (eb ? 0 : TB * 2);
    const bf16* pa = a.p + (long long)e * a.s_e;
    const bf16* pb = b.p + (long long)e * b.s_e;
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % STAGES, k0 = kt * BK;
      mbar_wait(empty + st, ((kt / STAGES) & 1) ^ 1);   // the first round passes
      if (ea || eb) {
        if (ea) stage_elements<BM>(sa + st * TA, a, pa, m0, M, k0, K);
        if (eb) stage_elements<BN>(sb + st * TB, b, pb, n0, N, k0, K);
        fence_async();
        asm volatile("bar.sync 1, %0;\n" ::"n"(WG_THREADS) : "memory");
      }
      if (threadIdx.x == 0) {
        if (tx) {
          mbar_expect_tx(full + st, tx);
        } else {
          mbar_arrive_if(full + st, true);
        }
        if (!ea) tma_tile<BM, AMN>(sa + st * TA, &map_a, full + st, m0, k0, e);
        if (!eb) tma_tile<BN, BMN>(sb + st * TB, &map_b, full + st, n0, k0, e);
      }
    }
    return;
  }

  const int cw = wg - 1;                          // this consumer's 64 rows
  const bool lead = (threadIdx.x & 31) == 0;
  float c[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) c[j][x] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES;
    mbar_wait(full + st, (kt / STAGES) & 1);
    const bf16* ta = sa + st * TA;
    const bf16* tb = sb + st * TB;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = AMN ? desc_mn(ta, kk, cw) : desc_k(ta + cw * 64 * 64, kk);
      const uint64_t db = BMN ? desc_mn(tb, kk, 0) : desc_k(tb, kk);
      if constexpr (BN == 256)
        wg_ss256<AMN, BMN>(c, da, db);
      else
        wg_ss128<AMN, BMN>(c, da, db);
    }
    wg_commit();
    wg_wait<1>();                                 // step kt - 1's products are done:
    mbar_arrive_if(empty + (kt + STAGES - 1) % STAGES, lead && kt > 0);   // its stage is free
  }
  wg_wait<0>();

  // The epilogue: each warp rounds its 16 rows to bf16 into shared memory
  // (the ring's, once every consumer is done with it; rows padded by 16
  // bytes so the fragment writes hit distinct banks), then writes them
  // back a 16-byte chunk a lane, each row's chunks side by side.
  asm volatile("bar.sync 2, %0;\n" ::"n"(CONSUMERS * WG_THREADS) : "memory");
  constexpr int LD = BN + 8, CHUNKS = BN / 8;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  bf16* so = reinterpret_cast<bf16*>(smem_raw) + (cw * 4 + warp) * 16 * LD;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    *reinterpret_cast<uint32_t*>(so + g * LD + 8 * j + 2 * t) = pack(c[j][0], c[j][1]);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * LD + 8 * j + 2 * t) = pack(c[j][2], c[j][3]);
  }
  __syncwarp();
  const int row0 = m0 + 64 * cw + 16 * warp;
  bf16* po = out + (long long)e * M * N;
  const bool vec = N % 8 == 0;
#pragma unroll 4
  for (int i = lane; i < 16 * CHUNKS; i += 32) {
    const int rr = i / CHUNKS, col = n0 + (i % CHUNKS) * 8, r = row0 + rr;
    if (r >= M || col >= N) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(so + rr * LD + (i % CHUNKS) * 8);
    bf16* dst = po + (long long)r * N + col;
    if (vec && col + 8 <= N) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int x = 0; x < 8; ++x)
        if (col + x < N) dst[x] = h[x];
    }
  }
}

// How an operand is staged: a tensor map along whichever of its depth
// and its rows is contiguous, when TMA can take it (a 16-byte aligned
// start, the other strides positive multiples of 16 bytes).
int mode_of(const void* p, long long s_e, long long s_r, long long s_k) {
  const bool aligned = (reinterpret_cast<uintptr_t>(p) % 16) == 0 && s_e % 8 == 0 && s_e >= 0;
  if (aligned && s_k == 1 && s_r % 8 == 0 && s_r > 0) return K_MAJOR;
  if (aligned && s_r == 1 && s_k % 8 == 0 && s_k > 0) return MN_MAJOR;
  return ELEMENT;
}

PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult q;
    void* f = nullptr;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                     &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (PFN_cuTensorMapEncodeTiled_v12000)f;
  }
  return fn;
}

// The tensor map of a vector-mode operand with `rows` rows over E
// experts, boxes of 64 x box_rows (K-major) or 64 x 64 (MN-major) in the
// 128-byte swizzle, out-of-range elements read as zeros.  Returns false
// where the driver refuses it.
bool make_map(CUtensorMap* map, const Operand& op, int E, int rows, int K, int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = encoder();
  if (fn == nullptr) return false;
  const bool mn = op.mode == MN_MAJOR;
  const long long outer = mn ? op.s_k : op.s_r;
  const cuuint64_t dims[3] = {(cuuint64_t)(mn ? rows : K), (cuuint64_t)(mn ? K : rows),
                              (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)outer * 2, (cuuint64_t)op.s_e * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)(mn ? 64 : box_rows), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(op.p), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <int BN, int AMN, int BMN>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, const Operand& a, const Operand& b,
           bf16* out, int E, int M, int N, int K, cudaStream_t s) {
  auto kernel = moe_gemm_kernel<BN, AMN, BMN>;
  constexpr int smem = smem_bytes<BN>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  kernel<<<grid, THREADS, smem, s>>>(ma, mb, a, b, out, M, N, K);
  return (int)cudaGetLastError();
}

// The operands' maps (an operand the driver refuses is staged element by
// element instead), then the instantiation for their layouts.
template <int BN>
int launch_modes(Operand a, Operand b, bf16* out, int E, int M, int N, int K,
                 cudaStream_t s) {
  CUtensorMap ma{}, mb{};
  if (K == 0) {
    a.mode = b.mode = ELEMENT;                    // no copies at all
  } else {
    if (a.mode != ELEMENT && !make_map(&ma, a, E, M, K, BM)) a.mode = ELEMENT;
    if (b.mode != ELEMENT && !make_map(&mb, b, E, N, K, BN)) b.mode = ELEMENT;
  }
  const bool amn = a.mode == MN_MAJOR, bmn = b.mode == MN_MAJOR;
  if (amn && bmn) return launch<BN, 1, 1>(ma, mb, a, b, out, E, M, N, K, s);
  if (amn) return launch<BN, 1, 0>(ma, mb, a, b, out, E, M, N, K, s);
  if (bmn) return launch<BN, 0, 1>(ma, mb, a, b, out, E, M, N, K, s);
  return launch<BN, 0, 0>(ma, mb, a, b, out, E, M, N, K, s);
}

// 256 output columns a block where such blocks still fill 3/4 of the SMs
// (each then reads a third fewer bytes a flop), else 128 (more blocks
// stream the weights when few rows need them).
bool wide_tiles(int E, int M, int N) {
  const long long tiles = (long long)E * ((M + BM - 1) / BM) * ((N + 255) / 256);
  return N > 128 && 4 * tiles >= 3LL * sm_count();
}

}  // namespace moe
}  // namespace repro

// a (E, M, K) with strides (a_se, a_sm, a_sk); b (E, K, N) with strides
// (b_se, b_sk, b_sn); out (E, M, N) contiguous.
extern "C" int moe_gemm_bf16(const void* a, const void* b, void* out, int E, int M, int N,
                             int K, long long a_se, long long a_sm, long long a_sk,
                             long long b_se, long long b_sk, long long b_sn,
                             void* stream) {
  using namespace repro;
  using namespace repro::moe;
  if (E < 0 || M < 0 || N < 0 || K < 0 || E > 65535 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (E == 0 || M == 0 || N == 0) return (int)cudaGetLastError();
  const Operand oa{(const bf16*)a, a_se, a_sm, a_sk, mode_of(a, a_se, a_sm, a_sk)};
  const Operand ob{(const bf16*)b, b_se, b_sn, b_sk, mode_of(b, b_se, b_sn, b_sk)};
  bf16* o = (bf16*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (wide_tiles(E, M, N)) return launch_modes<256>(oa, ob, o, E, M, N, K, s);
  return launch_modes<128>(oa, ob, o, E, M, N, K, s);
}
