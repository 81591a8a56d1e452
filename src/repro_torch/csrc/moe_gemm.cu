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
//     1.72e11 flops, ~0.174 ms at the bf16 tensor-core rate.
//
// Design: the Pallas grid (expert, token block, f block, d block) walked
// the d blocks in order with the sum in VMEM scratch and padded every
// ragged edge.  Here one block owns a 64 x 64 output tile of one expert
// (grid: n tiles, m tiles, experts) and loops over K in steps of 32:
// it stages a 64 x 32 tile of each operand in shared memory as bf16,
// depth-contiguous, then its 4 warps (2 x 2, a 32 x 32 patch each) run
// mma.sync m16n8k16 (bf16 in, f32 sums in registers), reading their
// fragments straight from the staged rows.  Rows are padded to 40 bf16,
// so the 32 lanes of a fragment read hit 32 banks.  No padding in device
// memory: the staging masks the ragged edges of M, N and K with zeros,
// and the epilogue masks its stores.  The operands come with their
// strides, so the backward's transposed views (dY W^T, X^T dY) need no
// copy: an operand whose depth is contiguous loads 8 depths per 16-byte
// load, one whose rows are contiguous loads 8 rows per 16-byte load and
// writes them down a column of the tile (a warp covers 32 depths, so
// its 2-byte stores hit distinct banks), anything else loads element by
// element.  This first kernel has no multi-stage pipeline; wgmma and TMA
// are later work.
#include "common.cuh"

namespace repro {
namespace moe {

constexpr int BM = 64;          // output rows per block
constexpr int BN = 64;          // output columns per block
constexpr int BK = 32;          // depth per staged tile
constexpr int LDS = BK + 8;     // bf16 per staged row (80 bytes)
constexpr int THREADS = 128;    // 4 warps, 2 x 2

enum Mode { VEC_K = 0, VEC_R = 1, ANY = 2 };

// One operand seen as rows x depth: element (r, k) of expert e lies at
// p + e * s_e + r * s_r + k * s_k.  For a, rows are m; for b, rows are n.
struct Operand {
  const bf16* p;
  long long s_e, s_r, s_k;
  int mode;
};

// Stage rows [r0, r0 + R) and depths [k0, k0 + BK) of one expert's
// operand into s (depth contiguous); zeros outside [0, nr) x [0, nk).
template <int R>
__device__ __forceinline__ void stage(bf16 (*s)[LDS], const Operand& op, const bf16* base,
                                      int r0, int k0, int nr, int nk) {
  const bf16 zero = __float2bfloat16(0.f);
  if (op.mode == VEC_K) {
    for (int i = threadIdx.x; i < R * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int gr = r0 + r, gk = k0 + c;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (gr < nr) {
        const bf16* src = base + (long long)gr * op.s_r + gk;
        if (gk + 8 <= nk) {
          u = *reinterpret_cast<const uint4*>(src);
        } else {
          bf16* h = reinterpret_cast<bf16*>(&u);
#pragma unroll
          for (int e = 0; e < 8; ++e) h[e] = gk + e < nk ? src[e] : zero;
        }
      }
      *reinterpret_cast<uint4*>(&s[r][c]) = u;
    }
  } else if (op.mode == VEC_R) {
    // a warp takes 8 rows at 32 depths: its stores fill one bank each
    for (int i = threadIdx.x; i < (R / 8) * BK; i += THREADS) {
      const int c = i % BK, r = (i / BK) * 8;
      const int gr = r0 + r, gk = k0 + c;
      uint4 u = make_uint4(0, 0, 0, 0);
      bf16* h = reinterpret_cast<bf16*>(&u);
      if (gk < nk) {
        const bf16* src = base + (long long)gk * op.s_k + gr;
        if (gr + 8 <= nr) {
          u = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) h[e] = gr + e < nr ? src[e] : zero;
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) s[r + e][c] = h[e];
    }
  } else {
    for (int i = threadIdx.x; i < R * BK; i += THREADS) {
      const int r = i / BK, c = i % BK, gr = r0 + r, gk = k0 + c;
      s[r][c] = gr < nr && gk < nk ? base[(long long)gr * op.s_r + (long long)gk * op.s_k]
                                   : zero;
    }
  }
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

// Two adjacent outputs of row r, columns c and c + 1, into (M, N) bf16.
__device__ __forceinline__ void store2(bf16* out, int M, int N, int r, int c, float x,
                                       float y) {
  if (r >= M) return;
  bf16* p = out + (long long)r * N + c;
  if ((N & 1) == 0 && c + 1 < N) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  } else {
    if (c < N) p[0] = __float2bfloat16(x);
    if (c + 1 < N) p[1] = __float2bfloat16(y);
  }
}

__global__ void __launch_bounds__(THREADS)
moe_gemm_kernel(Operand a, Operand b, bf16* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) bf16 sa[BM][LDS];
  __shared__ __align__(16) bf16 sb[BN][LDS];
  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;       // mma fragment row group, pair
  const bf16* pa = a.p + (long long)e * a.s_e;
  const bf16* pb = b.p + (long long)e * b.s_e;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[i][j][x] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage<BM>(sa, a, pa, m0, k0, M, K);
    stage<BN>(sb, b, pb, n0, k0, N, K);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t fa[2][4], fb[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + 16 * i + g;
        fa[i][0] = ld32(&sa[r][kk + 2 * t]);
        fa[i][1] = ld32(&sa[r + 8][kk + 2 * t]);
        fa[i][2] = ld32(&sa[r][kk + 2 * t + 8]);
        fa[i][3] = ld32(&sa[r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + 8 * j + g;
        fb[j][0] = ld32(&sb[c][kk + 2 * t]);
        fb[j][1] = ld32(&sb[c][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma16816(acc[i][j], fa[i], fb[j]);
    }
    __syncthreads();            // the staged tiles are consumed
  }

  bf16* po = out + (long long)e * M * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + wm + 16 * i + g, c = n0 + wn + 8 * j + 2 * t;
      store2(po, M, N, r, c, acc[i][j][0], acc[i][j][1]);
      store2(po, M, N, r + 8, c, acc[i][j][2], acc[i][j][3]);
    }
}

// How an operand is staged: 16-byte loads along whichever of its depth
// and its rows is contiguous, when every 8-element run stays aligned.
int mode_of(const void* p, long long s_e, long long s_r, long long s_k) {
  const bool aligned = (reinterpret_cast<uintptr_t>(p) % 16) == 0 && s_e % 8 == 0;
  if (aligned && s_k == 1 && s_r % 8 == 0) return VEC_K;
  if (aligned && s_r == 1 && s_k % 8 == 0) return VEC_R;
  return ANY;
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
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  moe_gemm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(oa, ob, (bf16*)out, M, N, K);
  return (int)cudaGetLastError();
}
