// Hopper building blocks shared by the port's tensor-core kernels (the
// attention forward of flash_fwd.cuh, flash_bwd.cu, moe_gemm.cu):
// asynchronous copies into shared memory, bf16 tiles in the 128-byte
// swizzle, wgmma descriptors, and m64n64k16, m64n128k16 and m64n256k16
// products by one warpgroup with f32 sums in registers.
//
// A warpgroup is 4 warps that issue each wgmma together.  Its product
// is 64 rows x 64 columns; warp w of the warpgroup holds rows
// 16 w..16 w + 15 (see WG_C32).  Each batch of products is committed and
// waited for (wg_commit_wait) before other instructions touch its
// registers: ptxas serializes every wgmma otherwise (its C7515 and C7511
// notes in the -Xptxas -v log).
#pragma once

#include "common.cuh"

namespace repro {
namespace hopper {

constexpr int WG_THREADS = 128;   // one warpgroup

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copies into shared memory; !valid fills with zeros.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This thread's copies have landed and are visible to the tensor cores'
// reads (the async proxy); a barrier after it makes everyone's so.
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// All but this thread's N latest groups of copies have landed.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Writes to shared memory by this thread's copies or stores are visible
// to the tensor cores' reads (the async proxy) after a barrier.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// A tile of 64 rows x D bf16 in shared memory is stored in the tensor
// cores' 128-byte swizzle: column block c / 64 holds 64 rows of 128
// bytes, and row r keeps its 16-byte chunk j at chunk j ^ (r % 8), so the
// 8 rows of any 8 x 8 block (one 16-byte read each) fall in distinct
// banks.  Element (r, c) is at sw(r, c).
//
// A head dim D below 64 (32, 16, 8: rows of 64, 32, 16 bytes) takes one
// whole column block: the copies below fill its columns D..63 with zeros,
// a product over the depth D reads columns 0..D-1 only (depth 16 at D =
// 8, whose columns 8..15 are zeros), and a product whose N is
// the tile's width (p v, ds k) runs at N = 64 with columns D..63 of its
// sums zero, which the stores drop.  For D a multiple of 64 every test
// of c < D below folds away at compile time.
template <int D>
__host__ __device__ constexpr int col_blocks() {
  return (D + 63) / 64;
}
template <int D>
__host__ __device__ constexpr int tile_elems() {
  return 64 * 64 * col_blocks<D>();
}
__device__ __forceinline__ int sw(int r, int c) {
  return (c >> 6) * (64 * 64) + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// Rows [r0, r0 + 64) of a bf16 matrix whose row r starts at base + r *
// stride into the tile s; rows at or past n fill with zeros.  Eight
// threads copy a row's 128 bytes of one column block, 16 each, so a warp
// reads 4 rows' 128 bytes and writes 512 contiguous bytes.
// NT threads of the block (all of it) share the copies.
template <int D, int NT = WG_THREADS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* base, long long stride,
                                          int r0, int n) {
  for (int i = threadIdx.x; i < tile_elems<D>() / 8; i += NT) {
    const int cb = i / (64 * 8), r = (i / 8) % 64, c = cb * 64 + (i % 8) * 8;
    const bool in = r0 + r < n && (D % 64 == 0 || c < D);
    cp16(s + sw(r, c), in ? base + (long long)(r0 + r) * stride + c : base, in);
  }
}

// load_tile with this thread's share of the copies worked out once: each
// chunk's place in the swizzled tile and its row and column in the
// source, kept in registers across a loop of tile loads.
template <int D, int NT>
struct TileCopy {
  static constexpr int CHUNKS = tile_elems<D>() / 8, N = (CHUNKS + NT - 1) / NT;
  int off[N], row[N], col[N];

  __device__ __forceinline__ TileCopy() {
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const int i = threadIdx.x + m * NT;
      row[m] = (i / 8) % 64;
      col[m] = i / (64 * 8) * 64 + (i % 8) * 8;
      off[m] = sw(row[m], col[m]);
    }
  }

  // rows [r0, r0 + 64) of a matrix whose row r starts at base +
  // row_off(r) into tile s; rows at or past n fill with zeros (and
  // row_off is not called for them)
  template <class RowOff>
  __device__ __forceinline__ void rows(bf16* s, const bf16* base, const RowOff& row_off,
                                       int r0, int n) const {
#pragma unroll
    for (int m = 0; m < N; ++m) {
      if (CHUNKS % NT != 0 && threadIdx.x + m * NT >= CHUNKS) break;
      const bool in = r0 + row[m] < n && (D % 64 == 0 || col[m] < D);
      cp16(s + off[m], in ? base + row_off(r0 + row[m]) + col[m] : base, in);
    }
  }

  // ... of base with row stride `stride`
  __device__ __forceinline__ void operator()(bf16* s, const bf16* base, long long stride,
                                             int r0, int n) const {
    rows(s, base, [stride](int r) { return (long long)r * stride; }, r0, n);
  }

  // rows [r0, r0 + 64) of two matrices with the same row offsets (row r
  // at a + row_off(r) and at b + row_off(r)) into tiles sa and sb, one
  // row_off a copy for both
  template <class RowOff>
  __device__ __forceinline__ void pair(bf16* sa, bf16* sb, const bf16* a, const bf16* b,
                                       const RowOff& row_off, int r0, int n) const {
#pragma unroll
    for (int m = 0; m < N; ++m) {
      if (CHUNKS % NT != 0 && threadIdx.x + m * NT >= CHUNKS) break;
      const bool in = r0 + row[m] < n && (D % 64 == 0 || col[m] < D);
      const long long o = in ? row_off(r0 + row[m]) + col[m] : 0;
      cp16(sa + off[m], a + o, in);
      cp16(sb + off[m], b + o, in);
    }
  }
};

// wgmma shared-memory descriptor of a swizzled tile: the start address,
// the byte step between 64-column blocks along N (LBO; MN-major only)
// and between 8-row groups (SBO), in 16-byte units, and the 128-byte
// swizzle.  The tile starts 1024-byte aligned, so a start inside a
// swizzled row (a depth step of 16 in a K-major operand) needs no base
// offset.
__device__ __forceinline__ uint64_t desc(const bf16* p, int lbo, int sbo) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// Depth 16 kk..16 kk + 15 of a tile as a K-major operand (its 64 rows
// along M or N, its columns the depth) ...
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int kk) {
  return desc(tile + (kk >> 2) * (64 * 64) + (kk & 3) * 16, 16, 1024);
}

// ... or rows 16 kk..16 kk + 15 and columns 64 nb..64 nb + 63 as an
// MN-major B operand (its rows the depth, its columns N).
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk, int nb) {
  return desc(tile + nb * (64 * 64) + 16 * kk * 64, 64 * 64 * 2, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Products issued since the last commit are one group; wait for it.
// (Leaving a group in flight across the elementwise work or into the next
// step makes ptxas serialize every wgmma: it cannot prove the registers
// safe.)
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The 32 f32 sums a thread holds of a 64 x 64 wgmma product: c[j][e] is
// row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2 for lane 4 g + t of
// warp w, as mma.sync's m16n8 fragments side by side.
#define WG_C32(c)                                                          \
  "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]),                \
  "+f"(c[1][0]), "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3]),                \
  "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]), "+f"(c[2][3]),                \
  "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3]),                \
  "+f"(c[4][0]), "+f"(c[4][1]), "+f"(c[4][2]), "+f"(c[4][3]),                \
  "+f"(c[5][0]), "+f"(c[5][1]), "+f"(c[5][2]), "+f"(c[5][3]),                \
  "+f"(c[6][0]), "+f"(c[6][1]), "+f"(c[6][2]), "+f"(c[6][3]),                \
  "+f"(c[7][0]), "+f"(c[7][1]), "+f"(c[7][2]), "+f"(c[7][3])

// c = a b^T (acc = 0) or c += a b^T over a depth of 16, a and b in
// shared memory, both K-major.
__device__ __forceinline__ void wg_ss(float (&c)[8][4], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_C32(c)
      : "l"(da), "l"(db), "r"(acc));
}

// c += a b over a depth of 16: a from registers (mma.sync's A fragment
// of the warp's 16 rows), b in shared memory, MN-major.
__device__ __forceinline__ void wg_rs(float (&c)[8][4], const uint32_t (&a)[4],
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_C32(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Commit the products issued since the last commit as one group; wait
// until at most N groups are in flight.  A group left in flight must not
// share registers with any instruction issued meanwhile (see above).
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The 64 f32 sums a thread holds of a 64 x 128 product, laid out as
// WG_C32's for columns 8 j..8 j + 7, j < 16.
#define WG_C4(c, j) "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
#define WG_C16(c, j) WG_C4(c, j), WG_C4(c, j + 1), WG_C4(c, j + 2), WG_C4(c, j + 3)
#define WG_C64(c) WG_C16(c, 0), WG_C16(c, 4), WG_C16(c, 8), WG_C16(c, 12)
// ... and the 128 of a 64 x 256 product, j < 32
#define WG_C128(c) \
  WG_C64(c), WG_C16(c, 16), WG_C16(c, 20), WG_C16(c, 24), WG_C16(c, 28)

// c += a b over a depth of 16, 64 rows x 128 columns, both operands in
// shared memory: TA = 0 takes a K-major A (desc_k), 1 an MN-major one
// (desc_mn, its 64 rows one column block); likewise TB for B, whose 128
// columns are 16 8-row groups (K-major) or two column blocks (MN-major).
template <int TA, int TB>
__device__ __forceinline__ void wg_ss128(float (&c)[16][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : WG_C64(c)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// ... and 64 rows x 256 columns (B's 256 columns: 32 8-row groups, or
// four column blocks)
template <int TA, int TB>
__device__ __forceinline__ void wg_ss256(float (&c)[32][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "
      "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : WG_C128(c)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// c (the block's 64 rows x 64 columns) = a b^T over depth D: a the 64
// rows of tile A, b the 64 rows of tile B.  D = 8 takes one step of 16
// over the tiles' zero columns 8..15.
template <int D>
__device__ __forceinline__ void wg_abt(float (&c)[8][4], const bf16* A, const bf16* B) {
#pragma unroll
  for (int kk = 0; kk < (D + 15) / 16; ++kk)
    wg_ss(c, desc_k(A, kk), desc_k(B, kk), kk > 0);
}

// The f32 sums of a 64 x 64 product, rounded to bf16, as the A operand
// of a depth-64 product: x[kk] holds depth 16 kk..16 kk + 15.
__device__ __forceinline__ void to_a(uint32_t (&x)[4][4], const float (&f)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    x[kk][0] = pack(f[2 * kk][0], f[2 * kk][1]);
    x[kk][1] = pack(f[2 * kk][2], f[2 * kk][3]);
    x[kk][2] = pack(f[2 * kk + 1][0], f[2 * kk + 1][1]);
    x[kk][3] = pack(f[2 * kk + 1][2], f[2 * kk + 1][3]);
  }
}

// c (64 rows x D, in column blocks of 64) += x b: x from to_a, b the 64
// x D tile B.
template <int D>
__device__ __forceinline__ void wg_xb(float (&c)[col_blocks<D>()][8][4],
                                      const uint32_t (&x)[4][4], const bf16* B) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int nb = 0; nb < col_blocks<D>(); ++nb) wg_rs(c[nb], x[kk], desc_mn(B, kk, nb));
}

// The block's output rows of (.., D) bf16, 64 a warpgroup: this
// thread's rows row0 + 16 w + g and + 8 for warp w of the block (stored
// where below n) at base + row * stride.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long stride, int row0, int n,
                                           const float (&c)[col_blocks<D>()][8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + 16 * (threadIdx.x >> 5) + g + 8 * half;
    if (r >= n) continue;
    bf16* row = base + (long long)r * stride + 2 * t;
#pragma unroll
    for (int nb = 0; nb < col_blocks<D>(); ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (64 * nb + 8 * j < D)
          *reinterpret_cast<__nv_bfloat162*>(row + 64 * nb + 8 * j) =
              __floats2bfloat162_rn(c[nb][j][2 * half], c[nb][j][2 * half + 1]);
  }
}

// ... with row r at row_ptr(r), for rows at no one stride.  A copy of
// store_rows, not its core: store_rows through a row-pointer function
// compiles the backward kernels to other register counts (-Xptxas -v).
template <int D, class RowPtr>
__device__ __forceinline__ void store_rows_at(const RowPtr& row_ptr, int row0, int n,
                                              const float (&c)[col_blocks<D>()][8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + 16 * (threadIdx.x >> 5) + g + 8 * half;
    if (r >= n) continue;
    bf16* row = row_ptr(r) + 2 * t;
#pragma unroll
    for (int nb = 0; nb < col_blocks<D>(); ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (64 * nb + 8 * j < D)
          *reinterpret_cast<__nv_bfloat162*>(row + 64 * nb + 8 * j) =
              __floats2bfloat162_rn(c[nb][j][2 * half], c[nb][j][2 * half + 1]);
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&c)[col_blocks<D>()][8][4]) {
#pragma unroll
  for (int nb = 0; nb < col_blocks<D>(); ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[nb][j][e] = 0.f;
}

}  // namespace hopper
}  // namespace repro
