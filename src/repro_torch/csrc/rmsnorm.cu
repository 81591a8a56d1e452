// Fused RMSNorm over the rows of a (rows, d) bf16 matrix, f32 weight.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py, rmsnorm_kernel (the
// row-blocked Pallas kernel, pallas_call at :39).
//
// Bound on the H100: bytes.  The work is 3 flops per element against 4
// bytes moved (one bf16 read, one bf16 write), far below the ~295
// flops/byte where the tensor cores would become the limit, so the least
// time is 2 * rows * d * 2 bytes over 3.35 TB/s.
//
// Design: one block of 256 threads per row (rows are 4096 wide on the
// main path, 8 KB of bf16).  Each thread reads 16-byte vectors of eight
// bf16, sums squares in f32, and the block reduces with warp shuffles.
// A second sweep over the row (an L1/L2 hit) scales by 1/sqrt(mean+eps)
// and the weight and writes bf16 vectors.  Rows are independent, so a
// decode tick's 8 rows fill 8 SMs and a 512-token prefill 512 blocks.
// Requires d % 8 == 0 and 16-byte aligned rows (checked by the wrapper).
#include "common.cuh"

namespace repro {

__global__ void __launch_bounds__(256)
rmsnorm_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
               bf16* __restrict__ out, int d, float eps) {
  const int nvec = d / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (long long)blockIdx.x * d);
  uint4* orow = reinterpret_cast<uint4*>(out + (long long)blockIdx.x * d);
  const float4* w4 = reinterpret_cast<const float4*>(w);

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float f[8];
    unpack8(xr[i], f);
#pragma unroll
    for (int e = 0; e < 8; ++e) ss = fmaf(f[e], f[e], ss);
  }
  ss = block_sum(ss);
  const float inv = 1.0f / sqrtf(ss / (float)d + eps);

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float f[8];
    unpack8(xr[i], f);
    const float4 wa = w4[2 * i], wb = w4[2 * i + 1];
    const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = (f[e] * inv) * wv[e];
    orow[i] = pack8(f);
  }
}

}  // namespace repro

extern "C" int rmsnorm_bf16(const void* x, const void* w, void* out, int rows,
                            int d, float eps, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  if (d <= 0 || d % 8 != 0) return (int)cudaErrorInvalidValue;
  repro::rmsnorm_kernel<<<rows, 256, 0, (cudaStream_t)stream>>>(
      (const repro::bf16*)x, (const float*)w, (repro::bf16*)out, d, eps);
  return (int)cudaGetLastError();
}
