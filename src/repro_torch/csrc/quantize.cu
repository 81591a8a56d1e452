// Block-scaled int8 quantize and dequantize over the rows of a
// (rows, block) matrix: one float32 scale per row of `block` values.
//
// Replaces: src/repro/kernels/quantize/kernel.py, quantize_int8_kernel
// (pallas_call at :47) and dequantize_int8_kernel (pallas_call at :69).
//
// Bound on the H100: bytes.  Quantize reads 4 bytes and writes 1 per
// value, plus a 4-byte scale per row, with a handful of operations per
// value; dequantize reads 1 + 4/block and writes 4.  At the largest
// payload of granite-moe-1b-a400m's compressed sync, (262144, 256), that
// is 336.6 MB, 0.1005 ms at 3.35 TB/s.
//
// Design: the Pallas kernels walked 32-row tiles and padded the rows to
// a multiple of 32.  Here one warp owns one row (8 rows to a block of 256
// threads) and nothing is padded: a block's last warps exit when their
// row is past the end.  Quantize sweeps its row twice, the second sweep
// an L1/L2 hit: the absolute maximum (a warp-shuffle reduction), then
// the codes.  Rows whose length is a multiple of 4 move float4 and
// char4 vectors (16-byte aligned rows, checked by the wrapper), others
// move one value a lane.
//
// Bit for bit the plain versions' (and the JAX reference's) numbers:
// scale = amax / 127 when amax > 0, else 1.0; code = clamp(rint(x /
// scale), -127, 127).  Both divisions are IEEE divisions (nvcc's default;
// the build must not pass --use_fast_math) and rintf rounds half to even
// as jnp.round and torch.round do.  The maximum is order-independent, so
// the reduction order does not matter.  NaN inputs are undefined in every
// version.
#include "common.cuh"

namespace repro {
namespace quant {

constexpr int WARPS = 8;           // rows per block: one warp a row
constexpr float QMAX = 127.0f;

__device__ __forceinline__ signed char code_of(float v, float scale) {
  const float q = fminf(fmaxf(rintf(v / scale), -QMAX), QMAX);
  return (signed char)(int)q;
}

__global__ void __launch_bounds__(WARPS * 32)
quantize_kernel(const float* __restrict__ x, signed char* __restrict__ codes,
                float* __restrict__ scales, long long rows, int block) {
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;                 // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const float* xr = x + row * block;
  signed char* cr = codes + row * block;
  const bool vec = (block & 3) == 0;

  float amax = 0.f;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int i = lane; i < block / 4; i += 32) {
      const float4 v = x4[i];
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                               fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  } else {
    for (int i = lane; i < block; i += 32) amax = fmaxf(amax, fabsf(xr[i]));
  }
  amax = warp_max(amax);
  const float scale = amax > 0.f ? amax / QMAX : 1.0f;

  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    char4* c4 = reinterpret_cast<char4*>(cr);
    for (int i = lane; i < block / 4; i += 32) {
      const float4 v = x4[i];
      c4[i] = make_char4(code_of(v.x, scale), code_of(v.y, scale),
                         code_of(v.z, scale), code_of(v.w, scale));
    }
  } else {
    for (int i = lane; i < block; i += 32) cr[i] = code_of(xr[i], scale);
  }
  if (lane == 0) scales[row] = scale;
}

__global__ void __launch_bounds__(WARPS * 32)
dequantize_kernel(const signed char* __restrict__ codes,
                  const float* __restrict__ scales, float* __restrict__ out,
                  long long rows, int block) {
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const signed char* cr = codes + row * block;
  float* orow = out + row * block;
  const float s = scales[row];
  if ((block & 3) == 0) {
    const char4* c4 = reinterpret_cast<const char4*>(cr);
    float4* o4 = reinterpret_cast<float4*>(orow);
    for (int i = lane; i < block / 4; i += 32) {
      const char4 c = c4[i];
      o4[i] = make_float4((float)c.x * s, (float)c.y * s, (float)c.z * s,
                          (float)c.w * s);
    }
  } else {
    for (int i = lane; i < block; i += 32) orow[i] = (float)cr[i] * s;
  }
}

}  // namespace quant
}  // namespace repro

static int grid_of(long long rows, unsigned* blocks) {
  const long long n = (rows + repro::quant::WARPS - 1) / repro::quant::WARPS;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *blocks = (unsigned)n;
  return 0;
}

// x (rows, block) f32 -> codes (rows, block) int8, scales (rows,) f32.
extern "C" int quantize_int8_f32(const void* x, void* codes, void* scales,
                                 long long rows, int block, void* stream) {
  if (rows < 0 || block <= 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  unsigned blocks;
  if (int err = grid_of(rows, &blocks)) return err;
  repro::quant::quantize_kernel<<<blocks, repro::quant::WARPS * 32, 0,
                                  (cudaStream_t)stream>>>(
      (const float*)x, (signed char*)codes, (float*)scales, rows, block);
  return (int)cudaGetLastError();
}

// codes (rows, block) int8, scales (rows,) f32 -> out (rows, block) f32.
extern "C" int dequantize_int8_f32(const void* codes, const void* scales,
                                   void* out, long long rows, int block,
                                   void* stream) {
  if (rows < 0 || block <= 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  unsigned blocks;
  if (int err = grid_of(rows, &blocks)) return err;
  repro::quant::dequantize_kernel<<<blocks, repro::quant::WARPS * 32, 0,
                                    (cudaStream_t)stream>>>(
      (const signed char*)codes, (const float*)scales, (float*)out, rows,
      block);
  return (int)cudaGetLastError();
}
