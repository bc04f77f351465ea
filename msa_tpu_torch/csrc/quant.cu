// Row quantization for Hopper: per-row symmetric int8 of a [rows, cols]
// activation, x_i8 = clip(round_half_even(x / scale), ±127) with
// scale = max(max|x|, 1e-8) · f32(1/127), in f32 (the source's "/ 127.0"
// as XLA compiles it under jit, msa_tpu_torch/ops/quant.py says more).
//
// Replaces msa_tpu/ops/quant.py:quantize_rows, which the TPU W8A8 kernels
// run in XLA on their input (attention.py:776, ffn.py:160) and inside the
// kernel on the attention output (attention.py:677) and on the FFN hidden
// tile (ffn.py:126). Codes and scales are bit-equal to the plain version
// msa_tpu_torch/ops/quant.py:quantize_rows: amax is exact, the scale is
// one rounded product (__fmul_rn), x / scale is an IEEE division
// (__fdiv_rn; never x · 127/amax, which moves ties), and
// __float2int_rn rounds half to even as jnp.round does. Build without
// --use_fast_math.
//
// What bounds it on the card: bytes. It reads the row once for the amax
// and once more to quantize (the second read hits L1/L2), and writes one
// byte per value plus a scale. One warp per row, 16-byte loads.
//
// msa_quantize_rows_amax quantizes the FFN's f32 hidden tile, whose row
// amax the fc_in GEMM's epilogue has already reduced (gemm_s8.cuh, as f32
// bits in int32 [rows]): the same scale and codes, since the amax is the
// same exact max, but no reduction, so it is elementwise: one thread per
// 8 values, every SM busy, one read of the tile. (A warp a row, as above,
// took 0.017 ms on an H100 for the [1024, 3072] tile with the amax given
// or not: too few warps in flight to cover the loads.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QROWS = 8;  // rows (warps) per 256-thread block

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
}

// the row's scale from its amax: one rounded product by f32(1/127)
__device__ __forceinline__ float row_scale_of(float amax) { return __fmul_rn(fmaxf(amax, 1e-8f), 0x1.020408p-7f); }

template <typename T>
__global__ void __launch_bounds__(32 * QROWS)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale, int rows,
                     int cols) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * QROWS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + (size_t)row * cols;
  float amax = 0.f;
  for (int c = lane * 8; c < cols; c += 32 * 8) {
    float v[8];
    load8(xr + c, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = row_scale_of(amax);
  if (lane == 0) scale[row] = s;
  int8_t* qr = q + (size_t)row * cols;
  for (int c = lane * 8; c < cols; c += 32 * 8) {
    float v[8];
    load8(xr + c, v);
    __align__(8) int8_t out[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = __float2int_rn(__fdiv_rn(v[j], s));
      out[j] = static_cast<int8_t>(max(-127, min(127, k)));
    }
    *reinterpret_cast<uint2*>(qr + c) = *reinterpret_cast<const uint2*>(out);
  }
}

__global__ void __launch_bounds__(256)
quantize_rows_amax_kernel(const float* __restrict__ x, const int* __restrict__ amax_bits, int8_t* __restrict__ q,
                          float* __restrict__ scale, int rows, int cols) {
  const int chunks = cols / 8;
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= (size_t)rows * chunks) return;
  const int row = static_cast<int>(i / chunks), c = static_cast<int>(i % chunks) * 8;
  const float s = row_scale_of(__int_as_float(__ldg(amax_bits + row)));
  if (c == 0) scale[row] = s;
  float v[8];
  load8(x + (size_t)row * cols + c, v);
  __align__(8) int8_t out[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = __float2int_rn(__fdiv_rn(v[j], s));
    out[j] = static_cast<int8_t>(max(-127, min(127, k)));
  }
  *reinterpret_cast<uint2*>(q + (size_t)row * cols + c) = *reinterpret_cast<const uint2*>(out);
}

}  // namespace

// x [rows, cols] f32, amax [rows] int32 (each row's max |x| as f32 bits),
// q [rows, cols] int8, scale [rows] f32; cols % 8 == 0.
extern "C" int msa_quantize_rows_amax(const void* x, const void* amax, void* q, void* scale, int rows, int cols,
                                      void* stream) {
  const dim3 grid(static_cast<unsigned>(((size_t)rows * (cols / 8) + 255) / 256));
  quantize_rows_amax_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(amax), static_cast<int8_t*>(q), static_cast<float*>(scale),
      rows, cols);
  return static_cast<int>(cudaGetLastError());
}

// x [rows, cols] (f32, or bf16 when x_is_bf16), q [rows, cols] int8,
// scale [rows] f32. cols % 8 == 0 and x, q 16- and 8-byte aligned (the
// wrapper checks). Also called by the int8 attention and FFN entries.
extern "C" int msa_quantize_rows(const void* x, int x_is_bf16, void* q, void* scale, int rows, int cols,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((rows + QROWS - 1) / QROWS);
  if (x_is_bf16)
    quantize_rows_kernel<__nv_bfloat16><<<grid, 32 * QROWS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale), rows, cols);
  else
    quantize_rows_kernel<float><<<grid, 32 * QROWS, 0, s>>>(static_cast<const float*>(x), static_cast<int8_t*>(q),
                                                            static_cast<float*>(scale), rows, cols);
  return static_cast<int>(cudaGetLastError());
}
