// Shared pieces of the port's CUDA kernels: the cp.async helpers (16 and 4
// bytes, zero-filling where the predicate is false), the
// A&S 7.1.26 erf that the TPU FFN kernel uses and its GELU, warp
// reductions and the strides the attention kernels address q, k and v by.
// The bf16 GEMM of rows 8 and 10 is gemm_bf16.cuh (wgmma), the int8 one of
// rows 7 and 9 gemm_s8.cuh, the f32 one gemm_f32.cuh; row 11's bf16
// convolution is conv_stride2.cu (wgmma fed by TMA, wgmma.cuh's helpers).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// erf by Abramowitz & Stegun 7.1.26 (max abs error 1.5e-7): the polynomial
// msa_tpu/ops/pallas/ffn.py:_erf uses, so the GELU rounds alike.
__device__ __forceinline__ float erf_as(float z) {
  float s = z > 0.f ? 1.f : (z < 0.f ? -1.f : 0.f);
  float za = fabsf(z);
  float t = 1.0f / (1.0f + 0.3275911f * za);
  float poly = t * (0.254829592f +
                    t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return s * (1.0f - poly * expf(-za * za));
}
__device__ __forceinline__ float gelu_as(float x) {
  return 0.5f * x * (1.0f + erf_as(x * 0.70710678118654752f));
}

// element strides of a [batch, head, time, D] view with D contiguous: the
// attention kernels read q, k, v and write their outputs through these
struct Strides {
  int b, h, t;
  __device__ __forceinline__ size_t at(int bi, int hi, int ti) const {
    return (size_t)bi * b + (size_t)hi * h + (size_t)ti * t;
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Programmatic dependent launch (sm_90), for the int8 chains of rows 7 and
// 9 (attention.cu, ffn.cu): a kernel launched with the attribute (launch_k
// with pdl) may start while the kernel before it in the stream finishes,
// and pdl_wait() holds its threads until that kernel has completed and its
// writes are visible; pdl_trigger() lets the next kernel start before this
// one ends (it only schedules: correctness rests on the waits). A kernel
// launched without the attribute passes both at once, so every other
// launch of the same kernels keeps plain stream order.
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
__device__ __forceinline__ void pdl_trigger() { asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory"); }

// kernel<<<grid, block, smem, s>>>(args...), with the programmatic-
// serialization attribute where pdl; returns the launch's error
template <typename... P, typename... A>
cudaError_t launch_k(bool pdl, void (*kernel)(P...), dim3 grid, dim3 block, size_t smem, cudaStream_t s, A... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<P>(args)...);
  const cudaError_t last = cudaGetLastError();  // also clears a refused launch's error
  return e != cudaSuccess ? e : last;
}

}  // namespace
