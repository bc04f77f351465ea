// Shared pieces of the port's CUDA kernels: a tiled bf16 GEMM with f32
// accumulation and a fused bias (+ optional GELU) epilogue, the A&S 7.1.26
// erf that the TPU FFN kernel uses, warp reductions, and the strides the
// attention kernels address q, k and v by.
//
// The GEMM is "NT": C[M, N] = A[M, K] · W[N, K]ᵀ + bias[N], with W in
// PyTorch's Linear layout ([out, in], row-major). Tensor cores are reached
// through the WMMA API (16×16×16 bf16 fragments, f32 accumulators); tiles
// stream through shared memory with cp.async double buffering. This is the
// simple first design; the fast Hopper design (wgmma + TMA) is still to come.
//
// Limits the wrappers check: N % 128 == 0, K % 32 == 0, every pointer
// 16-byte aligned. M is arbitrary (rows past M are zero-filled and not
// stored).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int GBM = 128;          // block tile rows
constexpr int GBN = 128;          // block tile columns
constexpr int GBK = 32;           // k depth per stage
constexpr int GLD = GBK + 8;      // padded smem row (bf16), 80 bytes
constexpr int GTHREADS = 256;     // 8 warps as 2 (m) × 4 (n), 64×32 each

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
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

template <bool GELU, typename BiasT>
__global__ void __launch_bounds__(GTHREADS)
gemm_nt_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W, const BiasT* __restrict__ bias,
               bf16* __restrict__ C, int M, int N, int K) {
  // [stage][0 = A tile, 1 = W tile][128 rows × GLD]; 40 KB in all
  __shared__ __align__(128) bf16 smem[2][2][GBM * GLD];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;

  auto load_stage = [&](int stage, int k0) {
    for (int i = tid; i < GBM * GBK / 8; i += GTHREADS) {
      const int r = i / (GBK / 8), c = (i % (GBK / 8)) * 8;
      const int gr = m0 + r;
      const bool ok = gr < M;
      cp_async16(&smem[stage][0][r * GLD + c], A + (size_t)(ok ? gr : 0) * K + k0 + c, ok);
      cp_async16(&smem[stage][1][r * GLD + c], W + (size_t)(n0 + r) * K + k0 + c, true);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) wmma::fill_fragment(acc[mi][ni], 0.0f);

  const int nk = K / GBK;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_stage((kt + 1) & 1, (kt + 1) * GBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sA = smem[kt & 1][0];
    const bf16* sW = smem[kt & 1][1];
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) wmma::load_matrix_sync(a[mi], sA + (wm * 64 + mi * 16) * GLD + kk, GLD);
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) wmma::load_matrix_sync(b[ni], sW + (wn * 32 + ni * 16) * GLD + kk, GLD);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) wmma::mma_sync(acc[mi][ni], a[mi], b[ni], acc[mi][ni]);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // epilogue: each warp stages one 16×16 f32 fragment at a time in its own
  // 1 KB of the (now idle) tile buffer, adds the bias, applies the GELU and
  // writes 8 bf16 (16 bytes) per lane
  float* scratch = reinterpret_cast<float*>(&smem[0][0][0]) + warp * 256;
  const int r = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      wmma::store_matrix_sync(scratch, acc[mi][ni], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * 64 + mi * 16 + r;
      const int gc = n0 + wn * 32 + ni * 16 + c;
      if (gr < M) {
        __align__(16) bf16 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float x = scratch[r * 16 + c + j] + to_f32(bias[gc + j]);
          if (GELU) x = gelu_as(x);
          v[j] = __float2bfloat16(x);
        }
        *reinterpret_cast<uint4*>(C + (size_t)gr * N + gc) = *reinterpret_cast<const uint4*>(v);
      }
      __syncwarp();
    }
  }
}

template <bool GELU, typename BiasT>
cudaError_t launch_gemm_nt(const bf16* A, const bf16* W, const BiasT* bias, bf16* C, int M, int N, int K,
                           cudaStream_t stream) {
  dim3 grid(N / GBN, (M + GBM - 1) / GBM);
  gemm_nt_kernel<GELU, BiasT><<<grid, GTHREADS, 0, stream>>>(A, W, bias, C, M, N, K);
  return cudaGetLastError();
}

}  // namespace
