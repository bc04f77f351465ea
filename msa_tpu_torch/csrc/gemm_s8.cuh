// int8 GEMM with a dequantising epilogue, for the W8A8 kernels:
//   C[m, n] = act( f32(Σ_k A[m, k]·W[n, k]) · row_scale[m] · col_scale[n] + bias[n] )
// A int8 [M, K], W int8 [N, K] (PyTorch's Linear layout), int32
// accumulation, f32 epilogue, C f32 or bf16.
//
// The f32 epilogue keeps the TPU kernels' order of products, since f32
// multiplication is not associative: (acc·rs)·cs + b, except for the
// columns in [swap_lo, swap_hi), which take (acc·cs)·rs + b (the K
// projection of msa_tpu/ops/pallas/attention.py:615-624 is computed
// transposed). __fmul_rn/__fadd_rn keep nvcc from contracting them into an
// FMA, so the dequantised value is bit-equal to the plain version's.
//
// Tensor cores through `mma.sync.m16n8k32.s8.s8.s32`, fragments read from
// shared memory with 32-bit loads; tiles of 128×128 stream through shared
// memory with the same 2-stage cp.async pipeline as gemm.cuh. This is the
// simple first design; wgmma and TMA are still to come.
//
// Limits the wrappers check: N % 128 == 0, K % 64 == 0, A and W 16-byte
// aligned. M is arbitrary (rows past M are zero-filled and not stored).
#pragma once

#include "gemm.cuh"

namespace {

constexpr int SBM = 128;       // block tile rows
constexpr int SBN = 128;       // block tile columns
constexpr int SBK = 64;        // k depth per stage (bytes)
constexpr int SLD = SBK + 16;  // padded smem row: 80 bytes = 20 words, conflict-free fragment reads
constexpr int STHREADS = 256;  // 8 warps as 2 (m) × 4 (n), 64×32 each

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <bool GELU, typename OutT>
__global__ void __launch_bounds__(STHREADS)
gemm_s8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W, const float* __restrict__ row_scale,
               const float* __restrict__ col_scale, const float* __restrict__ bias, OutT* __restrict__ C, int M,
               int N, int K, int swap_lo, int swap_hi) {
  // [stage][0 = A tile, 1 = W tile][128 rows × SLD bytes]; 40 KB in all
  __shared__ __align__(128) int8_t smem[2][2][SBM * SLD];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, tig = lane & 3;  // mma groupID, thread-in-group
  const int m0 = blockIdx.y * SBM, n0 = blockIdx.x * SBN;

  auto load_stage = [&](int stage, int k0) {
    for (int i = tid; i < SBM * SBK / 16; i += STHREADS) {
      const int r = i / (SBK / 16), c = (i % (SBK / 16)) * 16;
      const int gr = m0 + r;
      const bool ok = gr < M;
      cp_async16(&smem[stage][0][r * SLD + c], A + (size_t)(ok ? gr : 0) * K + k0 + c, ok);
      cp_async16(&smem[stage][1][r * SLD + c], W + (size_t)(n0 + r) * K + k0 + c, true);
    }
    cp_async_commit();
  };

  int acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  const int nk = K / SBK;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_stage((kt + 1) & 1, (kt + 1) * SBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* sA = smem[kt & 1][0];
    const int8_t* sW = smem[kt & 1][1];
#pragma unroll
    for (int kk = 0; kk < SBK; kk += 32) {
      // A fragment (16×32, row): rows g and g+8, bytes tig·4..+3 and 16+tig·4..+3
      unsigned a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = sA + (wm * 64 + mi * 16 + g) * SLD + kk + tig * 4;
        a[mi][0] = *reinterpret_cast<const unsigned*>(p);
        a[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * SLD);
        a[mi][2] = *reinterpret_cast<const unsigned*>(p + 16);
        a[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * SLD + 16);
      }
      // B fragment (32×8, col): column n = g, bytes tig·4..+3 and 16+tig·4..+3
      unsigned b[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = sW + (wn * 32 + ni * 8 + g) * SLD + kk + tig * 4;
        b[ni][0] = *reinterpret_cast<const unsigned*>(p);
        b[ni][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8_16832(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // epilogue: fragment j holds row g (j < 2) or g+8, column tig·2 + (j & 1)
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gr = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (gr >= M) continue;
      const float rs = row_scale[gr];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int gc = n0 + wn * 32 + ni * 8 + tig * 2;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float a = __int2float_rn(acc[mi][ni][half * 2 + j]);
          const float cs = col_scale[gc + j];
          const bool swap = gc + j >= swap_lo && gc + j < swap_hi;
          float x = swap ? __fmul_rn(__fmul_rn(a, cs), rs) : __fmul_rn(__fmul_rn(a, rs), cs);
          x = __fadd_rn(x, bias[gc + j]);
          v[j] = GELU ? gelu_as(x) : x;
        }
        store2(C + (size_t)gr * N + gc, v[0], v[1]);
      }
    }
  }
}

template <bool GELU, typename OutT>
cudaError_t launch_gemm_s8(const int8_t* A, const int8_t* W, const float* row_scale, const float* col_scale,
                           const float* bias, OutT* C, int M, int N, int K, cudaStream_t stream, int swap_lo = 0,
                           int swap_hi = 0) {
  dim3 grid(N / SBN, (M + SBM - 1) / SBM);
  gemm_s8_kernel<GELU, OutT><<<grid, STHREADS, 0, stream>>>(A, W, row_scale, col_scale, bias, C, M, N, K, swap_lo,
                                                            swap_hi);
  return cudaGetLastError();
}

}  // namespace

// Row quantization, defined in quant.cu (the same C entry the wrapper of
// msa_tpu_torch/ops/kernels/quant.py calls).
extern "C" int msa_quantize_rows(const void* x, int x_is_bf16, void* q, void* scale, int rows, int cols,
                                 void* stream);
