// ffn_fused for Hopper: gelu(x·W1ᵀ + b1)·W2ᵀ + b2 in bf16 with f32
// accumulation.
//
// Replaces msa_tpu/ops/pallas/ffn.py:ffn_fused (pallas_call at :89, body
// :49-63). Same rounding points: both dots accumulate in f32, the bias and
// the GELU (A&S 7.1.26 erf) run in f32, and the hidden tile is rounded to
// bf16 before the second dot.
//
// What bounds it on the card: at the serving shapes (N = B·T_pad ≤ 1024
// rows, d 768, d_ff 3072) the two GEMMs are ~9.7 GFLOP against ~12.5 MB of
// compulsory traffic, i.e. ~780 FLOP/byte: tensor-core bound. This first
// design runs two launches of the shared WMMA GEMM (gemm.cuh) and lets the
// hidden tile [N, d_ff] make a round trip through device memory (L2 holds
// it at these sizes). Keeping it on chip is the redesign still to come.
#include "gemm.cuh"

extern "C" int msa_ffn_fused(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                             void* hidden, void* out, int M, int D, int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_gemm_nt<true, bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                                             static_cast<const bf16*>(b1), static_cast<bf16*>(hidden), M, F,
                                             D, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_gemm_nt<false, bf16>(static_cast<const bf16*>(hidden), static_cast<const bf16*>(w2),
                                  static_cast<const bf16*>(b2), static_cast<bf16*>(out), M, D, F, s);
  return static_cast<int>(e);
}

extern "C" const char* msa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
