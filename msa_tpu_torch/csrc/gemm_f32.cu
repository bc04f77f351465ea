// The f32 GEMM of rows 10, 8 and 11 in f32 (gemm_f32.cuh): its one C entry,
// which attention.cu and ffn.cu launch twice a call, and the wrappers of
// msa_tpu_torch/ops/kernels/gemm_f32.py (the GEMM alone) and
// ops/kernels/conv.py (row 11 on f32: w [K, N], overlapping A rows, a
// batch axis) launch alone. Every tile the planner can name is built here,
// once.
#include "gemm_f32.cuh"

namespace {

template <bool GELU>
cudaError_t launch_planned(const F32Plan& p, bool w_nk, const float* a, const float* w, const float* bias, float* c,
                           int M, int N, int K, int lda, int batch, int a_batch, int c_batch, float* ws, int* cnt,
                           cudaStream_t s) {
  if (!w_nk)
    return launch_f32<128, 128, false, GELU>(a, w, bias, c, M, N, K, lda, batch, a_batch, c_batch, p.ctas, ws, cnt, s);
  if (p.bm == 128)
    return launch_f32<128, 64, true, GELU>(a, w, bias, c, M, N, K, lda, batch, a_batch, c_batch, p.ctas, ws, cnt, s);
  return launch_f32<64, 128, true, GELU>(a, w, bias, c, M, N, K, lda, batch, a_batch, c_batch, p.ctas, ws, cnt, s);
}

}  // namespace

extern "C" int msa_gemm_f32(const void* a, const void* w, const void* bias, void* c, void* ws, void* counters,
                            int M, int N, int K, int lda, int w_nk, int batch, int a_batch, int c_batch, int plan,
                            int gelu, void* stream) {
  const F32Plan p(plan);
  const bool tile = w_nk ? (p.bm == 64 && p.bn == 128) || (p.bm == 128 && p.bn == 64) : p.bm == 128 && p.bn == 128;
  if (!tile || M < 1 || batch < 1 || N < p.bn || N % p.bn || K < 4 || K % 4 || lda % 4 || a_batch < 0 || c_batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (long long)((M + p.bm - 1) / p.bm) * (N / p.bn) * batch;
  const long long steps = tiles * ((K + F32_BK - 1) / F32_BK);
  if (steps >= (1LL << 31) || p.ctas < 0 || p.ctas > steps ||
      (p.ctas && p.ctas != tiles && (!ws || !counters)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto A = static_cast<const float*>(a), W = static_cast<const float*>(w), b = static_cast<const float*>(bias);
  auto C = static_cast<float*>(c);
  auto wsp = static_cast<float*>(ws);
  auto cnt = static_cast<int*>(counters);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = gelu ? launch_planned<true>(p, w_nk, A, W, b, C, M, N, K, lda, batch, a_batch, c_batch, wsp, cnt, s)
                             : launch_planned<false>(p, w_nk, A, W, b, C, M, N, K, lda, batch, a_batch, c_batch, wsp, cnt, s);
  return static_cast<int>(e);
}
