// The bf16 GEMM of rows 8 and 10 (gemm_bf16.cuh): its one C entry, which
// attention.cu and ffn.cu launch twice a call and the wrapper of
// msa_tpu_torch/ops/kernels/gemm_bf16.py launches alone. Every tile the
// planner can name is built here, once.
#include "gemm_bf16.cuh"

namespace {

template <bool GELU, typename BiasT>
cudaError_t launch_planned(const WgPlan& p, const bf16* a, const bf16* w, const void* bias, bf16* c, int M, int N,
                           int K, float* ws, int* cnt, cudaStream_t s) {
  auto b = static_cast<const BiasT*>(bias);
  if (p.bm == 64 && p.bn == 64) return launch_bf16<64, 64, GELU>(a, w, b, c, M, N, K, p.splits, ws, cnt, s);
  if (p.bm == 64 && p.bn == 128) return launch_bf16<64, 128, GELU>(a, w, b, c, M, N, K, p.splits, ws, cnt, s);
  if (p.bm == 64 && p.bn == 192) return launch_bf16<64, 192, GELU>(a, w, b, c, M, N, K, p.splits, ws, cnt, s);
  if (p.bm == 128 && p.bn == 192) return launch_bf16<128, 192, GELU>(a, w, b, c, M, N, K, p.splits, ws, cnt, s);
  return launch_bf16<128, 128, GELU>(a, w, b, c, M, N, K, p.splits, ws, cnt, s);
}

}  // namespace

extern "C" int msa_gemm_bf16(const void* a, const void* w, const void* bias, int bias_bf16, void* c, void* ws,
                             void* counters, int M, int N, int K, int plan, int gelu, void* stream) {
  const WgPlan p(plan);
  const int nk = (2 * K + WG_BK - 1) / WG_BK;
  const bool tile = (p.bm == 64 && (p.bn == 64 || p.bn == 128 || p.bn == 192)) ||
                    (p.bm == 128 && (p.bn == 128 || p.bn == 192));
  if (!tile || N % p.bn || K % 8 || K < 8 || M < 1 ||
      p.splits < 1 || p.splits > nk || (p.splits > 1 && (!ws || !counters)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto A = static_cast<const bf16*>(a), Wt = static_cast<const bf16*>(w);
  auto C = static_cast<bf16*>(c);
  auto wsp = static_cast<float*>(ws);
  auto cnt = static_cast<int*>(counters);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (gelu)
    e = bias_bf16 ? launch_planned<true, bf16>(p, A, Wt, bias, C, M, N, K, wsp, cnt, s)
                  : launch_planned<true, float>(p, A, Wt, bias, C, M, N, K, wsp, cnt, s);
  else
    e = bias_bf16 ? launch_planned<false, bf16>(p, A, Wt, bias, C, M, N, K, wsp, cnt, s)
                  : launch_planned<false, float>(p, A, Wt, bias, C, M, N, K, wsp, cnt, s);
  return static_cast<int>(e);
}
