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
// compulsory traffic, i.e. ~780 FLOP/byte: tensor-core bound. Two
// launches of the bf16 wgmma GEMM (gemm_bf16.cuh, through msa_gemm_bf16):
// fc_in with + b1 and the GELU in its epilogue, writing the bf16 hidden
// tile, then fc_out with + b2, each on the tile and K split the planner
// picked (ops/kernels/gemm_plan.py; fc_out's K = 3072 splits where its
// tiles are few, deterministically). The hidden tile [N, d_ff] makes a
// round trip through device memory (L2 holds it at these sizes).
//
// msa_ffn_fused_int8 replaces msa_tpu/ops/pallas/ffn.py:ffn_fused_int8
// (pallas_call at :166, body _ffn_int8_kernel :106-133) with a chain of
// four launches, the last three under programmatic dependent launch:
// quantize the rows of x (quant.cu); the int8 fc_in GEMM of gemm_s8.cuh
// with the epilogue acc·xs·s1 + b1 and the GELU, writing an f32 hidden tile
// (the TPU kernel quantizes the f32 GELU output, not a bf16 rounding of
// it) and max-reducing each row's |h| into amax; quantize the rows of the
// hidden tile over all d_ff columns with that amax (a row spans every
// block of the fc_in grid, so this is a second pass, but an elementwise
// one: quant.cu msa_quantize_rows_amax); the int8 fc_out GEMM with
// acc·hs·s2 + b2, rounded to bf16, which zeroes amax again. At N=1024 that is
// 9.7 G int8 operations against ~7 MB of compulsory traffic: tensor-core
// bound at 1,979 TOPS. The f32 hidden tile (12.6 MB at N=1024) makes a
// round trip through device memory (L2 holds it). Each GEMM runs on the
// tile and K split the planner picked (ops/kernels/gemm_s8.py): fc_out,
// which fixed 128 × 128 tiles cut into 6–48 CTAs, runs on 72–192; the
// wrapper passes the split-K workspace, the per-tile counters and amax.
//
// msa_ffn_fused_int8_f32 is the same W8A8 kernel under f32 compute
// (compute_dtype="float32", quantize="int8"; the TPU kernel quantizes
// x.astype(f32) and writes x.dtype): the f32 rows of x are quantized, and
// fc_out's epilogue writes f32. Nothing else changes: before that last
// rounding the bf16-x kernel computes the same f32 values from the same x.
//
// msa_ffn_fused_f32 is the same TPU kernel in f32 (the parity mode's
// encoders, compute_dtype="float32"): two launches of the shared f32 SIMT
// GEMM (gemm_f32.cuh through msa_gemm_f32, exact FMA, no TF32), fc_in with
// + b1 and the GELU in its epilogue writing the f32 hidden tile, then
// fc_out with + b2, each on the tile and stream-K grid the planner picked
// (ops/kernels/gemm_plan.py), its split-K sums folded into the launch. JAX's
// rounding points are all f32 there (ffn.py:49-63), and so are these. At
// N=1024 it is 9.7 GFLOP against ~28 MB of compulsory traffic: bound by the
// f32 FMA rate (67 TFLOP/s), 0.14 ms at best.
#include "gemm_bf16.cuh"
#include "gemm_f32.cuh"
#include "gemm_s8.cuh"

// x [M, D], w1 [F, D], b1 [F], w2 [D, F], b2 [D], hidden [M, F], out [M, D],
// all bf16 and contiguous; D and F multiples of 128; ws and counters: the
// bf16 GEMM's split-K partials and per-tile counters (zero at rest);
// plan_in and plan_out: fc_in's and fc_out's plans (bm | bn << 10 | splits
// << 20, ops/kernels/gemm_plan.py).
extern "C" int msa_ffn_fused(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                             void* hidden, void* out, void* ws, void* counters, int M, int D, int F, int plan_in,
                             int plan_out, void* stream) {
  const int rc = msa_gemm_bf16(x, w1, b1, 1, hidden, ws, counters, M, F, D, plan_in, 1, stream);
  if (rc) return rc;
  return msa_gemm_bf16(hidden, w2, b2, 1, out, ws, counters, M, D, F, plan_out, 0, stream);
}

// x [M, D], w1 [F, D], b1 [F], w2 [D, F], b2 [D], hidden [M, F], out [M, D],
// all f32 and contiguous; D and F multiples of 128; ws and counters: the
// f32 GEMM's stream-K partials and per-tile counters (zero at rest);
// plan_in and plan_out: fc_in's and fc_out's plans (bm | bn << 10 | ctas
// << 20, ops/kernels/gemm_plan.py).
extern "C" int msa_ffn_fused_f32(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                                 void* hidden, void* out, void* ws, void* counters, int M, int D, int F, int plan_in,
                                 int plan_out, void* stream) {
  const int rc = msa_gemm_f32(x, w1, b1, hidden, ws, counters, M, F, D, D, 1, 1, 0, 0, plan_in, 1, stream);
  if (rc) return rc;
  return msa_gemm_f32(hidden, w2, b2, out, ws, counters, M, D, F, F, 1, 1, 0, 0, plan_out, 0, stream);
}

namespace {

// the W8A8 FFN with x and out in E (bf16, or f32 under f32 compute), a
// chain of four launches: the first in plain stream order, the other three
// under programmatic dependent launch (gemm.cuh), each waiting (pdl_wait)
// before its first read of its predecessor's output and before any touch
// of the scratch the chain shares (the GEMMs' split-K workspace and
// counters, and amax, which fc_out zeroes after the quantization before it
// has read it); only the GEMMs' first k-tiles of W come before the wait
template <typename E>
int ffn_int8(const void* x, const void* w1, const void* s1, const void* b1, const void* w2, const void* s2,
             const void* b2, void* xq, void* xs, void* hidden, void* hq, void* hs, void* out, void* ws, void* counters,
             void* amax, int M, int D, int F, int plan_in, int plan_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = quantize_rows_launch(x, sizeof(E) == 2, xq, xs, M, D, s, false);
  if (rc) return rc;
  cudaError_t e =
      launch_gemm_s8<true, float>(xq, w1, xs, s1, b1, hidden, M, F, D, plan_in, ws, counters, s, 0, 0, amax, true);
  if (e != cudaSuccess) return static_cast<int>(e);
  rc = quantize_rows_amax_launch(hidden, amax, hq, hs, M, F, s, true);
  if (rc) return rc;
  // fc_out zeroes amax for the next call (the quantization above has read it)
  e = launch_gemm_s8<false, E>(hq, w2, hs, s2, b2, out, M, D, F, plan_out, ws, counters, s, 0, 0, amax, true);
  return static_cast<int>(e);
}

}  // namespace

// x [M, D] bf16; w1 [F, D] int8, s1 [F] f32, b1 [F] f32; w2 [D, F] int8,
// s2 [D] f32, b2 [D] f32. Scratch: xq [M, D] int8, xs [M] f32, hidden
// [M, F] f32, hq [M, F] int8, hs [M] f32. out [M, D] bf16. ws, counters and
// amax [M]: the int8 GEMM's split-K workspace and per-tile counters and the
// hidden rows' amax (int32, all zero at rest); plan_in and plan_out: fc_in's
// and fc_out's plans (bm | bn << 10 | splits << 20).
extern "C" int msa_ffn_fused_int8(const void* x, const void* w1, const void* s1, const void* b1, const void* w2,
                                  const void* s2, const void* b2, void* xq, void* xs, void* hidden, void* hq,
                                  void* hs, void* out, void* ws, void* counters, void* amax, int M, int D, int F,
                                  int plan_in, int plan_out, void* stream) {
  return ffn_int8<bf16>(x, w1, s1, b1, w2, s2, b2, xq, xs, hidden, hq, hs, out, ws, counters, amax, M, D, F, plan_in,
                        plan_out, stream);
}

// As msa_ffn_fused_int8 with x and out f32.
extern "C" int msa_ffn_fused_int8_f32(const void* x, const void* w1, const void* s1, const void* b1, const void* w2,
                                      const void* s2, const void* b2, void* xq, void* xs, void* hidden, void* hq,
                                      void* hs, void* out, void* ws, void* counters, void* amax, int M, int D, int F,
                                      int plan_in, int plan_out, void* stream) {
  return ffn_int8<float>(x, w1, s1, b1, w2, s2, b2, xq, xs, hidden, hq, hs, out, ws, counters, amax, M, D, F, plan_in,
                         plan_out, stream);
}

// The int8 GEMM of rows 7 and 9 on its own: c [M, N] f32 = (f32(a·wᵀ)·rs)·cs
// + bias, a [M, K] int8, w [N, K] int8, rs [M], cs [N], bias [N] f32, on
// the given plan; ws and counters as above. With amax (int32 [M], zero),
// fc_in's epilogue: c = gelu(...), each row's max |c| into amax.
extern "C" int msa_gemm_s8(const void* a, const void* w, const void* rs, const void* cs, const void* bias, void* c,
                           void* ws, void* counters, void* amax, int M, int N, int K, int plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      amax ? launch_gemm_s8<true, float>(a, w, rs, cs, bias, c, M, N, K, plan, ws, counters, s, 0, 0, amax)
           : launch_gemm_s8<false, float>(a, w, rs, cs, bias, c, M, N, K, plan, ws, counters, s);
  return static_cast<int>(e);
}

extern "C" const char* msa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
