// attention_block for Hopper: one encoder layer's attention block,
//   out = concat_h( softmax(q_h·k_hᵀ·scale + mask_bias) · v_h ) · Woᵀ + bo,
// with q/k/v = x·Wqkvᵀ + bqkv, in bf16 with f32 accumulation.
//
// Replaces msa_tpu/ops/pallas/attention.py:attention_block, bf16/f32
// variant (pallas_call at :819, body _attn_block_body :574-695). Same
// rounding points: q, k and v are projected in f32 (+ f32 bias) and rounded
// to bf16; scores accumulate in f32; the mask adds −1e9 (not −inf), so a row
// whose keys are all masked stays finite (it averages every key, exactly as
// the TPU kernel does); P = exp(s − rowmax) is summed in f32 and rounded to
// bf16 for P·V; the division by the denominator comes after P·V, and o/denom
// is rounded to bf16 before the output projection.
//
// Three launches, all hand-written: the bf16 wgmma GEMM of gemm_bf16.cuh
// (through msa_gemm_bf16) for the fused QKV projection, the attention
// core, and the GEMM again for Wo, each GEMM on the tile and K split the
// planner picked (ops/kernels/gemm_plan.py).
//
// Any head dim D: the core's head dim is DP ∈ {32, 64, 128} (above 128,
// DP is a multiple of 128 and the tensor-core kernel of
// attention_wide_mma.cu takes the bf16 core's place, the wide f32
// kernel of attention_wide.cu the f32 one's, in its order of rounding),
// and a D below its DP
// (24, 48, 96, ...) is served by
// weights padded once when they are derived (ops/kernels/attention.py
// pad_block_weights): each head's rows of Wqkv and bqkv are zero-padded to
// DP, and Wo gets zero columns for the padded dims. The padded q and k
// columns add exactly 0 to the scores, the padded v columns give output
// columns that are exactly 0, and Wo's zero columns drop them; the scale
// stays 1/√D of the unpadded D. So the projection buffer is [B·T, 3·H·DP]
// and the attention output [B·T, H·DP].
//
// What bounds it on the card: at B=2, T_pad=512, d 768 it is ~6.4 GFLOP
// (QKV 3.6, scores 0.8, P·V 0.8, Wo 1.2) over ~7.9 MB of compulsory traffic:
// tensor-core bound. The core is the two-pass register-resident one of
// rows 5 and 2 (attention_packed.cu on attention_mma.cuh, through
// attend_unnormalised), in this kernel's order: pass 1 streams K and keeps
// the exact row max m and the denominator l online (l rescaled by
// exp(m_old − m_new), so it differs from Σ exp(s − m) only by f32
// rounding); pass 2 recomputes the scores, packs bf16(exp(s − m)) into the
// P·V fragments and accumulates P·V in f32 with no rescaling; o / l comes
// after P·V and is rounded to bf16 once. It reads q, k and v by element
// strides out of the projection buffer (q of head h at column h·DP, k at
// H·DP + h·DP, v at 2·H·DP + h·DP) and writes [B·T, H·DP]; K and V come
// through a two-stage cp.async ring, 64 keys a stage, so its shared memory
// (45.5 KB at DP = 64) does not grow with T. The q/k/v and
// attention-output tensors make one round trip through device memory
// between the launches; fusing them away is work still to come.
//
// msa_attention_block_f32 is the f32 variant (the parity mode's encoders,
// compute_dtype="float32"; the same pallas_call at :819 with f32 operands,
// where JAX rounds nothing: every dot is f32, P·V unnormalised, then
// o/denom). Three launches: the shared f32 SIMT GEMM (gemm_f32.cuh through
// msa_gemm_f32, exact FMA, no TF32, on the planner's tile and stream-K
// grid) for x·Wqkvᵀ + bqkv into the [B·T, 3·H·DP] buffer, which is
// the packed layout [B, T, 3, H, DP]; row 1's one-pass f32 core
// (attention_fused.cu, attend_f32) on it, which divides by the denominator
// after P·V as well, its online rescale moving only f32 rounding; the GEMM
// again for attn·Woᵀ + bo. At B=2, T_pad=512, d 768 that is 6.4 GFLOP of
// f32 FMA, 0.1 ms at 67 TFLOP/s.
//
// msa_attention_block_int8 replaces the W8A8 variant (attention_block(
// int8=True), pallas_call at :779, body _attn_block_body :574-695, wrapper
// :760-815) with a chain of five launches, the last four under
// programmatic dependent launch (attention_block_int8 below says how each
// waits): quantize the rows of x (quant.cu); the int8
// QKV GEMM of gemm_s8.cuh with the epilogue acc·xs·s + b (acc·s·xs + b for
// K, as on the TPU), rounded to bf16, on the tile and K split the planner
// picked (ops/kernels/gemm_s8.py); the same attention core as above
// (score and P·V dots stay bf16, as on the TPU); quantize the rows of the
// bf16 attention output over all heads, padded columns included (zeros
// move no row's amax, so the codes and scales are those of the unpadded
// output; its row amax needs every head, so
// it sits between the core and the Wo GEMM); the int8 Wo GEMM with
// acc·as·so + bo, rounded to bf16, on its own plan. At B=2, T_pad=512 the
// projections are
// 4.8 G int8 operations and the two attention dots 3.2 GFLOP of bf16:
// tensor-core bound, at 1,979 TOPS and 989 TFLOP/s respectively.
//
// msa_attention_block_int8_f32 is the same W8A8 kernel under f32 compute
// (compute_dtype="float32", quantize="int8"), where the TPU kernel runs
// its dots in o_ref.dtype = f32 and rounds nothing to bf16: the same five
// launches on f32 x, the QKV epilogue writing an f32 [B·T, 3·H·DP] buffer,
// row 8 f32's core (attend_f32, row 1's one-pass f32 core in
// attention_fused.cu, which also divides by the denominator after P·V; its
// online rescale moves only f32 rounding) on it, the f32 attention output
// quantized over all heads, and the Wo GEMM writing f32. At B=2,
// T_pad=512: 4.8 G int8 operations and 1.6 GFLOP of f32 FMA (24 µs at
// 67 TFLOP/s), so the f32 core bounds it.
#include "attention_mma.cuh"
#include "gemm_bf16.cuh"
#include "gemm_f32.cuh"
#include "gemm_s8.cuh"

namespace {

// the core at the head dim DP the (padded) weights give, on qkv
// [B·T, 3·H·DP] → attn [B·T, H·DP]; pdl: launched under programmatic
// dependent launch (the int8 chain)
cudaError_t launch_core(const void* qkv, const void* mask, void* attn, int B, int T, int H, int DP, float scale,
                        cudaStream_t s, bool pdl = false) {
  const int HD = H * DP;
  auto q = static_cast<const bf16*>(qkv);
  return static_cast<cudaError_t>(attend_unnormalised(q, q + HD, q + 2 * HD, 3 * T * HD, DP, 3 * HD, mask, attn,
                                                      T * HD, DP, HD, B, T, H, DP, scale, s, pdl));
}

// the W8A8 block in the compute dtype E of x, qkv, attn and out (bf16, or
// f32 with the f32 core, which writes lse), a chain of five launches: the
// first in plain stream order behind whatever came before, the other four
// under programmatic dependent launch (gemm.cuh). Each of those waits
// (pdl_wait) before its first read of its predecessor's output and before
// any touch of the scratch the chain shares: the QKV and Wo GEMMs' split-K
// workspace and counters, and above DP = 128 the f32 core's tickets and
// workspace. Only the GEMMs' first k-tiles of W come before the wait.
template <typename E>
int attention_block_int8(const void* x, const void* wqkv, const void* sqkv, const void* bqkv, const void* wout,
                         const void* sout, const void* bout, const void* mask, void* xq, void* xs, void* qkv,
                         void* attn, void* lse, void* aq, void* as, void* out, void* ws, void* counters, int B, int T,
                         int DM, int H, int DP, int plan_qkv, int plan_out, int wplan, void* wtickets, void* wws,
                         float scale, void* stream) {
  constexpr int is_bf16 = sizeof(E) == 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T, HD = H * DP;
  int rc = quantize_rows_launch(x, is_bf16, xq, xs, M, DM, s, false);
  if (rc) return rc;
  cudaError_t e = launch_gemm_s8<false, E>(xq, wqkv, xs, sqkv, bqkv, qkv, M, 3 * HD, DM, plan_qkv, ws, counters, s, HD,
                                           2 * HD, nullptr, true);
  if (e != cudaSuccess) return static_cast<int>(e);
  if constexpr (is_bf16) {
    rc = static_cast<int>(launch_core(qkv, mask, attn, B, T, H, DP, scale, s, true));
  } else {  // the [B·T, 3·HD] buffer is the packed layout [B, T, 3, H, DP]
    const float* q = static_cast<const float*>(qkv);
    rc = attend_f32(q, q + HD, q + 2 * HD, 3 * T * HD, DP, 3 * HD, mask, attn, T * HD, DP, HD, lse, B, T, H, DP, scale,
                    wplan, wtickets, wws, stream, true);
  }
  if (rc) return rc;
  rc = quantize_rows_launch(attn, is_bf16, aq, as, M, HD, s, true);
  if (rc) return rc;
  e = launch_gemm_s8<false, E>(aq, wout, as, sout, bout, out, M, DM, HD, plan_out, ws, counters, s, 0, 0, nullptr,
                               true);
  return static_cast<int>(e);
}

bool bad_block_dp(int DP) { return DP != 32 && DP != 64 && DP % 128; }

}  // namespace

// x [B·T, DM] bf16, wqkv [3·H·DP, DM] bf16, bqkv [3·H·DP] f32, wout
// [DM, H·DP] bf16, bout [DM] f32, mask [B, T] f32; scratch qkv
// [B·T, 3·H·DP] and attn [B·T, H·DP] bf16; out [B·T, DM] bf16; ws and
// counters: the bf16 GEMM's split-K partials and per-tile counters (zero
// at rest); plan_qkv and plan_out: the two GEMMs' plans (bm | bn << 10 |
// splits << 20, ops/kernels/gemm_plan.py). T ≤ 512, DP 32, 64 or a
// multiple of 128 (the weights padded per head to DP), DM % 128 == 0.
extern "C" int msa_attention_block(const void* x, const void* wqkv, const void* bqkv, const void* wout,
                                   const void* bout, const void* mask, void* qkv, void* attn, void* out, void* ws,
                                   void* counters, int B, int T, int DM, int H, int DP, int plan_qkv, int plan_out,
                                   float scale, void* stream) {
  if (bad_block_dp(DP)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T, HD = H * DP;
  int rc = msa_gemm_bf16(x, wqkv, bqkv, 0, qkv, ws, counters, M, 3 * HD, DM, plan_qkv, 0, stream);
  if (rc) return rc;
  rc = static_cast<int>(launch_core(qkv, mask, attn, B, T, H, DP, scale, s));
  if (rc) return rc;
  return msa_gemm_bf16(attn, wout, bout, 0, out, ws, counters, M, DM, HD, plan_out, 0, stream);
}

// As msa_attention_block, all in f32 (x, weights, biases, scratch qkv,
// attn and out), with the f32 core's lse [B, H, T] f32 scratch before out;
// ws, counters and the plans are the f32 GEMM's (stream-K partials,
// per-tile counters zero at rest, bm | bn << 10 | ctas << 20); wplan,
// wtickets and wws the wide core's above DP = 128 (attend_wide's plan,
// tickets and workspace). DP 32, 64 or a multiple of 128, T % 128 == 0,
// DM % 128 == 0.
extern "C" int msa_attention_block_f32(const void* x, const void* wqkv, const void* bqkv, const void* wout,
                                       const void* bout, const void* mask, void* qkv, void* attn, void* lse, void* out,
                                       void* ws, void* counters, int B, int T, int DM, int H, int DP, int plan_qkv,
                                       int plan_out, int wplan, void* wtickets, void* wws, float scale, void* stream) {
  if (bad_block_dp(DP)) return static_cast<int>(cudaErrorInvalidValue);
  const int M = B * T, HD = H * DP;
  int rc = msa_gemm_f32(x, wqkv, bqkv, qkv, ws, counters, M, 3 * HD, DM, DM, 1, 1, 0, 0, plan_qkv, 0, stream);
  if (rc) return rc;
  const float* q = static_cast<const float*>(qkv);
  // the [B·T, 3·HD] buffer is the packed layout [B, T, 3, H, DP]
  rc = attend_f32(q, q + HD, q + 2 * HD, 3 * T * HD, DP, 3 * HD, mask, attn, T * HD, DP, HD, lse, B, T, H, DP, scale,
                  wplan, wtickets, wws, stream);
  if (rc) return rc;
  return msa_gemm_f32(attn, wout, bout, out, ws, counters, M, DM, HD, HD, 1, 1, 0, 0, plan_out, 0, stream);
}

// x [B·T, DM] bf16; wqkv [3·H·DP, DM] int8 with per-row (output channel)
// scales sqkv [3·H·DP] f32 (1.0 on padded channels) and bias bqkv
// [3·H·DP] f32; wout [DM, H·DP] int8 with sout [DM] f32 and bout [DM] f32;
// mask [B, T] f32. Scratch: xq [B·T, DM] int8, xs [B·T] f32, qkv
// [B·T, 3·H·DP] bf16, attn [B·T, H·DP] bf16, aq [B·T, H·DP] int8, as [B·T]
// f32. out [B·T, DM] bf16. ws and counters: the int8 GEMM's split-K
// workspace and per-tile counters (int32, the counters zero at rest);
// plan_qkv and plan_out: the two GEMMs' plans (bm | bn << 10 | splits << 20,
// ops/kernels/gemm_s8.py). T ≤ 512, DP 32, 64 or a multiple of 128,
// DM % 128 == 0.
extern "C" int msa_attention_block_int8(const void* x, const void* wqkv, const void* sqkv, const void* bqkv,
                                        const void* wout, const void* sout, const void* bout, const void* mask,
                                        void* xq, void* xs, void* qkv, void* attn, void* aq, void* as, void* out,
                                        void* ws, void* counters, int B, int T, int DM, int H, int DP, int plan_qkv,
                                        int plan_out, float scale, void* stream) {
  if (bad_block_dp(DP)) return static_cast<int>(cudaErrorInvalidValue);
  return attention_block_int8<bf16>(x, wqkv, sqkv, bqkv, wout, sout, bout, mask, xq, xs, qkv, attn, nullptr, aq, as,
                                    out, ws, counters, B, T, DM, H, DP, plan_qkv, plan_out, 0, nullptr, nullptr, scale,
                                    stream);
}

// As msa_attention_block_int8 under f32 compute: x, the scratch qkv and
// attn, and out f32, with the f32 core's lse [B, H, T] f32 scratch after
// attn; wplan, wtickets and wws the wide core's, as msa_attention_block_f32's.
extern "C" int msa_attention_block_int8_f32(const void* x, const void* wqkv, const void* sqkv, const void* bqkv,
                                            const void* wout, const void* sout, const void* bout, const void* mask,
                                            void* xq, void* xs, void* qkv, void* attn, void* lse, void* aq, void* as,
                                            void* out, void* ws, void* counters, int B, int T, int DM, int H, int DP,
                                            int plan_qkv, int plan_out, int wplan, void* wtickets, void* wws,
                                            float scale, void* stream) {
  if (bad_block_dp(DP)) return static_cast<int>(cudaErrorInvalidValue);
  return attention_block_int8<float>(x, wqkv, sqkv, bqkv, wout, sout, bout, mask, xq, xs, qkv, attn, lse, aq, as, out,
                                     ws, counters, B, T, DM, H, DP, plan_qkv, plan_out, wplan, wtickets, wws, scale,
                                     stream);
}
