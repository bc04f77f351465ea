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
// Three launches, all hand-written: the WMMA GEMM of gemm.cuh for the fused
// QKV projection, one attention kernel per (64-row query tile, head, batch
// row), and the GEMM again for Wo.
//
// Any head dim D: the core's head dim is a template parameter DP ∈
// {32, 64, 128} (above 128, DP is a multiple of 128 and the D-tiled kernel
// of attention_wide.cu takes the core's place, in its order of rounding),
// and a D below its DP (24, 48, 96, ...) is served by
// weights padded once when they are derived (ops/kernels/attention.py
// pad_block_weights): each head's rows of Wqkv and bqkv are zero-padded to
// DP, and Wo gets zero columns for the padded dims. The padded q and k
// columns add exactly 0 to the scores, the padded v columns give output
// columns that are exactly 0, and Wo's zero columns drop them; the scale
// stays 1/√D of the unpadded D. So the projection buffer is [B·T, 3·H·DP]
// and the attention output [B·T, H·DP]. Shared memory at DP = 128 and
// T = 512: 174 KB a block (the 64 × T score rows are 129 KB of it), under
// the 227 KB an H100 block may take, so the 64 query rows a block stay.
//
// What bounds it on the card: at B=2, T_pad=512, d 768 it is ~6.4 GFLOP
// (QKV 3.6, scores 0.8, P·V 0.8, Wo 1.2) over ~7.9 MB of compulsory traffic:
// tensor-core bound. The design keeps the whole score row block of a tile
// (64 × T_pad f32, ≤ 130 KB) in shared memory so the softmax statistics are
// exact over the full row, as in the TPU kernel, instead of an online
// softmax whose rescaling would round P differently. The q/k/v and
// attention-output tensors make one round trip through device memory
// between the launches; fusing them away is work still to come.
//
// msa_attention_block_f32 is the f32 variant (the parity mode's encoders,
// compute_dtype="float32"; the same pallas_call at :819 with f32 operands,
// where JAX rounds nothing: every dot is f32, P·V unnormalised, then
// o/denom). Three launches: the shared f32 SIMT GEMM (gemm_f32.cuh, exact
// FMA, no TF32) for x·Wqkvᵀ + bqkv into the [B·T, 3·H·DP] buffer, which is
// the packed layout [B, T, 3, H, DP]; row 1's one-pass f32 core
// (attention_fused.cu, attend_f32) on it, which divides by the denominator
// after P·V as well, its online rescale moving only f32 rounding; the GEMM
// again for attn·Woᵀ + bo. At B=2, T_pad=512, d 768 that is 6.4 GFLOP of
// f32 FMA, 0.1 ms at 67 TFLOP/s.
//
// msa_attention_block_int8 replaces the W8A8 variant (attention_block(
// int8=True), pallas_call at :779, body _attn_block_body :574-695, wrapper
// :760-815) with five launches: quantize the rows of x (quant.cu); the int8
// QKV GEMM of gemm_s8.cuh with the epilogue acc·xs·s + b (acc·s·xs + b for
// K, as on the TPU), rounded to bf16; the same attention core as above
// (score and P·V dots stay bf16, as on the TPU); quantize the rows of the
// bf16 attention output over all heads, padded columns included (zeros
// move no row's amax, so the codes and scales are those of the unpadded
// output; its row amax needs every head, so
// it sits between the core and the Wo GEMM); the int8 Wo GEMM with
// acc·as·so + bo, rounded to bf16. At B=2, T_pad=512 the projections are
// 4.8 G int8 operations and the two attention dots 3.2 GFLOP of bf16:
// tensor-core bound, at 1,979 TOPS and 989 TFLOP/s respectively.
#include "attention_mma.cuh"
#include "gemm_f32.cuh"
#include "gemm_s8.cuh"

namespace {

constexpr int AQ = 64;            // query rows per block
constexpr int AK = 64;            // keys per shared-memory chunk
constexpr int LDP = AK + 8;       // padded bf16 row of the P chunk, 144 bytes
constexpr int ATHREADS = 128;     // 4 warps, 16 query rows each

template <int DP>
size_t attn_smem_bytes(int T) {
  return (size_t)(AQ + AK) * (DP + 8) * sizeof(bf16)  // sQ, sKV
         + (size_t)AQ * LDP * sizeof(bf16)            // sP
         + (size_t)AQ * (T + 4) * sizeof(float)       // sS: scores, then P, then staging
         + (size_t)T * sizeof(float)                  // additive mask bias
         + (size_t)AQ * sizeof(float);                // row denominators
}

// qkv [B·T, 3·HD] bf16 (HD = H·DP; q, k, v of head h at columns h·DP,
// HD + h·DP, 2·HD + h·DP), mask [B, T] f32 → attn [B·T, HD] bf16
template <int DP>
__global__ void __launch_bounds__(ATHREADS)
attn_core_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask, bf16* __restrict__ attn,
                 int T, int HD, float scale) {
  constexpr int LDH = DP + 8;     // padded bf16 row of Q, K and V
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sKV = sQ + AQ * LDH;
  bf16* sP = sKV + AK * LDH;
  const int LDS = T + 4;
  float* sS = reinterpret_cast<float*>(sP + AQ * LDP);
  float* sBias = sS + AQ * LDS;
  float* sDen = sBias + T;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * AQ, h = blockIdx.y, b = blockIdx.z;
  const size_t ld = 3 * (size_t)HD;  // qkv row stride
  const bf16* base = qkv + (size_t)b * T * ld;

  for (int i = tid; i < T; i += ATHREADS) sBias[i] = mask[(size_t)b * T + i] > 0.f ? 0.f : -1e9f;
  for (int i = tid; i < AQ * DP / 8; i += ATHREADS) {
    const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
    *reinterpret_cast<uint4*>(sQ + r * LDH + c) =
        *reinterpret_cast<const uint4*>(base + (size_t)(q0 + r) * ld + h * DP + c);
  }

  // S = Q·Kᵀ (raw f32 dots) for this warp's 16 rows, one 64-key chunk at a time
  float* sSw = sS + warp * 16 * LDS;
  for (int kc = 0; kc < T; kc += AK) {
    __syncthreads();
    for (int i = tid; i < AK * DP / 8; i += ATHREADS) {
      const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
      *reinterpret_cast<uint4*>(sKV + r * LDH + c) =
          *reinterpret_cast<const uint4*>(base + (size_t)(kc + r) * ld + HD + h * DP + c);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < AK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kt;
        wmma::load_matrix_sync(a, sQ + warp * 16 * LDH + kk, LDH);
        wmma::load_matrix_sync(kt, sKV + j * 16 * LDH + kk, LDH);
        wmma::mma_sync(acc, a, kt, acc);
      }
      wmma::store_matrix_sync(sSw + kc + j * 16, acc, LDS, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // softmax statistics over the full row, in f32: s = S·scale + bias,
  // P = exp(s − max), denom = Σ P (P kept unrounded in sS)
  for (int r = 0; r < 16; ++r) {
    float* row = sSw + r * LDS;
    float m = -3.402823466e38f;  // -FLT_MAX
    for (int c = lane; c < T; c += 32) {
      const float s = row[c] * scale + sBias[c];
      row[c] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int c = lane; c < T; c += 32) {
      const float p = expf(row[c] - m);
      row[c] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) sDen[warp * 16 + r] = sum;
  }
  __syncwarp();

  // O = P_bf16 · V, 64 keys at a time
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[DP / 16];
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) wmma::fill_fragment(o[j], 0.0f);
  bf16* sPw = sP + warp * 16 * LDP;
  for (int kc = 0; kc < T; kc += AK) {
    __syncthreads();  // every warp is done with sKV
    for (int i = tid; i < AK * DP / 8; i += ATHREADS) {
      const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
      *reinterpret_cast<uint4*>(sKV + r * LDH + c) =
          *reinterpret_cast<const uint4*>(base + (size_t)(kc + r) * ld + 2 * HD + h * DP + c);
    }
    for (int i = lane; i < 16 * AK; i += 32) {
      const int r = i / AK, c = i % AK;
      sPw[r * LDP + c] = __float2bfloat16(sSw[r * LDS + kc + c]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < AK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> p;
      wmma::load_matrix_sync(p, sPw + kk, LDP);
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> v;
        wmma::load_matrix_sync(v, sKV + kk * LDH + j * 16, LDH);
        wmma::mma_sync(o[j], p, v, o[j]);
      }
    }
  }

  // o / denom → bf16, written at this head's columns of attn [B·T, HD]
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) wmma::store_matrix_sync(sSw + j * 16, o[j], LDS, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * DP / 8; i += 32) {
    const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
    const float den = sDen[warp * 16 + r];
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(sSw[r * LDS + c + e] / den);
    *reinterpret_cast<uint4*>(attn + ((size_t)b * T + q0 + warp * 16 + r) * HD + h * DP + c) =
        *reinterpret_cast<const uint4*>(v);
  }
}

template <int DP>
cudaError_t launch_core_dp(const bf16* qkv, const float* mask, bf16* attn, int B, int T, int H, float scale,
                           cudaStream_t s) {
  const size_t smem = attn_smem_bytes<DP>(T);
  cudaError_t e = cudaFuncSetAttribute(attn_core_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  attn_core_kernel<DP><<<dim3(T / AQ, H, B), ATHREADS, smem, s>>>(qkv, mask, attn, T, H * DP, scale);
  return cudaGetLastError();
}

// the core at the head dim DP the (padded) weights give
cudaError_t launch_core(const void* qkv, const void* mask, void* attn, int B, int T, int H, int DP, float scale,
                        cudaStream_t s) {
  auto q = static_cast<const bf16*>(qkv);
  auto m = static_cast<const float*>(mask);
  auto a = static_cast<bf16*>(attn);
  switch (DP) {
    case 32: return launch_core_dp<32>(q, m, a, B, T, H, scale, s);
    case 64: return launch_core_dp<64>(q, m, a, B, T, H, scale, s);
    case 128: return launch_core_dp<128>(q, m, a, B, T, H, scale, s);
    default: {  // DP a multiple of 128 above 128: the D-tiled kernel, in this order
      if (DP < 128 || DP % 128) return cudaErrorInvalidValue;
      const int HD = H * DP;
      return static_cast<cudaError_t>(attend_wide(q, q + HD, q + 2 * HD, 3 * T * HD, DP, 3 * HD, mask, attn, T * HD,
                                                  DP, HD, nullptr, B, T, H, DP, scale, 1, kUnnormalised, s));
    }
  }
}

}  // namespace

// x [B·T, DM] bf16, wqkv [3·H·DP, DM] bf16, bqkv [3·H·DP] f32, wout
// [DM, H·DP] bf16, bout [DM] f32, mask [B, T] f32; scratch qkv
// [B·T, 3·H·DP] and attn [B·T, H·DP] bf16; out [B·T, DM] bf16. T % 64 == 0,
// DP 32, 64 or a multiple of 128 (the weights padded per head to DP),
// DM % 128 == 0.
extern "C" int msa_attention_block(const void* x, const void* wqkv, const void* bqkv, const void* wout,
                                   const void* bout, const void* mask, void* qkv, void* attn, void* out, int B,
                                   int T, int DM, int H, int DP, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T, HD = H * DP;
  cudaError_t e = launch_gemm_nt<false, float>(static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
                                               static_cast<const float*>(bqkv), static_cast<bf16*>(qkv), M,
                                               3 * HD, DM, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_core(qkv, mask, attn, B, T, H, DP, scale, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_gemm_nt<false, float>(static_cast<const bf16*>(attn), static_cast<const bf16*>(wout),
                                   static_cast<const float*>(bout), static_cast<bf16*>(out), M, DM, HD, s);
  return static_cast<int>(e);
}

// As msa_attention_block, all in f32 (x, weights, biases, scratch qkv,
// attn and out), with two more scratch buffers: lse [B, H, T] f32, which
// the f32 core writes, and ws, the GEMMs' split-K workspace
// (msa_gemm_f32_workspace_elems floats). DP 32, 64 or a multiple of 128, T % 128 == 0,
// DM % 128 == 0.
extern "C" int msa_attention_block_f32(const void* x, const void* wqkv, const void* bqkv, const void* wout,
                                       const void* bout, const void* mask, void* qkv, void* attn, void* lse, void* out,
                                       void* ws, int B, int T, int DM, int H, int DP, float scale, void* stream) {
  if (DP != 32 && DP != 64 && DP % 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T, HD = H * DP;
  float* w = static_cast<float*>(ws);
  cudaError_t e = launch_gemm_f32<true>(static_cast<const float*>(x), static_cast<const float*>(wqkv),
                                        static_cast<const float*>(bqkv), static_cast<float*>(qkv), M, 3 * HD, DM, DM,
                                        false, s, 1, 0, 0, w);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* q = static_cast<const float*>(qkv);
  // the [B·T, 3·HD] buffer is the packed layout [B, T, 3, H, DP]
  const int rc = attend_f32(q, q + HD, q + 2 * HD, 3 * T * HD, DP, 3 * HD, mask, attn, T * HD, DP, HD, lse, B, T, H,
                            DP, scale, stream);
  if (rc) return rc;
  e = launch_gemm_f32<true>(static_cast<const float*>(attn), static_cast<const float*>(wout),
                            static_cast<const float*>(bout), static_cast<float*>(out), M, DM, HD, HD, false, s, 1, 0, 0,
                            w);
  return static_cast<int>(e);
}

// x [B·T, DM] bf16; wqkv [3·H·DP, DM] int8 with per-row (output channel)
// scales sqkv [3·H·DP] f32 (1.0 on padded channels) and bias bqkv
// [3·H·DP] f32; wout [DM, H·DP] int8 with sout [DM] f32 and bout [DM] f32;
// mask [B, T] f32. Scratch: xq [B·T, DM] int8, xs [B·T] f32, qkv
// [B·T, 3·H·DP] bf16, attn [B·T, H·DP] bf16, aq [B·T, H·DP] int8, as [B·T]
// f32. out [B·T, DM] bf16. T % 64 == 0, DP 32, 64 or a multiple of 128,
// DM % 128 == 0.
extern "C" int msa_attention_block_int8(const void* x, const void* wqkv, const void* sqkv, const void* bqkv,
                                        const void* wout, const void* sout, const void* bout, const void* mask,
                                        void* xq, void* xs, void* qkv, void* attn, void* aq, void* as, void* out,
                                        int B, int T, int DM, int H, int DP, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T, HD = H * DP;
  int rc = msa_quantize_rows(x, 1, xq, xs, M, DM, stream);
  if (rc) return rc;
  cudaError_t e = launch_gemm_s8<false, bf16>(static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wqkv),
                                              static_cast<const float*>(xs), static_cast<const float*>(sqkv),
                                              static_cast<const float*>(bqkv), static_cast<bf16*>(qkv), M, 3 * HD,
                                              DM, s, HD, 2 * HD);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_core(qkv, mask, attn, B, T, H, DP, scale, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  rc = msa_quantize_rows(attn, 1, aq, as, M, HD, stream);
  if (rc) return rc;
  e = launch_gemm_s8<false, bf16>(static_cast<const int8_t*>(aq), static_cast<const int8_t*>(wout),
                                  static_cast<const float*>(as), static_cast<const float*>(sout),
                                  static_cast<const float*>(bout), static_cast<bf16*>(out), M, DM, HD, s);
  return static_cast<int>(e);
}
