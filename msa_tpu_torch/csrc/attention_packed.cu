// packed_qkv_attention and mha_attention for Hopper: single-pass attention,
// T ≤ 512, bf16 → o bf16 and the row logsumexp lse [B, H, T] f32, on one
// core that reads q, k and v and writes o through element strides (batch,
// head, time; D contiguous). Two C entry points:
//
// - msa_packed_qkv_attention (row 5): q, k and v strided out of the fused
//   QKV projection, qkv [B, T, 3, H, D], and o [B, T, H·D]. Replaces
//   msa_tpu/ops/pallas/attention.py:_packed_qkv_attention_lse (pallas_call
//   at :489, kernel _packed_qkv_kernel :425-462), which JAX's encoder takes
//   where attention_block cannot (d_model % 128 ≠ 0) and in training at
//   T ≤ 512.
// - msa_mha_attention (row 2): q, k, v and o [B, H, T, D]. Replaces
//   _mha_attention_lse (pallas_call at :150, kernel _mha_kernel :87-128),
//   the forward of attention_with_vjp at T ≤ 512. It computes the same
//   function as row 5 in another layout (JAX copies Kᵀ to [B, H, D, T] for
//   the TPU's matrix unit; here K is read in place).
// - row 1's bf16 path (msa_fused_attention, attention_fused.cu) calls the
//   same core through attend_heads_first, at any T.
// - the attention core of rows 7 and 8 (attention.cu) calls it through
//   attend_unnormalised, in their order of rounding (below).
//
// Same rounding points as the TPU kernels: scores accumulate in f32 from
// bf16 q and k, s = S·scale + bias with bias −1e9 on masked keys (a row with
// no valid key stays finite and averages V over every padded row); the
// exact row max m; P is normalised BEFORE the P·V product, (p / denom)
// rounded to bf16 (attention_block rounds the unnormalised P and divides
// after); o accumulates in f32 and is rounded once; lse = m + log(denom).
// The denominator is summed online: l is rescaled by exp(m_old − m_new)
// when the max moves, so it differs from Σ exp(s − m) only by f32
// rounding. T is padded to a multiple of 128 (rows past T read as zeros
// under masked keys; the query rows past T are not written). D is any
// multiple of 8 up to 128, zero-padded to DP (32, 64 or 128) by the copies;
// above 128 the entries call attend_wide_mma (attention_wide_mma.cu), in
// the same order.
//
// What bounds it on the card: per (row, head) 4·T²·D operations on
// 3·T·D·2 bytes read and T·D·2 + 4·T written. At the encoder's shape
// (B=2, T=512, H=12, D=64) that is 1.6 GFLOP (1.6 µs at 989 TFLOP/s) over
// 6.3 MB (1.9 µs at 3.35 TB/s); at the text training step's (B=8) 6.4
// GFLOP (6.5 µs) over 25 MB (7.5 µs): about balanced, near both bounds.
// The custom widths of the serving path (D=24, T=40) are tiny and bound by
// the launch.
//
// The design (attention_mma.cuh): one block per (64-query tile, head,
// batch row), 4 warps of 16 query rows, two passes over 64-key tiles.
// Pass 1 streams K only and keeps the row max and the denominator online;
// pass 2 streams K and V, recomputes the scores, forms bf16(exp(s − m) / l)
// in registers (the quotient correctly rounded from a per-row reciprocal,
// div_rn) and accumulates P·V with no rescaling. The scores therefore
// never need a row in shared memory (6·T²·D operations instead of 4·T²·D,
// the bound still counts 4). Q's fragments, the 16 × 64 score tile, m, l
// and the output accumulator live in registers (mma.sync.m16n8k16 with
// operands from ldmatrix); P goes from the score registers straight into
// the P·V product. The tiles come through a two-stage cp.async ring (K,
// V and the key mask of 64 keys a stage): tile i+1's copy flies while tile
// i's products run. 45.5 KB of shared memory a block at DP = 64, so several
// blocks share an SM.
//
// Rows 7 and 8 (attention_block[_int8], msa_tpu/ops/pallas/attention.py
// _attn_block_body :640-686) round elsewhere: pass 2 packs the
// UNNORMALISED bf16(exp(s − m)) into the P·V fragments, and o is divided by
// l after P·V (o / l correctly rounded), then rounded to bf16 once; no lse.
// The kernel's template parameter UNNORM picks that order; the rest is
// shared. There q, k and v come strided out of the [B·T, 3·H·DP]
// projection buffer and o goes to [B·T, H·DP], so the shared memory a
// block takes does not grow with T. In row 7's int8 chain the kernel is
// launched under programmatic dependent launch (gemm.cuh): pdl_wait comes
// before its first read of q, k and v, pdl_trigger after its last load;
// launched without the attribute (rows 1, 2, 5 and 8) both pass at once.
#include <climits>

#include "attention_mma.cuh"

namespace {

constexpr int PQ = 64;         // query rows per block
constexpr int PK = 64;         // keys per ring stage
constexpr int PTHREADS = 128;  // 4 warps, 16 query rows each

template <int DP>
constexpr size_t packed_smem_bytes() {
  return (size_t)(PQ + 4 * PK) * (DP + 8) * sizeof(bf16)  // sQ; sK, sV of two stages
         + (size_t)2 * PK * sizeof(float);                 // the key mask of two stages
}

template <int DP, bool UNNORM>
__global__ void __launch_bounds__(PTHREADS)
packed_qkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v, Strides lin,
                  const float* __restrict__ mask, bf16* __restrict__ out, Strides lout, float* __restrict__ lse,
                  int T, int T_pad, int H, int D, float scale) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + PQ * LD;                                   // [2][PK × LD]
  bf16* sV = sK + 2 * PK * LD;                               // [2][PK × LD]
  float* sMask = reinterpret_cast<float*>(sV + 2 * PK * LD);  // [2][PK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * PQ, h = blockIdx.y, b = blockIdx.z;
  const float* mrow = mask + (size_t)b * T;
  bf16* sQw = sQ + warp * 16 * LD;
  const int nt = T_pad / PK, steps = 2 * nt;

  // step i < nt brings K tile i (pass 1), step nt + i K and V tile i (pass 2)
  auto issue = [&](int step) {
    const int st = step & 1, t0 = (step < nt ? step : step - nt) * PK;
    load_tile_async<PK, DP, PTHREADS>(sK + st * PK * LD, k, lin, b, h, t0, T, D, tid);
    if (step >= nt) load_tile_async<PK, DP, PTHREADS>(sV + st * PK * LD, v, lin, b, h, t0, T, D, tid);
    load_vec_async<PK, PTHREADS>(sMask + st * PK, mrow, t0, T, tid);
    cp_async_commit();
  };
  // → the stage of step, landed for every thread, with step + 1's in flight
  auto arrive = [&](int step) {
    __syncthreads();  // every warp is done with the stage that step + 1 refills
    if (step + 1 < steps) {
      issue(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    return step & 1;
  };

  pdl_wait();  // in row 7's chain q, k and v are the QKV GEMM's output
  load_tile_async<PQ, DP, PTHREADS>(sQ, q, lin, b, h, q0, T, D, tid);
  issue(0);  // Q lands with the first K tile

  // pass 1: the exact row max m and the f32 denominator l, online
  uint32_t qf[DP / 16][4];
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};  // rows g and g + 8 of the lane
  for (int step = 0; step < nt; ++step) {
    const int st = arrive(step);
    if (step == 0) load_q_frags<DP>(qf, sQw, lane);
    float s[PK / 8][4], bm[2], sum[2] = {0.f, 0.f};
    tile_dots<PK, DP>(s, qf, sK + st * PK * LD, lane);
    score_epilogue<PK>(s, sMask + st * PK, scale, lane);
    tile_row_max<PK>(s, bm);
    const float mn[2] = {fmaxf(m[0], bm[0]), fmaxf(m[1], bm[1])};
#pragma unroll
    for (int n = 0; n < PK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e >> 1] += expf(s[n][e] - mn[e >> 1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * expf(m[r] - mn[r]) + quad_sum(sum[r]);
      m[r] = mn[r];
    }
  }

  // pass 2: O = bf16(exp(s − m) / l) · V, or bf16(exp(s − m)) · V, then / l
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
  float o[DP / 8][4] = {};
  for (int step = nt; step < steps; ++step) {
    const int st = arrive(step);
    float s[PK / 8][4];
    tile_dots<PK, DP>(s, qf, sK + st * PK * LD, lane);
    score_epilogue<PK>(s, sMask + st * PK, scale, lane);
#pragma unroll
    for (int n = 0; n < PK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e >> 1]);
        s[n][e] = UNNORM ? p : div_rn(p, l[e >> 1], rl[e >> 1]);
      }
    }
    uint32_t pf[PK / 16][4];
    p_frags<PK>(pf, s);
    tile_pv<PK, DP, LD>(o, pf, sV + st * PK * LD, lane);
  }
  pdl_trigger();  // every load is in
  if constexpr (UNNORM) {
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = __fdiv_rn(o[n][e], l[e >> 1]);
    }
  }

  const float row_lse[2] = {m[0] + logf(l[0]), m[1] + logf(l[1])};
  store_rows<DP>(o, row_lse, sQw, out, lout, lse, b, h, H, q0 + warp * 16, T, D, lane);
}

template <int DP, bool UNNORM>
cudaError_t launch_packed(const bf16* q, const bf16* k, const bf16* v, Strides lin, const float* mask, bf16* out,
                          Strides lout, float* lse, int B, int T, int H, int D, float scale, cudaStream_t s, bool pdl) {
  const int T_pad = (T + 127) / 128 * 128;
  constexpr size_t smem = packed_smem_bytes<DP>();
  cudaError_t e =
      cudaFuncSetAttribute(packed_qkv_kernel<DP, UNNORM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return launch_k(pdl, packed_qkv_kernel<DP, UNNORM>, dim3(T_pad / PQ, H, B), dim3(PTHREADS), smem, s, q, k, v, lin,
                  mask, out, lout, lse, T, T_pad, H, D, scale);
}

template <bool UNNORM>
cudaError_t launch_order(const bf16* q, const bf16* k, const bf16* v, Strides lin, const float* mask, bf16* out,
                         Strides lout, float* lse, int B, int T, int H, int D, float scale, cudaStream_t s, bool pdl) {
  // D is zero-padded to 32, 64 or 128 columns in shared memory
  return D <= 32   ? launch_packed<32, UNNORM>(q, k, v, lin, mask, out, lout, lse, B, T, H, D, scale, s, pdl)
         : D <= 64 ? launch_packed<64, UNNORM>(q, k, v, lin, mask, out, lout, lse, B, T, H, D, scale, s, pdl)
                   : launch_packed<128, UNNORM>(q, k, v, lin, mask, out, lout, lse, B, T, H, D, scale, s, pdl);
}

// max_t: 512 for rows 5, 2, 7 and 8, which mirror JAX's dispatch (longer
// inputs go to row 6); none for row 1. The two passes run at any T_pad.
// order: kNormBefore (rows 1, 2, 5) or kUnnormalised (rows 7, 8; lse null).
int attend(const void* q, const void* k, const void* v, Strides lin, const void* mask, void* out, Strides lout,
           void* lse, int B, int T, int H, int D, float scale, void* stream, int max_t = 512,
           int order = kNormBefore, bool pdl = false) {
  if (T < 1 || T > max_t || D % 8 || D < 8) return static_cast<int>(cudaErrorInvalidValue);
  if (D > 128)  // the tensor-core kernel above 128, in the same order
    return attend_wide_mma(q, k, v, lin.b, lin.h, lin.t, mask, out, lout.b, lout.h, lout.t, lse, B, T, H, D, scale,
                           order, 0, stream, 0, pdl);
  auto qp = static_cast<const bf16*>(q);
  auto kp = static_cast<const bf16*>(k);
  auto vp = static_cast<const bf16*>(v);
  auto m = static_cast<const float*>(mask);
  auto o = static_cast<bf16*>(out);
  auto l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = order == kUnnormalised
                            ? launch_order<true>(qp, kp, vp, lin, m, o, lout, l, B, T, H, D, scale, s, pdl)
                            : launch_order<false>(qp, kp, vp, lin, m, o, lout, l, B, T, H, D, scale, s, pdl);
  return static_cast<int>(e);
}

}  // namespace

int attend_heads_first(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse, int B,
                       int T, int H, int D, float scale, void* stream) {
  const Strides st{H * T * D, T * D, D};
  return attend(q, k, v, st, mask, out, st, lse, B, T, H, D, scale, stream, INT_MAX);
}

int attend_unnormalised(const void* q, const void* k, const void* v, int sb, int sh, int st, const void* mask,
                        void* out, int ob, int oh, int ot, int B, int T, int H, int D, float scale, void* stream,
                        bool pdl) {
  return attend(q, k, v, Strides{sb, sh, st}, mask, out, Strides{ob, oh, ot}, nullptr, B, T, H, D, scale, stream, 512,
                kUnnormalised, pdl);
}

// qkv [B, T, 3, H, D] bf16 (contiguous), mask [B, T] f32 (1 = attend);
// out [B, T, H·D] bf16, lse [B, H, T] f32. T ≤ 512, D % 8 == 0.
extern "C" int msa_packed_qkv_attention(const void* qkv, const void* mask, void* out, void* lse, int B, int T, int H,
                                        int D, float scale, void* stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  const Strides lin{3 * T * H * D, D, 3 * H * D}, lout{T * H * D, D, H * D};
  return attend(q, q + H * D, q + 2 * H * D, lin, mask, out, lout, lse, B, T, H, D, scale, stream);
}

// q, k, v, out [B, H, T, D] bf16 (contiguous), mask [B, T] f32 (1 = attend);
// lse [B, H, T] f32. T ≤ 512, D % 8 == 0.
extern "C" int msa_mha_attention(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
                                 int B, int T, int H, int D, float scale, void* stream) {
  const Strides st{H * T * D, T * D, D};
  return attend(q, k, v, st, mask, out, st, lse, B, T, H, D, scale, stream);
}
