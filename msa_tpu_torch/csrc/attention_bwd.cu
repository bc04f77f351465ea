// attention_bwd for Hopper: the flash-style attention backward from the
// forward's row logsumexp, as two kernels. With L = lse, Δ = rowsum(dO∘O)
// and P = exp(S·scale + bias − L) recomputed per tile (never stored):
//   dV = Pᵀ·dO,   dS = P ∘ (dO·Vᵀ − Δ),   dQ = scale·dS·K,   dK = scale·dSᵀ·Q.
//
// Replaces msa_tpu/ops/pallas/attention.py:attention_bwd (:343-421): the dQ
// kernel (pallas_call at :370, body _bwd_dq_kernel :256-293) and the dK/dV
// kernel (pallas_call at :395, body _bwd_dkv_kernel :296-340). JAX's
// packed_qkv_attention, attention_with_vjp and so every training step of
// its encoders (attention_impl="pallas", no dropout) run this backward
// after rows 2, 5 or 6.
//
// The TPU kernels carry f32 accumulators in scratch across a sequential
// grid axis. Here the split is the same and each output tile is owned by
// one block, so no sum crosses blocks (no atomics; deterministic):
// - msa_attention_bwd_dq: one block per (64-query tile, head, batch row),
//   looping over 64-key steps; dQ accumulates in registers.
// - msa_attention_bwd_dkv: one block per (64-key tile, head, batch row),
//   looping over query chunks; dK and dV accumulate in registers.
// 4 warps, each owning 16 rows of the block's tile.
//
// Same rounding points as the TPU kernels: S and dO·Vᵀ in f32 from bf16
// operands; s = S·scale + bias with −1e9 on masked keys (each product and
// sum rounded once, no fused multiply-add, as the plain version computes
// it); P = exp(s − L) in f32; dS = P·(dP − Δ) in f32; dS is rounded to bf16
// before the dS·K product, Pᵀ before Pᵀ·dO and dSᵀ before dSᵀ·Q; the f32
// sums are multiplied by scale at the end (dQ, dK) and rounded once.
//
// Rows and keys past T are never written. In the TPU kernel a padded query
// row has q = dO = 0 and L = Δ = 0, and a padded key has k = v = 0, so both
// add exact zeros: the dQ kernel leaves them out, the dK/dV kernel reads
// them as those zeros. A row with no valid key has L ≈ −1e9 + log T_pad
// (the forward's), so its P is about 1 on every key, as in JAX.
//
// q, k, v, dq, dk and dv are addressed by one set of element strides
// (batch, head, time; D contiguous), dO by another: the same kernels read
// the packed projection [B, T, 3, H, D] with dO [B, T, H·D] and write dqkv
// in that layout, or take [B, H, T, D] throughout. lse and Δ are
// [B, H, T] f32, the key mask [B, T] f32 (1 = attend). D is any multiple of
// 8 up to 128, zero-padded to DP (32, 64 or 128) in shared memory; above
// 128 (any D) the entries run the tensor-core pair of
// attention_bwd_wide.cu, which rounds at the same points.
//
// What bounds it on the card: per (row, head) the dQ kernel does 6·T²·D
// operations (S, dO·Vᵀ, dS·K) and the dK/dV kernel 8·T²·D (Sᵀ, Pᵀ·dO,
// V·dOᵀ, dSᵀ·Q), on 4·T·D·2 bytes in and T·D·2 (dQ) or 2·T·D·2 (dK, dV)
// out. At the text training shape (B=8, T=512, H=12, D=64) that is 9.7 and
// 12.9 GFLOP (9.8 and 13.0 µs at 989 TFLOP/s) over ~25 MB (7.5 µs at
// 3.35 TB/s): bound by operations.
//
// Both kernels run on the register-resident primitives of the forward
// (attention_mma.cuh). The dQ kernel: each warp loads its 16 queries of Q
// and dO once as mma.sync A fragments (load_q_frags); per step it forms
// S = Q·Kᵀ and dP = dO·Vᵀ as accumulators with tile_dots, takes P and dS
// in registers (the key bias per column, L and Δ per lane row), packs
// bf16(dS) straight into A fragments (p_frags) and accumulates
// dQ += dS·K with tile_pv, K's tile as its ldmatrix.trans B operand (K is
// [keys × D], as V is for P·V). K, V and the key mask come through a
// two-stage cp.async ring of 64 keys (step i+1's copy flies while step i's
// products run); at DP = 128 a ring stage is taken in two 32-key halves,
// since Q's and dO's fragments (2 × 32 registers), dQ's accumulator (64)
// and two 16 × 64 accumulator tiles (2 × 32) would pass 255 registers.
// dQ·scale leaves by 16-byte stores staged through the warp's own rows of
// the Q tile. 55 KB of shared memory and 132 registers a thread at
// DP = 64: 3 blocks share an SM.
// The dK/dV kernel: each warp loads its 16 keys of K and V once
// as mma.sync A fragments; per query chunk of 32 rows it forms Sᵀ = K·Qᵀ
// and dPᵀ = V·dOᵀ as accumulators with tile_dots, takes P and dS in
// registers (the key bias is per lane row, L and Δ per column), packs
// bf16(Pᵀ) and bf16(dSᵀ) straight into A fragments (p_frags) and
// accumulates dV += Pᵀ·dO and dK += dSᵀ·Q with tile_pv, dO and Q as its
// ldmatrix.trans B operand. Q, dO, L and Δ come through a two-stage
// cp.async ring (chunk c+1's copy flies while chunk c computes); dK·scale
// and dV leave by 16-byte stores staged through the warp's own rows of sK
// and sV. 37 KB of shared memory and 168 registers a thread at DP = 64:
// 3 blocks share an SM.
#include "attention_mma.cuh"

namespace {

constexpr int BTHREADS = 128;  // 4 warps, 16 owned rows each

// row 3's tiles: the block's 64 queries, and ring stages of 64 keys
constexpr int QB = 64;
constexpr int KS = 64;

template <int DP>
constexpr size_t dq_smem_bytes() {
  return (size_t)(2 * QB + 4 * KS) * (DP + 8) * sizeof(bf16)  // sQ, sG; sK, sV of two stages
         + (size_t)2 * KS * sizeof(float);                     // the key mask of two stages
}

template <int DP>
__global__ void __launch_bounds__(BTHREADS)
bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v, Strides sx,
              const bf16* __restrict__ dout, Strides so, const float* __restrict__ lse,
              const float* __restrict__ delta, const float* __restrict__ mask, bf16* __restrict__ dq, int T, int H,
              int D, float scale) {
  constexpr int LD = DP + 8;
  constexpr int NK = DP == 128 ? 32 : 64;  // keys a product step takes (see the note above)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sG = sQ + QB * LD;                                 // dO
  bf16* sK = sG + QB * LD;                                 // [2][KS × LD]
  bf16* sV = sK + 2 * KS * LD;                             // [2][KS × LD]
  float* sM = reinterpret_cast<float*>(sV + 2 * KS * LD);  // the key mask, [2][KS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * QB, h = blockIdx.y, b = blockIdx.z;
  const size_t row0 = ((size_t)b * H + h) * T;
  const float* mrow = mask + (size_t)b * T;
  const int nk = (T + KS - 1) / KS;

  // step c's K, V and key mask: keys past T arrive as zeros under the −1e9
  // bias, so they add exact zeros (dS·K with K = 0)
  auto issue = [&](int c) {
    const int st = c & 1, t0 = c * KS;
    load_tile_async<KS, DP, BTHREADS>(sK + st * KS * LD, k, sx, b, h, t0, T, D, tid);
    load_tile_async<KS, DP, BTHREADS>(sV + st * KS * LD, v, sx, b, h, t0, T, D, tid);
    load_vec_async<KS, BTHREADS>(sM + st * KS, mrow, t0, T, tid);
    cp_async_commit();
  };
  // → the stage of step c, landed for every thread, with c + 1's in flight
  auto arrive = [&](int c) {
    __syncthreads();  // every warp is done with the stage that c + 1 refills
    if (c + 1 < nk) {
      issue(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    return c & 1;
  };

  load_tile_async<QB, DP, BTHREADS>(sQ, q, sx, b, h, q0, T, D, tid);
  load_tile_async<QB, DP, BTHREADS>(sG, dout, so, b, h, q0, T, D, tid);
  issue(0);  // Q and dO land with the first step

  // L and Δ of the lane's rows g and g + 8; rows past T have q = dO = 0
  // and L = Δ = 0, so their dS is 0, and they are not written
  const int r = q0 + warp * 16 + (lane >> 2);
  const float L[2] = {r < T ? lse[row0 + r] : 0.f, r + 8 < T ? lse[row0 + r + 8] : 0.f};
  const float Dl[2] = {r < T ? delta[row0 + r] : 0.f, r + 8 < T ? delta[row0 + r + 8] : 0.f};

  uint32_t qf[DP / 16][4], gf[DP / 16][4];
  float acc[DP / 8][4] = {};
  for (int c = 0; c < nk; ++c) {
    const int st = arrive(c);
    if (c == 0) {
      load_q_frags<DP>(qf, sQ + warp * 16 * LD, lane);
      load_q_frags<DP>(gf, sG + warp * 16 * LD, lane);
    }
#pragma unroll
    for (int j = 0; j < KS / NK; ++j) {
      const bf16* sKj = sK + (st * KS + j * NK) * LD;
      // s = S·scale + bias (each rounded once), P = exp(s − L),
      // dS = P·(dP − Δ), dP = dO·Vᵀ: all in f32
      float s[NK / 8][4], dp[NK / 8][4];
      tile_dots<NK, DP>(s, qf, sKj, lane);
      score_epilogue<NK>(s, sM + st * KS + j * NK, scale, lane);
      tile_dots<NK, DP>(dp, gf, sV + (st * KS + j * NK) * LD, lane);
#pragma unroll
      for (int n = 0; n < NK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = __fmul_rn(expf(__fsub_rn(s[n][e], L[e >> 1])), __fsub_rn(dp[n][e], Dl[e >> 1]));
      }
      uint32_t pf[NK / 16][4];
      p_frags<NK>(pf, s);
      tile_pv<NK, DP, LD>(acc, pf, sKj, lane);  // dQ += bf16(dS)·K
    }
  }

  // dQ·scale, rounded once, staged through the warp's own rows of sQ (its
  // fragments are in registers)
  write_rows<DP>(acc, scale, sQ + warp * 16 * LD, dq, sx, b, h, q0 + warp * 16, T, D, lane);
}

// row 4's tiles: the block's 64 keys, and query chunks of QC rows. QC = 32
// keeps bwd_dkv_kernel<64> at 168 registers (3 blocks an SM) where 64 took
// 242 (2 blocks) and ran 10–40% slower on the training shapes (PERF.md)
constexpr int KB = 64;
constexpr int QC = 32;

template <int DP>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(2 * KB + 4 * QC) * (DP + 8) * sizeof(bf16)  // sK, sV; sQ, sG of two stages
         + (size_t)4 * QC * sizeof(float);                     // L, Δ of two stages
}

template <int DP>
__global__ void __launch_bounds__(BTHREADS)
bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v, Strides sx,
               const bf16* __restrict__ dout, Strides so, const float* __restrict__ lse,
               const float* __restrict__ delta, const float* __restrict__ mask, bf16* __restrict__ dk,
               bf16* __restrict__ dv, int T, int H, int D, float scale) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + KB * LD;
  bf16* sQ = sV + KB * LD;                                 // [2][QC × LD]
  bf16* sG = sQ + 2 * QC * LD;                             // dO, [2][QC × LD]
  float* sL = reinterpret_cast<float*>(sG + 2 * QC * LD);  // [2][QC]
  float* sD = sL + 2 * QC;                                 // Δ, [2][QC]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * KB, h = blockIdx.y, b = blockIdx.z;
  const size_t row0 = ((size_t)b * H + h) * T;
  const int nc = (T + QC - 1) / QC;

  // chunk c's Q, dO, L and Δ; rows past T arrive as zeros, so they add
  // exact zeros (P = exp(bias − 0) on q = 0, dO = 0; a stale L could overflow)
  auto issue = [&](int c) {
    const int st = c & 1, t0 = c * QC;
    load_tile_async<QC, DP, BTHREADS, false>(sQ + st * QC * LD, q, sx, b, h, t0, T, D, tid);
    load_tile_async<QC, DP, BTHREADS, false>(sG + st * QC * LD, dout, so, b, h, t0, T, D, tid);
    load_vec_async<QC, BTHREADS>(sL + st * QC, lse + row0, t0, T, tid);
    load_vec_async<QC, BTHREADS>(sD + st * QC, delta + row0, t0, T, tid);
    cp_async_commit();
  };
  // → the stage of chunk c, landed for every thread, with c + 1's in flight
  auto arrive = [&](int c) {
    __syncthreads();  // every warp is done with the stage that c + 1 refills
    if (c + 1 < nc) {
      issue(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    return c & 1;
  };

  load_tile_async<KB, DP, BTHREADS, false>(sK, k, sx, b, h, k0, T, D, tid);
  load_tile_async<KB, DP, BTHREADS, false>(sV, v, sx, b, h, k0, T, D, tid);
  issue(0);  // K and V land with the first chunk

  // the key bias of the lane's rows g and g + 8 (keys past T: −1e9)
  const int kr = k0 + warp * 16 + (lane >> 2), c2 = (lane & 3) << 1;
  const float* mrow = mask + (size_t)b * T;
  const float kb[2] = {kr < T && mrow[kr] > 0.f ? 0.f : MASK_BIAS, kr + 8 < T && mrow[kr + 8] > 0.f ? 0.f : MASK_BIAS};

  uint32_t kf[DP / 16][4], vf[DP / 16][4];
  float acc_k[DP / 8][4] = {}, acc_v[DP / 8][4] = {};
  for (int c = 0; c < nc; ++c) {
    const int st = arrive(c);
    if (c == 0) {
      load_q_frags<DP>(kf, sK + warp * 16 * LD, lane);
      load_q_frags<DP>(vf, sV + warp * 16 * LD, lane);
    }
    const bf16* sQc = sQ + st * QC * LD;
    const bf16* sGc = sG + st * QC * LD;
    const float* sLc = sL + st * QC;
    const float* sDc = sD + st * QC;

    // Pᵀ = exp(Sᵀ·scale + bias − L): rows are the warp's keys, columns the chunk's queries
    float p[QC / 8][4];
    tile_dots<QC, DP>(p, kf, sQc, lane);
#pragma unroll
    for (int n = 0; n < QC / 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(sLc + n * 8 + c2);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[n][e] = expf(__fsub_rn(__fadd_rn(__fmul_rn(p[n][e], scale), kb[e >> 1]), e & 1 ? l2.y : l2.x));
    }
    uint32_t pf[QC / 16][4];
    p_frags<QC>(pf, p);
    tile_pv<QC, DP, LD>(acc_v, pf, sGc, lane);  // dV += bf16(Pᵀ)·dO

    // dSᵀ = Pᵀ ∘ (dPᵀ − Δ), dPᵀ = V·dOᵀ
    float ds[QC / 8][4];
    tile_dots<QC, DP>(ds, vf, sGc, lane);
#pragma unroll
    for (int n = 0; n < QC / 8; ++n) {
      const float2 d2 = *reinterpret_cast<const float2*>(sDc + n * 8 + c2);
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[n][e] = __fmul_rn(p[n][e], __fsub_rn(ds[n][e], e & 1 ? d2.y : d2.x));
    }
    p_frags<QC>(pf, ds);
    tile_pv<QC, DP, LD>(acc_k, pf, sQc, lane);  // dK += bf16(dSᵀ)·Q
  }

  // dK·scale and dV, each rounded once, staged through the warp's own rows
  // of sK and sV (their fragments are in registers)
  write_rows<DP>(acc_k, scale, sK + warp * 16 * LD, dk, sx, b, h, k0 + warp * 16, T, D, lane);
  write_rows<DP>(acc_v, 1.f, sV + warp * 16 * LD, dv, sx, b, h, k0 + warp * 16, T, D, lane);
}

struct BwdArgs {
  const bf16 *q, *k, *v, *dout;
  Strides sx, so;
  const float *lse, *delta, *mask;
  bf16 *dq, *dk, *dv;
  int B, T, H, D;
  float scale;
  cudaStream_t stream;
};

template <int DP>
cudaError_t launch_dq(const BwdArgs& a) {
  constexpr size_t smem = dq_smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(bwd_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  bwd_dq_kernel<DP><<<dim3((a.T + QB - 1) / QB, a.H, a.B), BTHREADS, smem, a.stream>>>(
      a.q, a.k, a.v, a.sx, a.dout, a.so, a.lse, a.delta, a.mask, a.dq, a.T, a.H, a.D, a.scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const BwdArgs& a) {
  constexpr size_t smem = dkv_smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(bwd_dkv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  bwd_dkv_kernel<DP><<<dim3((a.T + KB - 1) / KB, a.H, a.B), BTHREADS, smem, a.stream>>>(
      a.q, a.k, a.v, a.sx, a.dout, a.so, a.lse, a.delta, a.mask, a.dk, a.dv, a.T, a.H, a.D, a.scale);
  return cudaGetLastError();
}

BwdArgs bwd_args(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
                 const void* mask, void* dq, void* dk, void* dv, int B, int T, int H, int D, int sx_b, int sx_h,
                 int sx_t, int so_b, int so_h, int so_t, float scale, void* stream) {
  return BwdArgs{static_cast<const bf16*>(q),     static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v),     static_cast<const bf16*>(dout),
                 Strides{sx_b, sx_h, sx_t},       Strides{so_b, so_h, so_t},
                 static_cast<const float*>(lse),  static_cast<const float*>(delta),
                 static_cast<const float*>(mask), static_cast<bf16*>(dq),
                 static_cast<bf16*>(dk),          static_cast<bf16*>(dv),
                 B,                               T,
                 H,                               D,
                 scale,                           static_cast<cudaStream_t>(stream)};
}

bool bad_shape(int T, int D) { return T < 1 || D % 8 || D < 8; }

}  // namespace

// q, k, v, dq: bf16 with element strides (sx_b, sx_h, sx_t), D contiguous;
// dout: bf16 with strides (so_b, so_h, so_t); lse, delta [B, H, T] f32;
// mask [B, T] f32. Every row 16-byte aligned. Any T ≥ 1; D % 8 == 0
// (above 128 the tensor-core pair of attention_bwd_wide.cu).
extern "C" int msa_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                    const void* delta, const void* mask, void* dq, int B, int T, int H, int D,
                                    int sx_b, int sx_h, int sx_t, int so_b, int so_h, int so_t, float scale,
                                    void* stream) {
  if (bad_shape(T, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (D > 128)
    return attend_bwd_wide(q, k, v, dout, lse, delta, mask, dq, nullptr, nullptr, B, T, H, D, sx_b, sx_h, sx_t, so_b,
                           so_h, so_t, scale, stream);
  const BwdArgs a = bwd_args(q, k, v, dout, lse, delta, mask, dq, nullptr, nullptr, B, T, H, D, sx_b, sx_h, sx_t,
                             so_b, so_h, so_t, scale, stream);
  const cudaError_t e = D <= 32 ? launch_dq<32>(a) : D <= 64 ? launch_dq<64>(a) : launch_dq<128>(a);
  return static_cast<int>(e);
}

// as msa_attention_bwd_dq; dk and dv take the strides of q, k and v
extern "C" int msa_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                     const void* delta, const void* mask, void* dk, void* dv, int B, int T, int H,
                                     int D, int sx_b, int sx_h, int sx_t, int so_b, int so_h, int so_t, float scale,
                                     void* stream) {
  if (bad_shape(T, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (D > 128)
    return attend_bwd_wide(q, k, v, dout, lse, delta, mask, nullptr, dk, dv, B, T, H, D, sx_b, sx_h, sx_t, so_b, so_h,
                           so_t, scale, stream);
  const BwdArgs a = bwd_args(q, k, v, dout, lse, delta, mask, nullptr, dk, dv, B, T, H, D, sx_b, sx_h, sx_t, so_b,
                             so_h, so_t, scale, stream);
  const cudaError_t e = D <= 32 ? launch_dkv<32>(a) : D <= 64 ? launch_dkv<64>(a) : launch_dkv<128>(a);
  return static_cast<int>(e);
}
