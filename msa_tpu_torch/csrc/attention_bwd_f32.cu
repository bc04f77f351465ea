// attention_bwd in f32 (rows 3 and 4 on f32 operands), and in bf16 at head
// dims above 128: the flash-style attention backward from the forward's row
// logsumexp, as two D-tiled kernels on the CUDA cores. With L = lse, Δ =
// rowsum(dO∘O) and P = exp(S·scale + bias − L) recomputed per tile:
//   dV = Pᵀ·dO,   dS = P ∘ (dO·Vᵀ − Δ),   dQ = scale·dS·K,   dK = scale·dSᵀ·Q.
//
// Replaces msa_tpu/ops/pallas/attention.py:attention_bwd (:343-421) on f32
// operands (JAX's kernels take the operands' dtype): the dQ kernel
// (pallas_call at :370, body _bwd_dq_kernel :256-293) and the dK/dV kernel
// (pallas_call at :395, body _bwd_dkv_kernel :296-340). The encoders'
// training step in f32 (compute_dtype="float32", the parity mode's imported
// trunks fine-tuned) runs this backward after rows 5 and 6 in f32.
//
// Same rounding points as the TPU kernels and attention_bwd_plain: S and
// dO·Vᵀ accumulate in f32; s = S·scale + bias with −1e9 on masked keys (the
// product and the sum each rounded once); P = exp(s − L); dS = P·(dP − Δ);
// dS is rounded to k's dtype before dS·K, Pᵀ to dO's before Pᵀ·dO and dSᵀ to
// q's before dSᵀ·Q (the identity in f32: no rounding anywhere, exact FMA, no
// TF32); the f32 sums are multiplied by scale at the end (dQ, dK) and
// rounded once. Products of bf16 values are exact in f32, so at D > 128 the
// bf16 instances differ from the plain version only in summation order.
//
// Rows and keys past T are never written. A padded query row has q = dO = 0
// and L = Δ = 0, a padded key k = v = 0, so both add exact zeros, as in the
// TPU kernel. A row with no valid key has L ≈ −1e9 + log T_pad (the
// forward's), so its P is about 1/T_pad on every key, as in JAX.
//
// The design (row 1's f32 core, attention_fused.cu, with a D tile): one
// block per (64-row tile, DC-column tile of the output, head, batch row), 4
// warps of 16 owned rows; lane = 8·rg + kg holds owned rows 16w + rg + 4i (i
// < 4) × the step's columns kg + 8j (j < 8) of the 64 × 64 S and dP tiles
// (Sᵀ and dPᵀ in row 4) in registers, and the same rows × output columns
// 4kg + 32u (u < DC/32). Each operand read from shared memory (float4, rows
// of LD = DC + 4 floats: conflict-free) feeds 4 or 8 FMAs. The scores run
// over the full D, DC columns of each operand at a time; dS (and Pᵀ) goes
// through the warp's own rows of shared memory into the products of the
// block's column tile. At D ≤ DC (the encoders' D = 64) the owned tiles are
// loaded once. Copies are waited for before each step: simple first.
// - the dQ kernel (msa_attention_bwd_dq_f32): owned rows are queries;
//   steps of 64 keys; S = Q·Kᵀ, dP = dO·Vᵀ, then dQ += dS·K.
// - the dK/dV kernel (msa_attention_bwd_dkv_f32): owned rows are keys;
//   steps of 64 queries; Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, then dV += Pᵀ·dO and
//   dK += dSᵀ·Q.
//
// What bounds it on the card: per (row, head) 6·T²·D (dQ) and 8·T²·D
// (dK, dV) f32 operations. At the text training step's shape (B=8, T=512,
// H=12, D=64) 9.66 and 12.9 GFLOP, 0.144 and 0.192 ms at the CUDA cores' 67
// TFLOP/s, over ~50 MB (0.015 ms at 3.35 TB/s): bound by the FMA rate.
// Shared memory at DC = 64: 87 KB (dQ) and 104 KB (dK/dV) a block, so 2
// blocks share an SM.
//
// q, k, v, dq, dk and dv are addressed by one set of element strides
// (batch, head, time; D contiguous), dO by another, as in attention_bwd.cu:
// the packed projection [B, T, 3, H, D] with dO [B, T, H·D] and dqkv
// written in place, or [B, H, T, D] throughout.
#include "attention_mma.cuh"

namespace {

constexpr int SR = 64;         // owned rows a block
constexpr int SC = 64;         // rows of the other side a step
constexpr int STHREADS = 128;  // 4 warps of 16 owned rows
constexpr int SPL = SC + 8;    // row of sDS, sP: ≡ 8 (mod 32) words

template <int DC>
constexpr size_t dq_smem_bytes() {
  return ((size_t)4 * SR * (DC + 4) + (size_t)SR * SPL + 3 * 64) * sizeof(float);
}

template <int DC>
constexpr size_t dkv_smem_bytes() {
  return ((size_t)4 * SR * (DC + 4) + (size_t)2 * SR * SPL + 2 * 64) * sizeof(float);
}

// s[i][j] += Σ_d a(row i)[d]·b(row kg + 8j)[d] and t[i][j] likewise over the
// DC columns of a chunk: a and c are the thread's owned rows (+ 4i·LD), b and
// e the step's rows
template <int DC>
__device__ __forceinline__ void dots2(float (&s)[4][8], float (&t)[4][8], const float* a, const float* bt,
                                      const float* c, const float* et, int kg) {
  constexpr int LD = DC + 4;
#pragma unroll 2
  for (int d = 0; d < DC; d += 4) {
    float4 av[4], cv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a + 4 * i * LD + d);
      cv[i] = *reinterpret_cast<const float4*>(c + 4 * i * LD + d);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(bt + (kg + 8 * j) * LD + d);
      const float4 ev = *reinterpret_cast<const float4*>(et + (kg + 8 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][j] = fmaf(av[i].x, bv.x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv.y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv.z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv.w, s[i][j]);
        t[i][j] = fmaf(cv[i].x, ev.x, t[i][j]);
        t[i][j] = fmaf(cv[i].y, ev.y, t[i][j]);
        t[i][j] = fmaf(cv[i].z, ev.z, t[i][j]);
        t[i][j] = fmaf(cv[i].w, ev.w, t[i][j]);
      }
    }
  }
}

// acc[i][4u + e] += Σ_j w(row i)[j]·x[j][4kg + 32u + e] over the SC rows of
// a step: w the thread's rows of a [SR × SPL] tile (+ 4i·SPL), x an
// [SC × LD] tile at the block's column tile
template <int DC>
__device__ __forceinline__ void accumulate(float (&acc)[4][DC / 8], const float* w, const float* x, int kg) {
  constexpr int LD = DC + 4, NU = DC / 32;
#pragma unroll 2
  for (int j0 = 0; j0 < SC; j0 += 4) {
    float4 wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = *reinterpret_cast<const float4*>(w + 4 * i * SPL + j0);
#pragma unroll
    for (int jq = 0; jq < 4; ++jq) {
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const float4 xv = *reinterpret_cast<const float4*>(x + (j0 + jq) * LD + 4 * kg + 32 * u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jq == 0 ? wv[i].x : jq == 1 ? wv[i].y : jq == 2 ? wv[i].z : wv[i].w;
          acc[i][4 * u + 0] = fmaf(p, xv.x, acc[i][4 * u + 0]);
          acc[i][4 * u + 1] = fmaf(p, xv.y, acc[i][4 * u + 1]);
          acc[i][4 * u + 2] = fmaf(p, xv.z, acc[i][4 * u + 2]);
          acc[i][4 * u + 3] = fmaf(p, xv.w, acc[i][4 * u + 3]);
        }
      }
    }
  }
}

// acc·mul rounded once to E at the thread's rows t0 + 4i < T and columns
// c0 + 4kg + 32u < D of dst
template <typename E, int DC>
__device__ __forceinline__ void store_acc(const float (&acc)[4][DC / 8], float mul, E* __restrict__ dst, Strides st,
                                          int b, int h, int t0, int c0, int T, int D, int kg) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + 4 * i;
    if (t >= T) continue;
#pragma unroll
    for (int u = 0; u < DC / 32; ++u) {
      const int c = c0 + 4 * kg + 32 * u;
      if (c < D) {
        const float* a = acc[i] + 4 * u;
        store4<E>(dst + st.at(b, h, t) + c, __fmul_rn(a[0], mul), __fmul_rn(a[1], mul), __fmul_rn(a[2], mul),
                  __fmul_rn(a[3], mul));
      }
    }
  }
}

template <typename E, int DC>
__global__ void __launch_bounds__(STHREADS, 2)
simt_dq_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v, Strides sx,
               const E* __restrict__ dout, Strides so, const float* __restrict__ lse, const float* __restrict__ delta,
               const float* __restrict__ mask, E* __restrict__ dq, int H, int nct, int T, int D, float scale) {
  constexpr int LD = DC + 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [SR × LD] the owned queries
  float* sG = sQ + SR * LD;                        // dO of the owned queries
  float* sK = sG + SR * LD;                        // [SC × LD] the step's keys
  float* sV = sK + SC * LD;
  float* sDS = sV + SC * LD;  // [SR × SPL]
  float* sL = sDS + SR * SPL;
  float* sDl = sL + 64;
  float* sMask = sDl + 64;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, rg = lane >> 3, kg = lane & 7;
  const int q0 = blockIdx.x * SR, h = blockIdx.y / nct, c0 = (blockIdx.y % nct) * DC, b = blockIdx.z;
  const size_t row0 = ((size_t)b * H + h) * T;
  const int ndc = (D + DC - 1) / DC, r = warp * 16 + rg;  // the thread's owned row i is r + 4i
  float* sDSt = sDS + r * SPL;

  float acc[4][DC / 8] = {}, L[4], Dl[4];
  for (int kc = 0; kc < T; kc += SC) {
    float s[4][8] = {}, dp[4][8] = {};
    for (int dc = 0; dc < ndc; ++dc) {
      __syncthreads();  // every warp is done with the last step's tiles
      if (ndc > 1 || kc == 0) {
        load_rows_f32<E, SR, DC, STHREADS>(sQ, LD, q, sx, b, h, q0, T, dc * DC, D, tid);
        load_rows_f32<E, SR, DC, STHREADS>(sG, LD, dout, so, b, h, q0, T, dc * DC, D, tid);
      }
      load_rows_f32<E, SC, DC, STHREADS>(sK, LD, k, sx, b, h, kc, T, dc * DC, D, tid);
      load_rows_f32<E, SC, DC, STHREADS>(sV, LD, v, sx, b, h, kc, T, dc * DC, D, tid);
      if (dc == 0) load_vec_async<SC, STHREADS>(sMask, mask + (size_t)b * T, kc, T, tid);
      if (kc == 0 && dc == 0) {
        load_vec_async<SR, STHREADS>(sL, lse + row0, q0, T, tid);
        load_vec_async<SR, STHREADS>(sDl, delta + row0, q0, T, tid);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      dots2<DC>(s, dp, sQ + r * LD, sK, sG + r * LD, sV, kg);  // S = Q·Kᵀ, dP = dO·Vᵀ
    }
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        L[i] = sL[r + 4 * i];
        Dl[i] = sDl[r + 4 * i];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float bias = sMask[kg + 8 * j] > 0.f ? 0.f : MASK_BIAS;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(__fsub_rn(__fadd_rn(__fmul_rn(s[i][j], scale), bias), L[i]));
        sDSt[4 * i * SPL + kg + 8 * j] = round_to<E>(__fmul_rn(p, __fsub_rn(dp[i][j], Dl[i])));
      }
    }
    if (ndc > 1) {  // the keys' columns of the block's tile
      __syncthreads();
      load_rows_f32<E, SC, DC, STHREADS>(sK, LD, k, sx, b, h, kc, T, c0, D, tid);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    accumulate<DC>(acc, sDSt, sK, kg);  // dQ += dS·K
  }
  store_acc<E, DC>(acc, scale, dq, sx, b, h, q0 + r, c0, T, D, kg);
}

template <typename E, int DC>
__global__ void __launch_bounds__(STHREADS, 2)
simt_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v, Strides sx,
                const E* __restrict__ dout, Strides so, const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ mask, E* __restrict__ dk, E* __restrict__ dv, int H, int nct, int T, int D,
                float scale) {
  constexpr int LD = DC + 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // [SR × LD] the owned keys
  float* sV = sK + SR * LD;
  float* sQ = sV + SR * LD;  // [SC × LD] the step's queries
  float* sG = sQ + SC * LD;  // their dO
  float* sP = sG + SC * LD;  // [SR × SPL] Pᵀ
  float* sDS = sP + SR * SPL;  // dSᵀ
  float* sL = sDS + SR * SPL;
  float* sDl = sL + 64;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, rg = lane >> 3, kg = lane & 7;
  const int k0 = blockIdx.x * SR, h = blockIdx.y / nct, c0 = (blockIdx.y % nct) * DC, b = blockIdx.z;
  const size_t row0 = ((size_t)b * H + h) * T;
  const int ndc = (D + DC - 1) / DC, r = warp * 16 + rg;  // the thread's owned key i is k0 + r + 4i
  float* sPt = sP + r * SPL;
  float* sDSt = sDS + r * SPL;
  const float* mrow = mask + (size_t)b * T;
  float kb[4];  // the key bias of the owned keys (−1e9 past T)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + r + 4 * i;
    kb[i] = t < T && mrow[t] > 0.f ? 0.f : MASK_BIAS;
  }

  float acc_k[4][DC / 8] = {}, acc_v[4][DC / 8] = {};
  for (int qc = 0; qc < T; qc += SC) {
    float s[4][8] = {}, dp[4][8] = {};
    for (int dc = 0; dc < ndc; ++dc) {
      __syncthreads();  // every warp is done with the last step's tiles
      if (ndc > 1 || qc == 0) {
        load_rows_f32<E, SR, DC, STHREADS>(sK, LD, k, sx, b, h, k0, T, dc * DC, D, tid);
        load_rows_f32<E, SR, DC, STHREADS>(sV, LD, v, sx, b, h, k0, T, dc * DC, D, tid);
      }
      // query rows past T arrive as zeros with L = Δ = 0: exact zeros
      load_rows_f32<E, SC, DC, STHREADS>(sQ, LD, q, sx, b, h, qc, T, dc * DC, D, tid);
      load_rows_f32<E, SC, DC, STHREADS>(sG, LD, dout, so, b, h, qc, T, dc * DC, D, tid);
      if (dc == 0) {
        load_vec_async<SC, STHREADS>(sL, lse + row0, qc, T, tid);
        load_vec_async<SC, STHREADS>(sDl, delta + row0, qc, T, tid);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      dots2<DC>(s, dp, sK + r * LD, sQ, sV + r * LD, sG, kg);  // Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float Lj = sL[kg + 8 * j], Dj = sDl[kg + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(__fsub_rn(__fadd_rn(__fmul_rn(s[i][j], scale), kb[i]), Lj));
        sPt[4 * i * SPL + kg + 8 * j] = round_to<E>(p);
        sDSt[4 * i * SPL + kg + 8 * j] = round_to<E>(__fmul_rn(p, __fsub_rn(dp[i][j], Dj)));
      }
    }
    if (ndc > 1) {  // the queries' columns of the block's tile
      __syncthreads();
      load_rows_f32<E, SC, DC, STHREADS>(sQ, LD, q, sx, b, h, qc, T, c0, D, tid);
      load_rows_f32<E, SC, DC, STHREADS>(sG, LD, dout, so, b, h, qc, T, c0, D, tid);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    accumulate<DC>(acc_v, sPt, sG, kg);   // dV += Pᵀ·dO
    accumulate<DC>(acc_k, sDSt, sQ, kg);  // dK += dSᵀ·Q
  }
  store_acc<E, DC>(acc_k, scale, dk, sx, b, h, k0 + r, c0, T, D, kg);
  store_acc<E, DC>(acc_v, 1.f, dv, sx, b, h, k0 + r, c0, T, D, kg);
}

struct SimtArgs {
  const void *q, *k, *v, *dout;
  Strides sx, so;
  const float *lse, *delta, *mask;
  void *dq, *dk, *dv;
  int B, T, H, D;
  float scale;
  cudaStream_t stream;
};

template <typename E, int DC>
cudaError_t launch_simt(const SimtArgs& a) {
  const int nct = (a.D + DC - 1) / DC;
  const dim3 grid((a.T + SR - 1) / SR, a.H * nct, a.B);
  auto q = static_cast<const E*>(a.q);
  auto k = static_cast<const E*>(a.k);
  auto v = static_cast<const E*>(a.v);
  auto g = static_cast<const E*>(a.dout);
  if (a.dq != nullptr) {
    constexpr size_t smem = dq_smem_bytes<DC>();
    cudaError_t e = cudaFuncSetAttribute(simt_dq_kernel<E, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    simt_dq_kernel<E, DC><<<grid, STHREADS, smem, a.stream>>>(q, k, v, a.sx, g, a.so, a.lse, a.delta, a.mask,
                                                             static_cast<E*>(a.dq), a.H, nct, a.T, a.D, a.scale);
  } else {
    constexpr size_t smem = dkv_smem_bytes<DC>();
    cudaError_t e = cudaFuncSetAttribute(simt_dkv_kernel<E, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    simt_dkv_kernel<E, DC><<<grid, STHREADS, smem, a.stream>>>(q, k, v, a.sx, g, a.so, a.lse, a.delta, a.mask,
                                                              static_cast<E*>(a.dk), static_cast<E*>(a.dv), a.H, nct,
                                                              a.T, a.D, a.scale);
  }
  return cudaGetLastError();
}

}  // namespace

int attend_bwd_simt(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                    const void* delta, const void* mask, void* dq, void* dk, void* dv, int B, int T, int H, int D,
                    int sx_b, int sx_h, int sx_t, int so_b, int so_h, int so_t, float scale, int is_bf16,
                    void* stream) {
  if (T < 1 || D < 8 || D % 8 || H * ((D + 31) / 32) > 65535 || (dq == nullptr) == (dk == nullptr || dv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const SimtArgs a{q,
                   k,
                   v,
                   dout,
                   Strides{sx_b, sx_h, sx_t},
                   Strides{so_b, so_h, so_t},
                   static_cast<const float*>(lse),
                   static_cast<const float*>(delta),
                   static_cast<const float*>(mask),
                   dq,
                   dk,
                   dv,
                   B,
                   T,
                   H,
                   D,
                   scale,
                   static_cast<cudaStream_t>(stream)};
  // the column tile (and the D step of the scores): 32 at D ≤ 32, else 64
  cudaError_t e;
  if (is_bf16)
    e = D <= 32 ? launch_simt<bf16, 32>(a) : launch_simt<bf16, 64>(a);
  else
    e = D <= 32 ? launch_simt<float, 32>(a) : launch_simt<float, 64>(a);
  return static_cast<int>(e);
}

// q, k, v, dq: f32 with element strides (sx_b, sx_h, sx_t), D contiguous;
// dout: f32 with strides (so_b, so_h, so_t); lse, delta [B, H, T] f32; mask
// [B, T] f32. Every row 16-byte aligned. Any T ≥ 1; D % 8 == 0, any D.
extern "C" int msa_attention_bwd_dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                        const void* delta, const void* mask, void* dq, int B, int T, int H, int D,
                                        int sx_b, int sx_h, int sx_t, int so_b, int so_h, int so_t, float scale,
                                        void* stream) {
  return attend_bwd_simt(q, k, v, dout, lse, delta, mask, dq, nullptr, nullptr, B, T, H, D, sx_b, sx_h, sx_t, so_b,
                         so_h, so_t, scale, 0, stream);
}

// as msa_attention_bwd_dq_f32; dk and dv take the strides of q, k and v
extern "C" int msa_attention_bwd_dkv_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                         const void* delta, const void* mask, void* dk, void* dv, int B, int T, int H,
                                         int D, int sx_b, int sx_h, int sx_t, int so_b, int so_h, int so_t,
                                         float scale, void* stream) {
  return attend_bwd_simt(q, k, v, dout, lse, delta, mask, nullptr, dk, dv, B, T, H, D, sx_b, sx_h, sx_t, so_b, so_h,
                         so_t, scale, 0, stream);
}
