// attention_bwd in f32 (rows 3 and 4 on f32 operands): the flash-style
// attention backward from the forward's row logsumexp on the CUDA cores.
// (bf16 above head dim 128 runs the tensor-core pair of
// attention_bwd_wide.cu.) With L = lse, Δ = rowsum(dO∘O) and P =
// exp(S·scale + bias − L) recomputed per tile:
//   dV = Pᵀ·dO,   dS = P ∘ (dO·Vᵀ − Δ),   dQ = scale·dS·K,   dK = scale·dSᵀ·Q.
//
// Replaces msa_tpu/ops/pallas/attention.py:attention_bwd (:343-421) on f32
// operands (JAX's kernels take the operands' dtype): the dQ kernel
// (pallas_call at :370, body _bwd_dq_kernel :256-293) and the dK/dV kernel
// (pallas_call at :395, body _bwd_dkv_kernel :296-340). The encoders'
// training step in f32 (compute_dtype="float32", the parity mode's imported
// trunks fine-tuned) runs this backward after rows 5 and 6 in f32.
//
// The training path's backward is ONE pass at every D, dq, dk and dv in
// one launch (msa_attention_bwd_onepass_f32, dispatched by D):
// - D ≤ 64 (every served f32 shape: D = 64, and 24 or 25 padded to 32):
//   onepass_f32_kernel, 32 columns at D ≤ 32, else 64;
// - D > 64 (D % 8 == 0, any D): wide_onepass_f32_kernel, 128 columns and
//   64 keys a block at D ≤ 128, 256 columns and 32 keys above.
// The D-tiled pair (simt_dq_kernel, simt_dkv_kernel) stays behind the
// direct entries msa_attention_bwd_dq_f32 and msa_attention_bwd_dkv_f32
// only: no wrapper path launches it.
//
// Same rounding points in both as the TPU kernels and attention_bwd_plain:
// S and dO·Vᵀ accumulate in f32; s = S·scale + bias with −1e9 on masked
// keys (the product and the sum each rounded once); P = exp(s − L); dS =
// P·(dP − Δ); the roundings of dS, Pᵀ and dSᵀ to the operands' dtype before
// the products are the identity in f32 (no rounding anywhere, exact FMA, no
// TF32); the f32 sums are multiplied by scale at the end (dQ, dK).
//
// Rows and keys past T are never written. A padded query row has q = dO = 0
// and L = Δ = 0, a padded key k = v = 0, so both add exact zeros, as in the
// TPU kernel. A row with no valid key has L ≈ −1e9 + log T_pad (the
// forward's), so its P is about 1/T_pad on every key, as in JAX.
//
// The pair's register tiles (row 1's f32 core, attention_fused.cu): 4
// warps of 16 owned rows; lane = 8·rg + kg holds owned rows 16w + rg + 4i
// (i < 4) × the step's columns kg + 8j (j < 8) of the 64-wide S and dP
// tiles in registers, and the same rows × output columns 4kg + 32u (u <
// DC/32). Each operand read from shared memory (float4, rows of LD = DC +
// 4 floats: conflict-free) feeds 4 or 8 FMAs; dS (and Pᵀ) goes through
// the warp's own rows of shared memory into the products over the step.
//
// The one pass (D ≤ 64): a block owns BK = 64·KH keys of one (batch row,
// head) (KH = 1 or 2: 4 or 8 warps, 128·KH threads) and walks the query
// steps of 64 of its split of the query loop; per step it forms Sᵀ = K·Qᵀ
// and dPᵀ = V·dOᵀ ONCE, then Pᵀ and dSᵀ, then dV += Pᵀ·dO and dK += dSᵀ·Q
// in registers and this key tile's share of the step's dQ = dS·K. 10·T²·D
// operations a (row, head), where the pair takes 14 (it forms S and dP in
// both kernels).
// - Two warp groups: group 0 forms Sᵀ, Pᵀ and dV, group 1 dPᵀ, dSᵀ (from
//   group 0's Pᵀ in shared memory) and dK; a thread holds 8 keys × 8
//   queries of its tile and the same 8 keys × 8 columns of its dV or dK,
//   so each operand it reads feeds 8 FMAs. Every thread then takes RPT
//   query rows × 4 columns of the [64 × D] dQ share, over the BK keys in
//   order.
// - dQ is summed in key-tile order, never by float atomics: the share of
//   key tile kt goes into dq itself (kt = 0 stores it, the others read,
//   add and store; the last also multiplies by scale), a warp at a time,
//   once the (b, h, query step)'s ticket counts every warp of the key tiles
//   before it; the warp then adds one to it (the last warp sets 0: zero at
//   rest). No block-wide barrier waits on it. A query split's dK/dV are
//   summed the same way, in split order, under a per-(b, h, key tile)
//   ticket. Blocks take their work in the order of an atomic counter, key
//   tile fastest, so a block only ever waits on a block that started
//   before it: no deadlock whatever the scheduler does. Two calls are
//   bit-equal.
// - The tile size BK and the query split come from the wrapper's planner
//   (ops/kernels/attention_bwd_plan.py), which fills the 132 SMs (one block
//   an SM) in close to whole waves at the served shapes; the entry refuses
//   a plan it cannot take (cudaErrorInvalidValue).
// - The step's Q, dO, L and Δ come by cp.async into a ring of two stages:
//   the next step's tiles are in flight while this step's FMAs run.
//   Shared memory at DC = 64, KH = 2: 209 KB (K, V, the ring, Pᵀ and dSᵀ),
//   so one block of 8 warps an SM; 254 registers a thread, no spill.
// - What the design runs on the card found (PERF.md §6): the products
//   run at about half the CUDA cores' peak, as the pair's do. Without the
//   dQ sums' loads, stores and tickets the kernel read 8% faster, without
//   the dQ product 29%; 8-key rows (a third fewer operand loads than the
//   pair's 4 × 8 tiles) gained 2%, 16 warps at 128 registers lost 11%, and
//   named-barrier hand-offs between the two groups 1%.
//
// The pair (any D): one block per (64-row tile, DC-column tile of the
// output, head, batch row); the scores run over the full D, DC columns of
// each operand at a time, and the products of the block's column tile
// follow. Copies are waited for before each step. At D ≤ DC the owned
// tiles are loaded once.
// - the dQ kernel (msa_attention_bwd_dq_f32): owned rows are queries;
//   steps of 64 keys; S = Q·Kᵀ, dP = dO·Vᵀ, then dQ += dS·K.
// - the dK/dV kernel (msa_attention_bwd_dkv_f32): owned rows are keys;
//   steps of 64 queries; Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, then dV += Pᵀ·dO and
//   dK += dSᵀ·Q.
//
// What bounds it on the card: the FMA rate. At the text training step's
// shape (B=8, T=512, H=12, D=64) the function needs 10·B·H·T²·D = 16.1
// GFLOP, 0.240 ms at the CUDA cores' 67 TFLOP/s, over ~50 MB (0.015 ms at
// 3.35 TB/s). The pair does 6·T²·D (dQ) and 8·T²·D (dK, dV) operations a
// (row, head): 9.66 and 12.9 GFLOP there; shared memory at DC = 64: 87 KB
// (dQ) and 104 KB (dK/dV) a block, so 2 blocks share an SM.
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

// acc·mul at the thread's rows t0 + 4i < T and columns
// c0 + 4kg + 32u < D of dst
template <int DC>
__device__ __forceinline__ void store_acc(const float (&acc)[4][DC / 8], float mul, float* __restrict__ dst, Strides st,
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
        *reinterpret_cast<float4*>(dst + st.at(b, h, t) + c) =
            make_float4(__fmul_rn(a[0], mul), __fmul_rn(a[1], mul), __fmul_rn(a[2], mul), __fmul_rn(a[3], mul));
      }
    }
  }
}

template <int DC>
__global__ void __launch_bounds__(STHREADS, 2)
simt_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, Strides sx,
               const float* __restrict__ dout, Strides so, const float* __restrict__ lse, const float* __restrict__ delta,
               const float* __restrict__ mask, float* __restrict__ dq, int H, int nct, int T, int D, float scale) {
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
        load_rows_f32<SR, DC, STHREADS>(sQ, LD, q, sx, b, h, q0, T, dc * DC, D, tid);
        load_rows_f32<SR, DC, STHREADS>(sG, LD, dout, so, b, h, q0, T, dc * DC, D, tid);
      }
      load_rows_f32<SC, DC, STHREADS>(sK, LD, k, sx, b, h, kc, T, dc * DC, D, tid);
      load_rows_f32<SC, DC, STHREADS>(sV, LD, v, sx, b, h, kc, T, dc * DC, D, tid);
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
        sDSt[4 * i * SPL + kg + 8 * j] = __fmul_rn(p, __fsub_rn(dp[i][j], Dl[i]));
      }
    }
    if (ndc > 1) {  // the keys' columns of the block's tile
      __syncthreads();
      load_rows_f32<SC, DC, STHREADS>(sK, LD, k, sx, b, h, kc, T, c0, D, tid);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    accumulate<DC>(acc, sDSt, sK, kg);  // dQ += dS·K
  }
  store_acc<DC>(acc, scale, dq, sx, b, h, q0 + r, c0, T, D, kg);
}

template <int DC>
__global__ void __launch_bounds__(STHREADS, 2)
simt_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, Strides sx,
                const float* __restrict__ dout, Strides so, const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ mask, float* __restrict__ dk, float* __restrict__ dv, int H, int nct, int T, int D,
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
        load_rows_f32<SR, DC, STHREADS>(sK, LD, k, sx, b, h, k0, T, dc * DC, D, tid);
        load_rows_f32<SR, DC, STHREADS>(sV, LD, v, sx, b, h, k0, T, dc * DC, D, tid);
      }
      // query rows past T arrive as zeros with L = Δ = 0: exact zeros
      load_rows_f32<SC, DC, STHREADS>(sQ, LD, q, sx, b, h, qc, T, dc * DC, D, tid);
      load_rows_f32<SC, DC, STHREADS>(sG, LD, dout, so, b, h, qc, T, dc * DC, D, tid);
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
        sPt[4 * i * SPL + kg + 8 * j] = p;
        sDSt[4 * i * SPL + kg + 8 * j] = __fmul_rn(p, __fsub_rn(dp[i][j], Dj));
      }
    }
    if (ndc > 1) {  // the queries' columns of the block's tile
      __syncthreads();
      load_rows_f32<SC, DC, STHREADS>(sQ, LD, q, sx, b, h, qc, T, c0, D, tid);
      load_rows_f32<SC, DC, STHREADS>(sG, LD, dout, so, b, h, qc, T, c0, D, tid);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    accumulate<DC>(acc_v, sPt, sG, kg);   // dV += Pᵀ·dO
    accumulate<DC>(acc_k, sDSt, sQ, kg);  // dK += dSᵀ·Q
  }
  store_acc<DC>(acc_k, scale, dk, sx, b, h, k0 + r, c0, T, D, kg);
  store_acc<DC>(acc_v, 1.f, dv, sx, b, h, k0 + r, c0, T, D, kg);
}

// --- the one pass (f32, D ≤ 64) ------------------------------------------------

constexpr int OQ = 64;  // queries a step (the S tile's columns, SC)
constexpr int ONEPASS_MAX_D = 64;

// the ticket buffer: [work counter, finished blocks, the dQ tickets (B·H·nq),
// the dK/dV tickets (B·H·nkt)], int32, zero at rest
constexpr int TK_WORK = 0, TK_DONE = 1, TK_DQ = 2;

template <int DC, int KH>
constexpr size_t onepass_smem_bytes() {
  constexpr size_t BK = 64 * KH, LD = DC + 4;
  return (2 * BK * LD                   // sK, sV: the owned keys
          + 4 * OQ * LD                 // sQ, sG: two stages of the step's queries and their dO
          + 2 * BK * SPL                // sP, sDS: Pᵀ and dSᵀ
          + 4 * OQ) * sizeof(float)     // L, Δ: two stages
         + 16;                          // the work id
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// the dQ share's thread tile: RPT query rows × 4 columns of the step's [64
// × DC] tile, so that the block's NT threads cover it once
template <int DC, int NT>
struct DqTile {
  static constexpr int RPT = 16 * DC / NT;  // rows a thread: 4 at DC = 64 and 256 threads, 8 at 128
  static constexpr int NCG = DC / 4;        // column groups of 4
};

// t[i][j] += Σ_d a(row i)[d]·b(row cg + 8j)[d] over the DC columns: a the
// thread's 8 owned rows (+ 4i·LD), b the step's 64 rows; one operand of
// each pair feeds 8 FMAs (the pair's dots2 feeds 4 or 8)
template <int DC>
__device__ __forceinline__ void dots8(float (&t)[8][8], const float* a, const float* bt, int cg) {
  constexpr int LD = DC + 4;
#pragma unroll 1
  for (int d = 0; d < DC; d += 4) {
    float4 av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) av[i] = *reinterpret_cast<const float4*>(a + 4 * i * LD + d);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(bt + (cg + 8 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        t[i][j] = fmaf(av[i].x, bv.x, t[i][j]);
        t[i][j] = fmaf(av[i].y, bv.y, t[i][j]);
        t[i][j] = fmaf(av[i].z, bv.z, t[i][j]);
        t[i][j] = fmaf(av[i].w, bv.w, t[i][j]);
      }
    }
  }
}

// acc[i][4u + e] += Σ_j w(row i)[j]·x[j][4cg + 32u + e] over the 64 rows of
// a step: w the thread's 8 rows of a [BK × SPL] tile (+ 4i·SPL), x a [64 ×
// LD] tile
template <int DC>
__device__ __forceinline__ void acc8(float (&acc)[8][DC / 8], const float* w, const float* x, int cg) {
  constexpr int LD = DC + 4, NU = DC / 32;
#pragma unroll 1
  for (int j0 = 0; j0 < OQ; j0 += 4) {
    float4 wv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) wv[i] = *reinterpret_cast<const float4*>(w + 4 * i * SPL + j0);
#pragma unroll
    for (int jq = 0; jq < 4; ++jq) {
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const float4 xv = *reinterpret_cast<const float4*>(x + (j0 + jq) * LD + 4 * cg + 32 * u);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
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

// acc[i][e] += Σ_k dS[k][RPT·rg + i]·K[k][4cg + e] over the BK keys of the
// block in order: sDS its dSᵀ [BK × SPL], sK its keys [BK × LD]
template <int DC, int NT, int BK>
__device__ __forceinline__ void dq_share(float (&acc)[DqTile<DC, NT>::RPT][4], const float* sDS, const float* sK,
                                         int rg, int cg) {
  constexpr int LD = DC + 4, RPT = DqTile<DC, NT>::RPT;
#pragma unroll 4
  for (int kk = 0; kk < BK; ++kk) {
    float w[RPT];
    const float* ds = sDS + kk * SPL + RPT * rg;
    if constexpr (RPT % 4 == 0) {
#pragma unroll
      for (int i = 0; i < RPT; i += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(ds + i);
        w[i] = w4.x;
        w[i + 1] = w4.y;
        w[i + 2] = w4.z;
        w[i + 3] = w4.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < RPT; i += 2) {
        const float2 w2 = *reinterpret_cast<const float2*>(ds + i);
        w[i] = w2.x;
        w[i + 1] = w2.y;
      }
    }
    const float4 x = *reinterpret_cast<const float4*>(sK + kk * LD + 4 * cg);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      acc[i][0] = fmaf(w[i], x.x, acc[i][0]);
      acc[i][1] = fmaf(w[i], x.y, acc[i][1]);
      acc[i][2] = fmaf(w[i], x.z, acc[i][2]);
      acc[i][3] = fmaf(w[i], x.w, acc[i][3]);
    }
  }
}

// N float4 sums into dst (p[n], null where the value lies past T or D) in
// the order of the sum: the first writer stores, the others add to what is
// there (read past L1, every load in flight before the first add), and the
// last multiplies by mul; each value rounded once a step
template <int N>
__device__ __forceinline__ void add_ordered(float4* (&p)[N], float4 (&v)[N], bool first, bool last, float mul) {
  if (!first) {
    float4 o[N];
#pragma unroll
    for (int n = 0; n < N; ++n)
      if (p[n] != nullptr) o[n] = __ldcg(p[n]);
#pragma unroll
    for (int n = 0; n < N; ++n)
      if (p[n] != nullptr)
        v[n] = make_float4(__fadd_rn(o[n].x, v[n].x), __fadd_rn(o[n].y, v[n].y), __fadd_rn(o[n].z, v[n].z),
                           __fadd_rn(o[n].w, v[n].w));
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (p[n] == nullptr) continue;
    if (last) v[n] = make_float4(__fmul_rn(v[n].x, mul), __fmul_rn(v[n].y, mul), __fmul_rn(v[n].z, mul), __fmul_rn(v[n].w, mul));
    __stcg(p[n], v[n]);
  }
}

template <int DC, int KH>
__global__ void __launch_bounds__(128 * KH, 1)
onepass_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, Strides sx,
                   const float* __restrict__ dout, Strides so, const float* __restrict__ lse,
                   const float* __restrict__ delta, const float* __restrict__ mask, float* dq, float* dk, float* dv,
                   int* tickets, int H, int T, int D, int nkt, int nq, int splits, float scale) {
  constexpr int BK = 64 * KH, NT = 128 * KH, WARPS = NT / 32, LD = DC + 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // [BK × LD] the owned keys
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;      // 2 stages of [OQ × LD]: the step's queries
  float* sG = sQ + 2 * OQ * LD;  // their dO
  float* sP = sG + 2 * OQ * LD;  // [BK × SPL] Pᵀ
  float* sDS = sP + BK * SPL;    // dSᵀ
  float* sL = sDS + BK * SPL;    // 2 stages of L, then 2 of Δ
  float* sDl = sL + 2 * OQ;
  int* sWork = reinterpret_cast<int*>(sDl + 2 * OQ);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // two groups of WARPS/2 warps: group 0 forms Sᵀ, Pᵀ and dV, group 1 dPᵀ,
  // dSᵀ and dK; a thread owns keys r + 4i (i < 8) × the step's queries cg +
  // 8j (j < 8), and those keys × the columns 4cg + 32u of its dV or dK
  const int grp = warp / (WARPS / 2), r = (warp % (WARPS / 2)) * 32 + (lane >> 3), cg = lane & 7;
  using Dq = DqTile<DC, NT>;
  const int qr = tid / Dq::NCG, qc = tid % Dq::NCG;  // the dQ share: rows RPT·qr + i, columns 4qc + e
  // the work item, in the order blocks start: key tile fastest, then the split, then (b, h)
  if (tid == 0) *sWork = atomicAdd(tickets + TK_WORK, 1);
  __syncthreads();
  const int work = *sWork, kt = work % nkt, sp = (work / nkt) % splits, bh = work / nkt / splits;
  const int b = bh / H, h = bh % H, k0 = kt * BK;
  const int j0 = sp * nq / splits, j1 = (sp + 1) * nq / splits;  // the split's query steps
  const size_t row0 = (size_t)bh * T;
  int* dq_ticket = tickets + TK_DQ + (size_t)bh * nq;
  const float* mrow = mask + (size_t)b * T;
  float kb[8];  // the key bias of the owned keys (−1e9 past T): group 0's
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = k0 + r + 4 * i;
    kb[i] = t < T && mrow[t] > 0.f ? 0.f : MASK_BIAS;
  }

  // query rows past T arrive as zeros with L = Δ = 0: exact zeros
  auto load_step = [&](int j, int stage) {
    load_rows_f32<OQ, DC, NT>(sQ + stage * OQ * LD, LD, q, sx, b, h, j * OQ, T, 0, D, tid);
    load_rows_f32<OQ, DC, NT>(sG + stage * OQ * LD, LD, dout, so, b, h, j * OQ, T, 0, D, tid);
    load_vec_async<OQ, NT>(sL + stage * OQ, lse + row0, j * OQ, T, tid);
    load_vec_async<OQ, NT>(sDl + stage * OQ, delta + row0, j * OQ, T, tid);
  };
  load_rows_f32<BK, DC, NT>(sK, LD, k, sx, b, h, k0, T, 0, D, tid);
  load_rows_f32<BK, DC, NT>(sV, LD, v, sx, b, h, k0, T, 0, D, tid);
  load_step(j0, 0);
  cp_async_commit();

  float acc[8][DC / 8] = {};  // dV (group 0) or dK (group 1) of the owned keys
  float* sPt = sP + r * SPL;
  float* sDSt = sDS + r * SPL;
  for (int j = j0; j < j1; ++j) {
    const int stage = (j - j0) & 1;
    const float* sQs = sQ + stage * OQ * LD;
    const float* sGs = sG + stage * OQ * LD;
    cp_async_wait<0>();
    // this step's tiles are in for every thread, and every warp is done
    // with the last step's (stage ^ 1 of the ring, Pᵀ and dSᵀ): only now may
    // the next step's copies overwrite that stage
    __syncthreads();
    if (j + 1 < j1) {  // the next step's tiles, in flight during this step
      load_step(j + 1, stage ^ 1);
      cp_async_commit();
    }
    float t[8][8] = {};
    if (grp == 0) {  // Sᵀ = K·Qᵀ, once; Pᵀ = exp(Sᵀ·scale + bias − L)
      dots8<DC>(t, sK + r * LD, sQs, cg);
      const float* sLs = sL + stage * OQ;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float Lj = sLs[cg + 8 * jj];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          sPt[4 * i * SPL + cg + 8 * jj] = expf(__fsub_rn(__fadd_rn(__fmul_rn(t[i][jj], scale), kb[i]), Lj));
      }
    } else {  // dPᵀ = V·dOᵀ, once
      dots8<DC>(t, sV + r * LD, sGs, cg);
    }
    __syncthreads();  // Pᵀ in place
    if (grp == 1) {  // dSᵀ = Pᵀ·(dPᵀ − Δ)
      const float* sDls = sDl + stage * OQ;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float Dj = sDls[cg + 8 * jj];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          sDSt[4 * i * SPL + cg + 8 * jj] = __fmul_rn(sPt[4 * i * SPL + cg + 8 * jj], __fsub_rn(t[i][jj], Dj));
      }
    }
    __syncthreads();  // dSᵀ in place
    if (grp == 0)
      acc8<DC>(acc, sPt, sGs, cg);  // dV += Pᵀ·dO
    else
      acc8<DC>(acc, sDSt, sQs, cg);  // dK += dSᵀ·Q
    float dqs[Dq::RPT][4] = {};
    dq_share<DC, NT, BK>(dqs, sDS, sK, qr, qc);  // this key tile's share of the step's dQ: dS·K
    // into dq in key-tile order, a warp at a time: the ticket counts the
    // warps of the key tiles before this one that have added
    float4* ptr[Dq::RPT];
    float4 val[Dq::RPT];
#pragma unroll
    for (int i = 0; i < Dq::RPT; ++i) {
      const int tq = j * OQ + Dq::RPT * qr + i, c = 4 * qc;
      ptr[i] = tq < T && c < D ? reinterpret_cast<float4*>(dq + sx.at(b, h, tq) + c) : nullptr;
      val[i] = make_float4(dqs[i][0], dqs[i][1], dqs[i][2], dqs[i][3]);
    }
    if (nkt > 1) {
      if (lane == 0) {
        while (ld_acquire(dq_ticket + j) < WARPS * kt) __nanosleep(32);
      }
      __syncwarp();
    }
    add_ordered<Dq::RPT>(ptr, val, kt == 0, kt == nkt - 1, scale);
    if (nkt > 1) {
      __threadfence();
      __syncwarp();
      if (lane == 0 && atomicAdd(dq_ticket + j, 1) == WARPS * nkt - 1) dq_ticket[j] = 0;  // the last warp: zero at rest
    }
  }

  // dV (group 0) or dK (group 1, times scale) of the owned keys: the splits
  // in order, under the key tile's ticket
  int* kv_ticket = tickets + TK_DQ + (size_t)(gridDim.x / (nkt * splits)) * nq + (size_t)bh * nkt + kt;
  if (splits > 1) {
    if (tid == 0) {
      while (ld_acquire(kv_ticket) != sp) __nanosleep(32);
    }
    __syncthreads();
  }
  {
    constexpr int NU = DC / 32;
    float* out = grp == 0 ? dv : dk;
    float4* ptr[8 * NU];
    float4 val[8 * NU];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = k0 + r + 4 * i;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int c = 4 * cg + 32 * u, n = i * NU + u;
        ptr[n] = t < T && c < D ? reinterpret_cast<float4*>(out + sx.at(b, h, t) + c) : nullptr;
        val[n] = make_float4(acc[i][4 * u], acc[i][4 * u + 1], acc[i][4 * u + 2], acc[i][4 * u + 3]);
      }
    }
    add_ordered<8 * NU>(ptr, val, sp == 0, sp == splits - 1, grp == 0 ? 1.f : scale);
  }
  if (splits > 1) {
    __threadfence();
    __syncthreads();
    if (tid == 0) st_release(kv_ticket, sp == splits - 1 ? 0 : sp + 1);
  }
  if (tid == 0 && atomicAdd(tickets + TK_DONE, 1) == (int)gridDim.x - 1) {  // the last block: zero at rest
    tickets[TK_WORK] = 0;
    tickets[TK_DONE] = 0;
  }
}

// --- the one pass above D = 64 ---------------------------------------------------

constexpr int WQS = 32;        // queries a step
constexpr int WBT = 256;       // 8 warps: group 0 (warps 0–3) and group 1 (warps 4–7)
constexpr int WSPL = WQS + 4;  // row of Pᵀ and dSᵀ: ≡ 4 (mod 32) words
constexpr int WFC = 16;        // D columns of a streamed chunk (D > 256)
constexpr int WLF = WFC + 4;   // its rows

template <int DC, int BK>
constexpr size_t wide_onepass_smem_bytes() {
  constexpr size_t LD = DC + 4;
  return (2 * BK * LD        // sK, sV: the owned keys' column tile (sV the streamed chunks' ring above D = 256)
          + 4 * WQS * LD     // sQ, sG: two stages of the step's queries and their dO
          + 2 * BK * WSPL    // sP, sDS: Pᵀ and dSᵀ
          + 4 * WQS) * sizeof(float)  // L, Δ: two stages
         + 16;               // the work id
}

// t[i][j] += Σ_d a(row ak + KG·i)[d]·b(row bq + QG·j)[d] over d < dw, in
// order of d: a the owned keys' rows (K or V), b the step's (Q or dO)
template <int KG, int QF, int QG>
__device__ __forceinline__ void dots_kq(float (&t)[4][QF], const float* a, const float* bt, int ld, int dw) {
#pragma unroll 2
  for (int d = 0; d < dw; d += 4) {
    float4 av[4], bv[QF];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + KG * i * ld + d);
#pragma unroll
    for (int j = 0; j < QF; ++j) bv[j] = *reinterpret_cast<const float4*>(bt + QG * j * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < QF; ++j) {
        t[i][j] = fmaf(av[i].x, bv[j].x, t[i][j]);
        t[i][j] = fmaf(av[i].y, bv[j].y, t[i][j]);
        t[i][j] = fmaf(av[i].z, bv[j].z, t[i][j]);
        t[i][j] = fmaf(av[i].w, bv[j].w, t[i][j]);
      }
    }
  }
}

// The one pass at D > 64 (wide_onepass_f32_kernel<DC, BK>: DC = 128, BK =
// 64 keys a block at D ≤ 128; DC = 256, BK = 32 above, so at D = 192 a
// quarter of the products run on zero columns; a 192-column form on float2
// columns read 4% slower there all the same: PERF.md §6): a block owns BK
// keys of one (batch row, head) and a column tile of DC columns of dK, dV
// and dQ (all of D at D ≤ 256), and walks its split of the query steps of
// 32. Per step it forms Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ over the full D ONCE
// (group 0 Sᵀ and Pᵀ, group 1 dPᵀ and dSᵀ, 4 keys × QF queries a thread),
// then dV += Pᵀ·dO (group 0) and dK += dSᵀ·Q (group 1) into 8 keys × 8
// columns a thread held in registers across the query loop (BK·DC = 8192:
// 64 floats a thread), then the key tile's share of the step's dQ = dS·K,
// summed into dq in key-tile order under the (b, h, column tile, query
// step) ticket, as onepass_f32_kernel does. 10·T²·D operations a (row,
// head) at D ≤ 256; above, each column tile of 256 forms Sᵀ and dPᵀ again
// (⌈D/256⌉ times), from chunks of 16 columns of K, V, Q and dO streamed
// through a two-stage ring in sV's place. At D ≤ 256 K and V stay in
// shared memory for the block's life and the step's Q and dO come by
// cp.async into a ring of two stages, the next step's in flight while this
// one's FMAs run.
template <int DC, int BK>
__global__ void __launch_bounds__(WBT, 1)
wide_onepass_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                        Strides sx, const float* __restrict__ dout, Strides so, const float* __restrict__ lse,
                        const float* __restrict__ delta, const float* __restrict__ mask, float* dq, float* dk, float* dv,
                        int* tickets, int H, int T, int D, int nkt, int nq, int nct, int splits, float scale) {
  constexpr int LD = DC + 4, WARPS = WBT / 32;
  constexpr int KG = BK / 4, QF = BK * WQS / 512, QG = WQS / QF;  // formation: keys fk + KG·i, queries fq + QG·j
  constexpr int PKG = BK / 8, CG = DC / 8;                          // products: keys pk + PKG·i, columns 4pc + 4CG·u
  constexpr int NCG = DC / 4, RPT = WQS * NCG / WBT;                // dQ share: rows RPT·qr + i, columns 4qc + e
  static_assert(KG * QG == 128 && PKG * CG == 128 && RPT % 4 == 0, "each group's threads cover its tiles once");
  constexpr int RSTAGE = (2 * BK + 2 * WQS) * WLF;  // a streamed chunk of K, V, Q and dO
  static_assert(2 * RSTAGE <= BK * LD, "the streamed ring fits sV");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // [BK × LD]
  float* sV = sK + BK * LD;                        // [BK × LD], or the streamed ring
  float* sQ = sV + BK * LD;                        // 2 stages of [WQS × LD]
  float* sG = sQ + 2 * WQS * LD;
  float* sP = sG + 2 * WQS * LD;  // [BK × WSPL] Pᵀ
  float* sDS = sP + BK * WSPL;    // dSᵀ
  float* sL = sDS + BK * WSPL;    // 2 stages of L, then 2 of Δ
  float* sDl = sL + 2 * WQS;
  int* sWork = reinterpret_cast<int*>(sDl + 2 * WQS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, grp = warp >> 2, gt = tid & 127;
  const int fk = gt / QG, fq = gt % QG, pk = gt / CG, pc = gt % CG, qr = tid / NCG, qc = tid % NCG;
  // the work item, in the order blocks start: key tile fastest, then the
  // column tile, the split, (b, h)
  if (tid == 0) *sWork = atomicAdd(tickets + TK_WORK, 1);
  __syncthreads();
  const int work = *sWork, kt = work % nkt, ct = work / nkt % nct, sp = work / nkt / nct % splits;
  const int bh = work / nkt / nct / splits, b = bh / H, h = bh % H, k0 = kt * BK, c0 = ct * DC;
  const int j0 = sp * nq / splits, j1 = (sp + 1) * nq / splits;  // the split's query steps
  const bool streamed = nct > 1;
  const size_t row0 = (size_t)bh * T;
  const int bhc = bh * nct + ct;
  int* dq_ticket = tickets + TK_DQ + (size_t)bhc * nq;
  const float* mrow = mask + (size_t)b * T;
  float kb[4];  // the key bias of the thread's formation keys (−1e9 past T): group 0's
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + fk + KG * i;
    kb[i] = t < T && mrow[t] > 0.f ? 0.f : MASK_BIAS;
  }

  // query rows past T arrive as zeros with L = Δ = 0: exact zeros
  auto load_step = [&](int j, int stage) {
    load_rows_f32<WQS, DC, WBT>(sQ + stage * WQS * LD, LD, q, sx, b, h, j * WQS, T, c0, D, tid);
    load_rows_f32<WQS, DC, WBT>(sG + stage * WQS * LD, LD, dout, so, b, h, j * WQS, T, c0, D, tid);
    load_vec_async<WQS, WBT>(sL + stage * WQS, lse + row0, j * WQS, T, tid);
    load_vec_async<WQS, WBT>(sDl + stage * WQS, delta + row0, j * WQS, T, tid);
  };
  // chunk c of the formation's columns (D > 256): K, V, Q, dO rows of 16
  auto load_chunk = [&](int j, int c, float* st) {
    load_rows_f32<BK, WFC, WBT>(st, WLF, k, sx, b, h, k0, T, c * WFC, D, tid);
    load_rows_f32<BK, WFC, WBT>(st + BK * WLF, WLF, v, sx, b, h, k0, T, c * WFC, D, tid);
    load_rows_f32<WQS, WFC, WBT>(st + 2 * BK * WLF, WLF, q, sx, b, h, j * WQS, T, c * WFC, D, tid);
    load_rows_f32<WQS, WFC, WBT>(st + (2 * BK + WQS) * WLF, WLF, dout, so, b, h, j * WQS, T, c * WFC, D, tid);
  };
  load_rows_f32<BK, DC, WBT>(sK, LD, k, sx, b, h, k0, T, c0, D, tid);
  if (!streamed) load_rows_f32<BK, DC, WBT>(sV, LD, v, sx, b, h, k0, T, 0, D, tid);
  load_step(j0, 0);
  cp_async_commit();

  float acc[8][8] = {};  // dV (group 0) or dK (group 1): keys k0 + pk + PKG·i × columns c0 + 4pc + 4CG·u + e
  const int nfc = (D + WFC - 1) / WFC;
  for (int j = j0; j < j1; ++j) {
    const int stage = (j - j0) & 1;
    const float* sQs = sQ + stage * WQS * LD;
    const float* sGs = sG + stage * WQS * LD;
    cp_async_wait<0>();
    // this step's tiles are in for every thread, and every warp is done
    // with the last step's: only now may copies overwrite them
    __syncthreads();
    if (j + 1 < j1) {  // the next step's tiles, in flight during this step
      load_step(j + 1, stage ^ 1);
      cp_async_commit();
    }
    float t[4][QF] = {};
    if (!streamed) {  // Sᵀ = K·Qᵀ (group 0) or dPᵀ = V·dOᵀ (group 1), once
      if (grp == 0)
        dots_kq<KG, QF, QG>(t, sK + fk * LD, sQs + fq * LD, LD, D);
      else
        dots_kq<KG, QF, QG>(t, sV + fk * LD, sGs + fq * LD, LD, D);
    } else {  // the same over all of D, 16 columns at a time through the ring in sV
      load_chunk(j, 0, sV);
      cp_async_commit();
      for (int c = 0; c < nfc; ++c) {
        cp_async_wait<0>();
        __syncthreads();  // chunk c is in, and every warp is done with chunk c − 1
        if (c + 1 < nfc) {
          load_chunk(j, c + 1, sV + ((c + 1) & 1) * RSTAGE);
          cp_async_commit();
        }
        const float* st = sV + (c & 1) * RSTAGE;
        const int dw = min(WFC, D - c * WFC);
        if (grp == 0)
          dots_kq<KG, QF, QG>(t, st + fk * WLF, st + (2 * BK + fq) * WLF, WLF, dw);
        else
          dots_kq<KG, QF, QG>(t, st + (BK + fk) * WLF, st + (2 * BK + WQS + fq) * WLF, WLF, dw);
      }
    }
    if (grp == 0) {  // Pᵀ = exp(Sᵀ·scale + bias − L)
      const float* sLs = sL + stage * WQS;
#pragma unroll
      for (int jj = 0; jj < QF; ++jj) {
        const float Lj = sLs[fq + QG * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          sP[(fk + KG * i) * WSPL + fq + QG * jj] = expf(__fsub_rn(__fadd_rn(__fmul_rn(t[i][jj], scale), kb[i]), Lj));
      }
    }
    __syncthreads();  // Pᵀ in place
    if (grp == 1) {  // dSᵀ = Pᵀ·(dPᵀ − Δ)
      const float* sDls = sDl + stage * WQS;
#pragma unroll
      for (int jj = 0; jj < QF; ++jj) {
        const float Dj = sDls[fq + QG * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int at = (fk + KG * i) * WSPL + fq + QG * jj;
          sDS[at] = __fmul_rn(sP[at], __fsub_rn(t[i][jj], Dj));
        }
      }
    }
    __syncthreads();  // dSᵀ in place
    {  // dV += Pᵀ·dO (group 0) or dK += dSᵀ·Q (group 1), over the step's queries in order
      const float* w = (grp == 0 ? sP : sDS) + pk * WSPL;
      const float* x = (grp == 0 ? sGs : sQs) + 4 * pc;
#pragma unroll 1
      for (int jq0 = 0; jq0 < WQS; jq0 += 4) {
        float4 wv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) wv[i] = *reinterpret_cast<const float4*>(w + PKG * i * WSPL + jq0);
#pragma unroll
        for (int jq = 0; jq < 4; ++jq) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float4 xv = *reinterpret_cast<const float4*>(x + (jq0 + jq) * LD + 4 * CG * u);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
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
    // this key tile's share of the step's dQ: dS·K over the BK keys in order
    float dqs[RPT][4] = {};
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float wr[RPT];
#pragma unroll
      for (int i = 0; i < RPT; i += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(sDS + kk * WSPL + RPT * qr + i);
        wr[i] = w4.x;
        wr[i + 1] = w4.y;
        wr[i + 2] = w4.z;
        wr[i + 3] = w4.w;
      }
      const float4 x = *reinterpret_cast<const float4*>(sK + kk * LD + 4 * qc);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        dqs[i][0] = fmaf(wr[i], x.x, dqs[i][0]);
        dqs[i][1] = fmaf(wr[i], x.y, dqs[i][1]);
        dqs[i][2] = fmaf(wr[i], x.z, dqs[i][2]);
        dqs[i][3] = fmaf(wr[i], x.w, dqs[i][3]);
      }
    }
    // into dq in key-tile order, a warp at a time: the ticket counts the
    // warps of the key tiles before this one that have added
    float4* ptr[RPT];
    float4 val[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int tq = j * WQS + RPT * qr + i, c = c0 + 4 * qc;
      ptr[i] = tq < T && c < D ? reinterpret_cast<float4*>(dq + sx.at(b, h, tq) + c) : nullptr;
      val[i] = make_float4(dqs[i][0], dqs[i][1], dqs[i][2], dqs[i][3]);
    }
    if (nkt > 1) {
      if (lane == 0) {
        while (ld_acquire(dq_ticket + j) < WARPS * kt) __nanosleep(32);
      }
      __syncwarp();
    }
    add_ordered<RPT>(ptr, val, kt == 0, kt == nkt - 1, scale);
    if (nkt > 1) {
      __threadfence();
      __syncwarp();
      if (lane == 0 && atomicAdd(dq_ticket + j, 1) == WARPS * nkt - 1) dq_ticket[j] = 0;  // the last warp: zero at rest
    }
  }

  // dV (group 0) or dK (group 1, times scale) of the owned keys' column
  // tile: the splits in order, under the (b, h, column tile, key tile)'s ticket
  int* kv_ticket = tickets + TK_DQ + (size_t)(gridDim.x / (nkt * nct * splits)) * nct * nq + (size_t)bhc * nkt + kt;
  if (splits > 1) {
    if (tid == 0) {
      while (ld_acquire(kv_ticket) != sp) __nanosleep(32);
    }
    __syncthreads();
  }
  float* out = grp == 0 ? dv : dk;
#pragma unroll
  for (int u = 0; u < 2; ++u) {  // a column half at a time: fewer values live at once
    float4* ptr[8];
    float4 val[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = k0 + pk + PKG * i, c = c0 + 4 * pc + 4 * CG * u;
      ptr[i] = t < T && c < D ? reinterpret_cast<float4*>(out + sx.at(b, h, t) + c) : nullptr;
      val[i] = make_float4(acc[i][4 * u], acc[i][4 * u + 1], acc[i][4 * u + 2], acc[i][4 * u + 3]);
    }
    add_ordered<8>(ptr, val, sp == 0, sp == splits - 1, grp == 0 ? 1.f : scale);
  }
  if (splits > 1) {
    __threadfence();
    __syncthreads();
    if (tid == 0) st_release(kv_ticket, sp == splits - 1 ? 0 : sp + 1);
  }
  if (tid == 0 && atomicAdd(tickets + TK_DONE, 1) == (int)gridDim.x - 1) {  // the last block: zero at rest
    tickets[TK_WORK] = 0;
    tickets[TK_DONE] = 0;
  }
}

template <int DC, int BK>
cudaError_t launch_wide_onepass(const float* q, const float* k, const float* v, Strides sx, const float* dout,
                                Strides so, const float* lse, const float* delta, const float* mask, float* dq,
                                float* dk, float* dv, int* tickets, int B, int T, int H, int D, int splits, float scale,
                                cudaStream_t stream) {
  constexpr size_t smem = wide_onepass_smem_bytes<DC, BK>();
  const int nkt = (T + BK - 1) / BK, nq = (T + WQS - 1) / WQS, nct = (D + DC - 1) / DC;
  const long long blocks = (long long)B * H * nkt * nct * splits;
  if (blocks > 0x7fffffff || (DC == 128 && nct > 1)) return cudaErrorInvalidValue;
  cudaError_t e =
      cudaFuncSetAttribute(wide_onepass_f32_kernel<DC, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  wide_onepass_f32_kernel<DC, BK><<<(unsigned)blocks, WBT, smem, stream>>>(q, k, v, sx, dout, so, lse, delta, mask, dq, dk,
                                                                          dv, tickets, H, T, D, nkt, nq, nct, splits, scale);
  return cudaGetLastError();
}

template <int DC, int KH>
cudaError_t launch_onepass(const float* q, const float* k, const float* v, Strides sx, const float* dout, Strides so,
                           const float* lse, const float* delta, const float* mask, float* dq, float* dk, float* dv,
                           int* tickets, int B, int T, int H, int D, int splits, float scale, cudaStream_t stream) {
  constexpr size_t smem = onepass_smem_bytes<DC, KH>();
  const int nkt = (T + 64 * KH - 1) / (64 * KH), nq = (T + OQ - 1) / OQ;
  const long long blocks = (long long)B * H * nkt * splits;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(onepass_f32_kernel<DC, KH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  onepass_f32_kernel<DC, KH><<<(unsigned)blocks, 128 * KH, smem, stream>>>(q, k, v, sx, dout, so, lse, delta, mask, dq,
                                                                         dk, dv, tickets, H, T, D, nkt, nq, splits, scale);
  return cudaGetLastError();
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

template <int DC>
cudaError_t launch_simt(const SimtArgs& a) {
  const int nct = (a.D + DC - 1) / DC;
  const dim3 grid((a.T + SR - 1) / SR, a.H * nct, a.B);
  auto q = static_cast<const float*>(a.q);
  auto k = static_cast<const float*>(a.k);
  auto v = static_cast<const float*>(a.v);
  auto g = static_cast<const float*>(a.dout);
  if (a.dq != nullptr) {
    constexpr size_t smem = dq_smem_bytes<DC>();
    cudaError_t e = cudaFuncSetAttribute(simt_dq_kernel<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    simt_dq_kernel<DC><<<grid, STHREADS, smem, a.stream>>>(q, k, v, a.sx, g, a.so, a.lse, a.delta, a.mask,
                                                          static_cast<float*>(a.dq), a.H, nct, a.T, a.D, a.scale);
  } else {
    constexpr size_t smem = dkv_smem_bytes<DC>();
    cudaError_t e = cudaFuncSetAttribute(simt_dkv_kernel<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    simt_dkv_kernel<DC><<<grid, STHREADS, smem, a.stream>>>(q, k, v, a.sx, g, a.so, a.lse, a.delta, a.mask,
                                                           static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.H,
                                                           nct, a.T, a.D, a.scale);
  }
  return cudaGetLastError();
}

}  // namespace

int attend_bwd_simt(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                    const void* delta, const void* mask, void* dq, void* dk, void* dv, int B, int T, int H, int D,
                    int sx_b, int sx_h, int sx_t, int so_b, int so_h, int so_t, float scale, void* stream) {
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
  // column tiles (and D steps of the scores) of 64, at any D: the pair
  // serves the direct entries only (the wrappers take the one pass)
  return static_cast<int>(launch_simt<64>(a));
}

// q, k, v, dq: f32 with element strides (sx_b, sx_h, sx_t), D contiguous;
// dout: f32 with strides (so_b, so_h, so_t); lse, delta [B, H, T] f32; mask
// [B, T] f32. Every row 16-byte aligned. Any T ≥ 1; D % 8 == 0, any D.
extern "C" int msa_attention_bwd_dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                        const void* delta, const void* mask, void* dq, int B, int T, int H, int D,
                                        int sx_b, int sx_h, int sx_t, int so_b, int so_h, int so_t, float scale,
                                        void* stream) {
  return attend_bwd_simt(q, k, v, dout, lse, delta, mask, dq, nullptr, nullptr, B, T, H, D, sx_b, sx_h, sx_t, so_b,
                         so_h, so_t, scale, stream);
}

// as msa_attention_bwd_dq_f32; dk and dv take the strides of q, k and v
extern "C" int msa_attention_bwd_dkv_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                         const void* delta, const void* mask, void* dk, void* dv, int B, int T, int H,
                                         int D, int sx_b, int sx_h, int sx_t, int so_b, int so_h, int so_t,
                                         float scale, void* stream) {
  return attend_bwd_simt(q, k, v, dout, lse, delta, mask, nullptr, dk, dv, B, T, H, D, sx_b, sx_h, sx_t, so_b, so_h,
                         so_t, scale, stream);
}

// The one pass on f32 operands at any D (onepass_f32_kernel at D ≤ 64,
// wide_onepass_f32_kernel above): dq, dk and dv in one launch. Arguments as
// msa_attention_bwd_dq_f32's, with dk and dv beside dq (the strides of q,
// k and v); tickets the int32 buffer of the plan (2 + B·H·nct·(nq + nkt)
// elements: nq = ⌈T/64⌉ at D ≤ 64 and ⌈T/32⌉ above, nkt = ⌈T/BK⌉, nct =
// ⌈D/256⌉ above D = 256, else 1), zero at rest: the kernel leaves it so;
// plan = BK | splits << 10 (ops/kernels/attention_bwd_plan.py): BK 64 or
// 128 keys a block at D ≤ 64, 64 at D ≤ 128, 32 above; 1 ≤ splits ≤ nq.
// Returns cudaErrorInvalidValue on a shape or plan the kernel cannot take.
extern "C" int msa_attention_bwd_onepass_f32(const void* q, const void* k, const void* v, const void* dout,
                                             const void* lse, const void* delta, const void* mask, void* dq, void* dk,
                                             void* dv, void* tickets, int B, int T, int H, int D, int sx_b, int sx_h,
                                             int sx_t, int so_b, int so_h, int so_t, int plan, float scale,
                                             void* stream) {
  const int bk = plan & 1023, splits = plan >> 10;
  const int nq = D > ONEPASS_MAX_D ? (T + WQS - 1) / WQS : (T + OQ - 1) / OQ;
  // the key tile the kernel of this D takes: 64 or 128 at D ≤ 64, 64 at D ≤ 128, 32 above
  const bool bk_ok = D <= ONEPASS_MAX_D ? bk == 64 || bk == 128 : bk == (D <= 128 ? 64 : 32);
  if (B < 1 || H < 1 || T < 1 || D < 8 || D % 8 || !bk_ok || splits < 1 || splits > nq || tickets == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sx{sx_b, sx_h, sx_t}, so{so_b, so_h, so_t};
  auto qf = static_cast<const float*>(q), kf = static_cast<const float*>(k), vf = static_cast<const float*>(v);
  auto gf = static_cast<const float*>(dout), lf = static_cast<const float*>(lse), df = static_cast<const float*>(delta);
  auto mf = static_cast<const float*>(mask);
  auto dqf = static_cast<float*>(dq), dkf = static_cast<float*>(dk), dvf = static_cast<float*>(dv);
  auto tk = static_cast<int*>(tickets);
  auto st = static_cast<cudaStream_t>(stream);
  // 32 columns at D ≤ 32 (the custom widths' D = 24 and 25 run faster than
  // on 64: PERF.md §6), else 64
  cudaError_t e;
  if (D > 128)
    e = launch_wide_onepass<256, 32>(qf, kf, vf, sx, gf, so, lf, df, mf, dqf, dkf, dvf, tk, B, T, H, D, splits, scale, st);
  else if (D > ONEPASS_MAX_D)
    e = launch_wide_onepass<128, 64>(qf, kf, vf, sx, gf, so, lf, df, mf, dqf, dkf, dvf, tk, B, T, H, D, splits, scale, st);
  else if (D <= 32)
    e = bk == 128 ? launch_onepass<32, 2>(qf, kf, vf, sx, gf, so, lf, df, mf, dqf, dkf, dvf, tk, B, T, H, D, splits, scale, st)
                  : launch_onepass<32, 1>(qf, kf, vf, sx, gf, so, lf, df, mf, dqf, dkf, dvf, tk, B, T, H, D, splits, scale, st);
  else
    e = bk == 128 ? launch_onepass<64, 2>(qf, kf, vf, sx, gf, so, lf, df, mf, dqf, dkf, dvf, tk, B, T, H, D, splits, scale, st)
                  : launch_onepass<64, 1>(qf, kf, vf, sx, gf, so, lf, df, mf, dqf, dkf, dvf, tk, B, T, H, D, splits, scale, st);
  return static_cast<int>(e);
}
