// The bf16 attention backward above head dim 128 on the tensor cores: rows
// 3 (dQ) and 4 (dK, dV) at any D > 128 (D % 8 == 0). With L = lse, Δ = rowsum(dO∘O)
// and P = exp(S·scale + bias − L) recomputed per tile (never stored):
//   dV = Pᵀ·dO,   dS = P ∘ (dO·Vᵀ − Δ),   dQ = scale·dS·K,   dK = scale·dSᵀ·Q.
// msa_attention_bwd_dq and msa_attention_bwd_dkv (attention_bwd.cu) call
// attend_bwd_wide above D = 128 in bf16; the f32 backward there runs
// attention_bwd_f32.cu.
//
// Replaces, at D > 128 in bf16, msa_tpu/ops/pallas/attention.py:
// attention_bwd's dQ kernel (pallas_call at :370, body _bwd_dq_kernel
// :256-293) and dK/dV kernel (pallas_call at :395, body _bwd_dkv_kernel
// :296-340). JAX pads D to a multiple of 128 there and serves any D.
//
// Same rounding points as the TPU kernels and attention_bwd.cu's D ≤ 128
// pair: S and dO·Vᵀ in f32 from bf16 operands (mma.sync m16n8k16: exact
// products, another summation order); s = S·scale + bias with −1e9 on
// masked keys (each product and sum rounded once); P = exp(s − L) and dS =
// P·(dP − Δ) in f32; dS is rounded to bf16 before dS·K, Pᵀ before Pᵀ·dO
// and dSᵀ before dSᵀ·Q; the f32 sums are multiplied by scale at the end
// (dQ, dK) and rounded once. Rows and keys past T are never written: a
// padded query row has q = dO = 0 and L = Δ = 0 and a padded key k = v = 0,
// so both add exact zeros; a row with no valid key has L ≈ −1e9 + log T_pad
// (the forward's), so its gradient spreads over the keys as in JAX. Each
// output tile has one owning block and sums in a fixed order, with no
// atomics: two calls are bit-equal.
//
// What bounds it on the card: the function needs 10·T²·D operations per
// (row, head) (S, dP, dQ, dK, dV; the pair forms S and dP in both kernels,
// 14·T²·D), on 4·T·D·2 bytes in and 3·T·D·2 out. At B=8 T=512 H=4 D=192
// that is 16.1 GFLOP (16.3 µs at 989 TFLOP/s) over 25 MB (7.5 µs at
// 3.35 TB/s): bound by operations.
//
// The design, on attention_mma.cuh's primitives: one block per (64-row
// tile, column tile of the output, head, batch row), 4 warps of 16 owned
// rows; the other side's operands come through one ring of three stages
// filled by cp.async two steps ahead (one barrier a step), 64 columns a
// stage. The owned rows' operands (OS) either stay resident in shared
// memory over all of D (rows of DP + 8, DP = D rounded up to 64), or are
// streamed: their 64-column chunks ride in the ring beside the other
// side's chunks of the same columns, read again from L2 at every step, so
// that shared memory does not grow with D. They stream only where the
// resident tiles do not fit (dQ above D = 640, dK/dV above 768): on an
// H100 (profile_slice.py --attn-wide-tiles, PERF.md §6) resident read
// 6–30% faster at every D where both ran (192, 256, 640, 768).
// - dQ (wide_bwd_dq_kernel): owned rows are queries (Q and dO in shared
//   memory); per step of 64 keys, D/64 ring steps bring K's and V's column
//   chunks ([64 keys × 64] each) and S = Q·Kᵀ, dP = dO·Vᵀ accumulate in
//   registers over them; P and dS in registers, bf16(dS) packed straight
//   into A fragments (p_frags); then one ring step per 64 columns of the
//   block's tile brings K's chunk and dQ += dS·K (tile_pv). 64 + 64 + NC/2
//   accumulator floats a thread.
// - dK/dV (wide_bwd_dkv_kernel): owned rows are keys (K and V in shared
//   memory); per step of 32 queries, D/64 ring steps bring Q's and dO's
//   chunks and Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ accumulate; Pᵀ and dSᵀ in registers
//   (the key bias per lane row, L and Δ per column, staged with the first
//   chunk), both packed into A fragments; then one ring step per 64
//   columns brings dO's and Q's chunks, dV += Pᵀ·dO and dK += dSᵀ·Q.
//   Tiles of 128 columns: 128 accumulator floats a thread for dK and dV
//   (244 registers), so a wider tile does not fit. Split over a dV block
//   (Sᵀ and Pᵀ only) and a dK block at one 192-column tile, the pair read
//   slower than two 128-column tiles on an H100 (why was not measured):
//   not kept.
// The dQ kernel's column tile (dq_nc): one tile of 192 for D ≤ 192 unless
// that grid fills at most half of the SMs, else 128, as the forward picks
// it. On an H100 at B=8 T=512 H=4 D=192 the 192 tile read 1.7× faster than
// 128 (profile_slice.py --attn-wide-tiles, PERF.md §6).
// Shared memory with the owned tiles resident, at D = 192: 106 KB (dQ) and
// 79 KB (dK/dV) a block, 2 blocks an SM; at D = 512: 188 and 161 KB, 1; at
// D = 640 (dQ) and 768 (dK/dV): 221 and 223 KB. Streamed: 109 KB and 82 KB
// at any D, 2 blocks an SM.
#include "attention_mma.cuh"

namespace {

constexpr int WR = 64;         // owned rows a block (queries for dQ, keys for dK/dV)
constexpr int WKV = 128;       // the dK/dV kernel's column tile
constexpr int WCH = 64;        // columns a ring stage holds
constexpr int WLD = WCH + 8;   // row of a ring stage (bf16)
constexpr int WSTAGES = 3;     // ring stages; copies run two steps ahead
constexpr int WTHREADS = 128;  // 4 warps of 16 owned rows
constexpr int WKS = 64;        // keys a dQ step
constexpr int WQS = 32;        // queries a dK/dV step
constexpr int WSMEM_MAX = 232448;  // the shared memory a block can have on an H100

// the owned rows' Q, dO (or K, V) over all DP columns: rows [r0, r0 + WR)
// of head h of batch row b, zeros past D and T, by cp.async
__device__ __forceinline__ void load_owned(bf16* dst, const bf16* __restrict__ src, Strides st, int b, int h, int r0,
                                           int T, int D, int DP, int tid) {
  const int vecs = DP / 8;
  for (int i = tid; i < WR * vecs; i += WTHREADS) {
    const int r = i / vecs, c = (i % vecs) * 8, t = r0 + r;
    const bool ok = t < T && c < D;
    cp_async16(dst + r * (DP + 8) + c, ok ? src + st.at(b, h, t) + c : src, ok);
  }
}

// the A fragments of columns [col, col + 64) of the warp's 16 owned rows
// (p: the lane's ldmatrix row of the owned tile)
__device__ __forceinline__ void chunk_frags(uint32_t (&f)[WCH / 16][4], const bf16* p, int col) {
#pragma unroll
  for (int kk = 0; kk < WCH / 16; ++kk) ldsm_x4(f[kk], p + col + kk * 16);
}

// acc·mul rounded once to bf16 at the warp's rows t0 + g, t0 + g + 8 < T
// and the tile's columns c0 + 8n < D of dst
template <int NC>
__device__ __forceinline__ void store_tile(const float (&acc)[NC / 8][4], float mul, bf16* __restrict__ dst,
                                           Strides st, int b, int h, int t0, int c0, int T, int D, int lane) {
  const int t = t0 + (lane >> 2), cq = (lane & 3) << 1;
#pragma unroll
  for (int n = 0; n < NC / 8; ++n) {
    const int col = c0 + n * 8;
    if (col < D) {
      if (t < T)
        *reinterpret_cast<uint32_t*>(dst + st.at(b, h, t) + col + cq) =
            pack_bf16(__fmul_rn(acc[n][0], mul), __fmul_rn(acc[n][1], mul));
      if (t + 8 < T)
        *reinterpret_cast<uint32_t*>(dst + st.at(b, h, t + 8) + col + cq) =
            pack_bf16(__fmul_rn(acc[n][2], mul), __fmul_rn(acc[n][3], mul));
    }
  }
}

// a ring stage of the dQ kernel: K's and V's chunks [WKS × WLD], and Q's
// and dO's [WR × WLD] where streamed; of the dK/dV kernel: Q's and dO's
// chunks [WQS × WLD], and K's and V's [WR × WLD] where streamed
__host__ __device__ constexpr int dq_stage(bool os) { return (2 * WKS + (os ? 2 * WR : 0)) * WLD; }
__host__ __device__ constexpr int dkv_stage(bool os) { return (2 * WQS + (os ? 2 * WR : 0)) * WLD; }

size_t dq_smem(int dp, bool os) {
  return (os ? 0 : (size_t)2 * WR * (dp + 8) * sizeof(bf16))    // sQ, sG, where resident
         + (size_t)WSTAGES * dq_stage(os) * sizeof(bf16)       // the ring
         + (size_t)2 * WKS * sizeof(float);                    // the key mask of two steps
}

size_t dkv_smem(int dp, bool os) {
  return (os ? 0 : (size_t)2 * WR * (dp + 8) * sizeof(bf16))    // sK, sV, where resident
         + (size_t)WSTAGES * dkv_stage(os) * sizeof(bf16)      // the ring
         + (size_t)4 * WQS * sizeof(float);                    // L and Δ of two steps
}

// the owned tiles stream only where they do not fit resident
bool wide_owned_streamed(int DP, bool dq) { return (dq ? dq_smem(DP, false) : dkv_smem(DP, false)) > WSMEM_MAX; }

template <int NC, bool OS>
__global__ void __launch_bounds__(WTHREADS)
wide_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v, Strides sx,
                   const bf16* __restrict__ dout, Strides so, const float* __restrict__ lse,
                   const float* __restrict__ delta, const float* __restrict__ mask, bf16* __restrict__ dq, int T,
                   int H, int D, int nct, float scale) {
  // K's chunk, then V's (or K's chunk of the tile alone), then Q's and dO's where streamed
  constexpr int STAGE = dq_stage(OS);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int DP = (D + WCH - 1) / WCH * WCH, LDO = DP + 8;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);                  // [WR × LDO], where resident
  bf16* sG = sQ + WR * LDO;                                      // dO
  bf16* sR = OS ? sQ : sG + WR * LDO;                            // [WSTAGES][STAGE]
  float* sM = reinterpret_cast<float*>(sR + WSTAGES * STAGE);  // the key mask, [2][WKS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * WR, h = blockIdx.y / nct, c0 = (blockIdx.y % nct) * NC, b = blockIdx.z;
  const size_t row0 = ((size_t)b * H + h) * T;
  const float* mrow = mask + (size_t)b * T;
  const int nk = (T + WKS - 1) / WKS, nkc = DP / WCH, nvc = min(NC, DP - c0) / WCH, per = nkc + nvc;
  const int steps = nk * per;

  // step s: of key step j = s / per, K's and V's chunk c (c < nkc; the key
  // mask with c = 0; Q's and dO's chunk c where streamed) or K's chunk of
  // the block's columns c0 + 64(c − nkc).
  // Keys past T arrive as zeros under the −1e9 bias: exact zeros (dS·K
  // with K = 0)
  auto issue = [&](int s) {
    if (s < steps) {
      const int j = s / per, c = s % per, t0 = j * WKS;
      bf16* dst = sR + (s % WSTAGES) * STAGE;
      const int col = c < nkc ? c * WCH : c0 + (c - nkc) * WCH;
      load_tile_async<WKS, WCH, WTHREADS>(dst, k + col, sx, b, h, t0, T, D - col, tid);
      if (c < nkc) load_tile_async<WKS, WCH, WTHREADS>(dst + WKS * WLD, v + col, sx, b, h, t0, T, D - col, tid);
      if (OS && c < nkc) {
        load_tile_async<WR, WCH, WTHREADS>(dst + 2 * WKS * WLD, q + col, sx, b, h, q0, T, D - col, tid);
        load_tile_async<WR, WCH, WTHREADS>(dst + (2 * WKS + WR) * WLD, dout + col, so, b, h, q0, T, D - col, tid);
      }
      if (c == 0) load_vec_async<WKS, WTHREADS>(sM + (j & 1) * WKS, mrow, t0, T, tid);
    }
    cp_async_commit();
  };
  int step = 0;
  auto arrive = [&]() {  // as attention_wide_mma.cu's
    cp_async_wait<1>();
    __syncthreads();
    issue(step + 2);
    return sR + (step++ % WSTAGES) * STAGE;
  };

  if constexpr (!OS) {
    load_owned(sQ, q, sx, b, h, q0, T, D, DP, tid);
    load_owned(sG, dout, so, b, h, q0, T, D, DP, tid);
  }
  issue(0);  // resident Q and dO land with the first step
  issue(1);

  // L and Δ of the lane's rows g and g + 8; rows past T have q = dO = 0
  // and L = Δ = 0, so their dS is 0, and they are not written
  const int r = q0 + warp * 16 + (lane >> 2);
  const float L[2] = {r < T ? lse[row0 + r] : 0.f, r + 8 < T ? lse[row0 + r + 8] : 0.f};
  const float Dl[2] = {r < T ? delta[row0 + r] : 0.f, r + 8 < T ? delta[row0 + r + 8] : 0.f};
  // the lane's ldmatrix row of the owned tiles: resident, or in a stage
  const int frow = warp * 16 + (lane & 15), fcol = (lane >> 4) << 3, frag = frow * LDO + fcol;

  float acc[NC / 8][4] = {};
  for (int j = 0; j < nk; ++j) {
    // S = Q·Kᵀ and dP = dO·Vᵀ over D, then s = S·scale + bias (each rounded
    // once), P = exp(s − L), dS = P·(dP − Δ): all in f32
    float s[WKS / 8][4] = {}, dp[WKS / 8][4] = {};
    for (int c = 0; c < nkc; ++c) {
      const bf16* st = arrive();
      uint32_t f[WCH / 16][4];
      chunk_frags(f, OS ? st + (2 * WKS + frow) * WLD + fcol : sQ + frag, OS ? 0 : c * WCH);
      tile_dots_acc<WKS, WCH, WLD>(s, f, st, lane);
      chunk_frags(f, OS ? st + (2 * WKS + WR + frow) * WLD + fcol : sG + frag, OS ? 0 : c * WCH);
      tile_dots_acc<WKS, WCH, WLD>(dp, f, st + WKS * WLD, lane);
    }
    score_epilogue<WKS>(s, sM + (j & 1) * WKS, scale, lane);
#pragma unroll
    for (int n = 0; n < WKS / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = __fmul_rn(expf(__fsub_rn(s[n][e], L[e >> 1])), __fsub_rn(dp[n][e], Dl[e >> 1]));
    }
    uint32_t pf[WKS / 16][4];
    p_frags<WKS>(pf, s);
#pragma unroll
    for (int cc = 0; cc < NC / WCH; ++cc) {  // dQ += bf16(dS)·K over the block's columns
      if (cc < nvc) {
        const bf16* st = arrive();
        tile_pv<WKS, WCH, WLD>(*reinterpret_cast<float(*)[WCH / 8][4]>(&acc[cc * (WCH / 8)]), pf, st, lane);
      }
    }
  }
  store_tile<NC>(acc, scale, dq, sx, b, h, q0 + warp * 16, c0, T, D, lane);
}

template <bool OS>
__global__ void __launch_bounds__(WTHREADS)
wide_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v, Strides sx,
                    const bf16* __restrict__ dout, Strides so, const float* __restrict__ lse,
                    const float* __restrict__ delta, const float* __restrict__ mask, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int T, int H, int D, int nct, float scale) {
  // Q's chunk, then dO's (for the products dO's, then Q's), then K's and V's where streamed
  constexpr int STAGE = dkv_stage(OS);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int DP = (D + WCH - 1) / WCH * WCH, LDO = DP + 8;
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);                  // [WR × LDO], where resident
  bf16* sV = sK + WR * LDO;
  bf16* sR = OS ? sK : sV + WR * LDO;                            // [WSTAGES][STAGE]
  float* sL = reinterpret_cast<float*>(sR + WSTAGES * STAGE);  // [2][WQS]
  float* sD = sL + 2 * WQS;                                      // Δ, [2][WQS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * WR, h = blockIdx.y / nct, c0 = (blockIdx.y % nct) * WKV, b = blockIdx.z;
  const size_t row0 = ((size_t)b * H + h) * T;
  const int nq = (T + WQS - 1) / WQS, nkc = DP / WCH, nvc = min(WKV, DP - c0) / WCH, per = nkc + nvc;
  const int steps = nq * per;

  // step s: of query step i = s / per, Q's and dO's chunk c (c < nkc; L
  // and Δ with c = 0; K's and V's chunk c where streamed), or dO's and
  // Q's chunk of the block's columns c0 +
  // 64(c − nkc). Query rows past T arrive as zeros with L = Δ = 0: exact
  // zeros (P = exp(bias) on q = 0, dO = 0)
  auto issue = [&](int s) {
    if (s < steps) {
      const int i = s / per, c = s % per, t0 = i * WQS;
      bf16* dst = sR + (s % WSTAGES) * STAGE;
      const int col = c < nkc ? c * WCH : c0 + (c - nkc) * WCH;
      load_tile_async<WQS, WCH, WTHREADS>(dst, (c < nkc ? q : dout) + col, c < nkc ? sx : so, b, h, t0, T, D - col,
                                          tid);
      load_tile_async<WQS, WCH, WTHREADS>(dst + WQS * WLD, (c < nkc ? dout : q) + col, c < nkc ? so : sx, b, h, t0, T,
                                          D - col, tid);
      if (OS && c < nkc) {
        load_tile_async<WR, WCH, WTHREADS>(dst + 2 * WQS * WLD, k + col, sx, b, h, k0, T, D - col, tid);
        load_tile_async<WR, WCH, WTHREADS>(dst + (2 * WQS + WR) * WLD, v + col, sx, b, h, k0, T, D - col, tid);
      }
      if (c == 0) {
        load_vec_async<WQS, WTHREADS>(sL + (i & 1) * WQS, lse + row0, t0, T, tid);
        load_vec_async<WQS, WTHREADS>(sD + (i & 1) * WQS, delta + row0, t0, T, tid);
      }
    }
    cp_async_commit();
  };
  int step = 0;
  auto arrive = [&]() {  // as attention_wide_mma.cu's
    cp_async_wait<1>();
    __syncthreads();
    issue(step + 2);
    return sR + (step++ % WSTAGES) * STAGE;
  };

  if constexpr (!OS) {
    load_owned(sK, k, sx, b, h, k0, T, D, DP, tid);
    load_owned(sV, v, sx, b, h, k0, T, D, DP, tid);
  }
  issue(0);  // resident K and V land with the first step
  issue(1);

  // the key bias of the lane's rows g and g + 8 (keys past T: −1e9)
  const int kr = k0 + warp * 16 + (lane >> 2), c2 = (lane & 3) << 1;
  const float* mrow = mask + (size_t)b * T;
  const float kb[2] = {kr < T && mrow[kr] > 0.f ? 0.f : MASK_BIAS, kr + 8 < T && mrow[kr + 8] > 0.f ? 0.f : MASK_BIAS};
  const int frow = warp * 16 + (lane & 15), fcol = (lane >> 4) << 3, frag = frow * LDO + fcol;

  float acc_k[WKV / 8][4] = {}, acc_v[WKV / 8][4] = {};
  for (int i = 0; i < nq; ++i) {
    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ over D: rows the warp's keys, columns the
    // step's queries
    float p[WQS / 8][4] = {}, ds[WQS / 8][4] = {};
    for (int c = 0; c < nkc; ++c) {
      const bf16* st = arrive();
      uint32_t f[WCH / 16][4];
      chunk_frags(f, OS ? st + (2 * WQS + frow) * WLD + fcol : sK + frag, OS ? 0 : c * WCH);
      tile_dots_acc<WQS, WCH, WLD>(p, f, st, lane);
      chunk_frags(f, OS ? st + (2 * WQS + WR + frow) * WLD + fcol : sV + frag, OS ? 0 : c * WCH);
      tile_dots_acc<WQS, WCH, WLD>(ds, f, st + WQS * WLD, lane);
    }
    // Pᵀ = exp(Sᵀ·scale + bias − L), dSᵀ = Pᵀ ∘ (dPᵀ − Δ)
    const float* sLi = sL + (i & 1) * WQS;
    const float* sDi = sD + (i & 1) * WQS;
#pragma unroll
    for (int n = 0; n < WQS / 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(sLi + n * 8 + c2);
      const float2 d2 = *reinterpret_cast<const float2*>(sDi + n * 8 + c2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[n][e] = expf(__fsub_rn(__fadd_rn(__fmul_rn(p[n][e], scale), kb[e >> 1]), e & 1 ? l2.y : l2.x));
        ds[n][e] = __fmul_rn(p[n][e], __fsub_rn(ds[n][e], e & 1 ? d2.y : d2.x));
      }
    }
    uint32_t pf[WQS / 16][4], sf[WQS / 16][4];
    p_frags<WQS>(pf, p);
    p_frags<WQS>(sf, ds);
#pragma unroll
    for (int cc = 0; cc < WKV / WCH; ++cc) {  // dV += bf16(Pᵀ)·dO, dK += bf16(dSᵀ)·Q over the block's columns
      if (cc < nvc) {
        const bf16* st = arrive();
        tile_pv<WQS, WCH, WLD>(*reinterpret_cast<float(*)[WCH / 8][4]>(&acc_v[cc * (WCH / 8)]), pf, st, lane);
        tile_pv<WQS, WCH, WLD>(*reinterpret_cast<float(*)[WCH / 8][4]>(&acc_k[cc * (WCH / 8)]), sf, st + WQS * WLD,
                               lane);
      }
    }
  }
  store_tile<WKV>(acc_k, scale, dk, sx, b, h, k0 + warp * 16, c0, T, D, lane);
  store_tile<WKV>(acc_v, 1.f, dv, sx, b, h, k0 + warp * 16, c0, T, D, lane);
}

template <int NC, bool OS>
cudaError_t launch_dq(const bf16* q, const bf16* k, const bf16* v, Strides sx, const bf16* g, Strides so, const float* lse,
                      const float* delta, const float* mask, bf16* dq, int B, int T, int H, int D, float scale,
                      cudaStream_t s) {
  const int nct = (D + NC - 1) / NC;
  const size_t smem = dq_smem((D + WCH - 1) / WCH * WCH, OS);
  auto kernel = wide_bwd_dq_kernel<NC, OS>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((T + WR - 1) / WR, H * nct, B), WTHREADS, smem, s>>>(q, k, v, sx, g, so, lse, delta, mask, dq, T, H, D,
                                                                     nct, scale);
  return cudaGetLastError();
}

template <bool OS>
cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v, Strides sx, const bf16* g, Strides so,
                       const float* lse, const float* delta, const float* mask, bf16* dk, bf16* dv, int B, int T, int H,
                       int D, float scale, cudaStream_t s) {
  const int nct = (D + WKV - 1) / WKV;
  const size_t smem = dkv_smem((D + WCH - 1) / WCH * WCH, OS);
  auto kernel = wide_bwd_dkv_kernel<OS>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((T + WR - 1) / WR, H * nct, B), WTHREADS, smem, s>>>(q, k, v, sx, g, so, lse, delta, mask, dk, dv, T, H,
                                                                     D, nct, scale);
  return cudaGetLastError();
}

// the dQ kernel's column tile where the caller leaves it open (nc = 0):
// one tile of 192 columns for D ≤ 192, unless that grid would fill at most
// half of the 132 SMs, else 128 (the forward's rule, attention_wide_mma.cu)
int dq_nc(int B, int T, int H, int D) {
  const long one_tile = (long)((T + WR - 1) / WR) * H * B;
  return D <= 192 && 2 * one_tile > 132 ? 192 : 128;
}

}  // namespace

int attend_bwd_wide(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                    const void* delta, const void* mask, void* dq, void* dk, void* dv, int B, int T, int H, int D,
                    int sx_b, int sx_h, int sx_t, int so_b, int so_h, int so_t, float scale, void* stream, int nc,
                    int omode) {
  if (nc == 0) nc = dq != nullptr ? dq_nc(B, T, H, D) : WKV;
  const int nct = (D + nc - 1) / nc, DP = (D + WCH - 1) / WCH * WCH;
  const bool os = omode == 0 ? wide_owned_streamed(DP, dq != nullptr) : omode == 2;
  if (B < 1 || H < 1 || T < 1 || D <= 128 || D % 8 || H * nct > 65535 || omode < 0 || omode > 2 ||
      (dq != nullptr ? dq_smem(DP, os) : dkv_smem(DP, os)) > WSMEM_MAX ||
      (dq == nullptr) == (dk == nullptr || dv == nullptr) || (nc != 128 && (nc != 192 || D > 192 || dq == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sx{sx_b, sx_h, sx_t}, so{so_b, so_h, so_t};
  auto qp = static_cast<const bf16*>(q), kp = static_cast<const bf16*>(k), vp = static_cast<const bf16*>(v);
  auto gp = static_cast<const bf16*>(dout);
  auto lp = static_cast<const float*>(lse), dl = static_cast<const float*>(delta), mp = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dq != nullptr) {
    auto o = static_cast<bf16*>(dq);
    const cudaError_t e =
        nc == 192 ? (os ? launch_dq<192, true>(qp, kp, vp, sx, gp, so, lp, dl, mp, o, B, T, H, D, scale, s)
                        : launch_dq<192, false>(qp, kp, vp, sx, gp, so, lp, dl, mp, o, B, T, H, D, scale, s))
                  : (os ? launch_dq<128, true>(qp, kp, vp, sx, gp, so, lp, dl, mp, o, B, T, H, D, scale, s)
                        : launch_dq<128, false>(qp, kp, vp, sx, gp, so, lp, dl, mp, o, B, T, H, D, scale, s));
    return static_cast<int>(e);
  }
  auto k_ = static_cast<bf16*>(dk), v_ = static_cast<bf16*>(dv);
  const cudaError_t e = os ? launch_dkv<true>(qp, kp, vp, sx, gp, so, lp, dl, mp, k_, v_, B, T, H, D, scale, s)
                           : launch_dkv<false>(qp, kp, vp, sx, gp, so, lp, dl, mp, k_, v_, B, T, H, D, scale, s);
  return static_cast<int>(e);
}

// Either kernel on its own, with its column tile and the owned tiles'
// place chosen by the caller (profile_slice.py --attn-wide-tiles reads
// each): q, k, v, dout, dq, dk and dv [B, H, T, D] bf16 (contiguous), lse
// and delta [B, H, T] f32, mask [B, T] f32 (1 = attend); dq, or dk and dv,
// null; nc 128 (dK/dV's only tile), 192 (dQ at D ≤ 192) or 0 (dq_nc's
// rule); omode 0 (the rule), 1 (resident) or 2 (streamed).
extern "C" int msa_attention_bwd_wide(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                      const void* delta, const void* mask, void* dq, void* dk, void* dv, int B, int T,
                                      int H, int D, int nc, int omode, float scale, void* stream) {
  const int sb = H * T * D, sh = T * D;
  return attend_bwd_wide(q, k, v, dout, lse, delta, mask, dq, dk, dv, B, T, H, D, sb, sh, D, sb, sh, D, scale, stream,
                         nc, omode);
}
