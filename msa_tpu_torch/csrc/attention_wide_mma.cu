// The bf16 attention forward above head dim 128 on the tensor cores, for
// every forward row there: rows 1, 2, 5 and 6 (fused_attention,
// mha_attention, packed_qkv_attention_lse, flash_attention_lse) and the
// attention cores of rows 7 and 8 (attention_block[_int8] on bf16 x). The
// kernels of those rows keep DP ≤ 128 columns of q, k, v and o in
// registers; above 128 their entry points call attend_wide_mma. (The f32
// rows above 128 run the SIMT kernel of attention_wide.cu.)
//
// Replaces, at D > 128 in bf16, msa_tpu/ops/pallas/attention.py's
// _fused_attention_lse (pallas_call at :206), _mha_attention_lse (:150),
// _packed_qkv_attention_lse (:489), _flash_attention_lse (:948) and the
// attention of attention_block (:779, :819; body _attn_block_body
// :574-695). JAX pads D to a multiple of 128 there and serves any D.
//
// Rounding points (ORDER), as each TPU kernel rounds: the scores accumulate
// in f32 from bf16 q and k (mma.sync m16n8k16 bf16 → f32: the products are
// exact, only the summation order differs from the plain versions); s =
// S·scale + bias, the product and the sum each rounded on its own, bias
// −1e9 on masked keys and on keys past T (T padded to a multiple of 128, so
// a row with no valid key averages V over all T_pad keys, as on the TPU).
// - kNormBefore (rows 1, 2, 5): pass 1 the exact row max m and the
//   denominator l, online; pass 2 bf16(exp(s − m) / l) into P·V (the
//   quotient correctly rounded, div_rn); o rounded once; lse = m + log(l).
// - kUnnormalised (rows 7 and 8): pass 2 packs the unnormalised bf16(exp(s −
//   m)), o / l after P·V (correctly rounded), rounded once; no lse.
// - kOnline128 (row 6): one pass over row 6's 128-key blocks: m_cur =
//   max(m, rowmax(s)), α = exp(m − m_cur), p = exp(s − m_cur), l = α·l + Σp,
//   the unnormalised p rounded for P·V, acc = acc·α + pv with the block's pv
//   summed on its own (32 columns at a time), each product and sum rounded
//   once; o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
// These are the orders of the D ≤ 128 kernels (attention_packed.cu,
// attention_flash.cu), with the same primitives (attention_mma.cuh).
//
// What bounds it on the card: 4·T²·D operations per (row, head) (the
// function's own; two passes form the scores twice, 6·T²·D), on 3·T·D·2
// bytes in and T·D·2 + 4·T out. At B=2 T=512 H=4 D=192 that is 1.6 GFLOP
// (1.6 µs at 989 TFLOP/s) over 3.2 MB (1.0 µs at 3.35 TB/s): bound by
// operations, so the tensor cores have to be fed.
//
// The design: one block per (64-query tile, NC-column tile of o, head,
// batch row), 4 warps of 16 query rows. K and V come through ONE ring of
// three stages of [128 keys × 64 columns] (18 KB each), filled by cp.async
// two steps ahead: a key tile's scores take D/64 steps (K's chunks; S
// accumulates in registers over them), its P·V NC/64 steps (V's chunks of
// the block's column tile; P is reused from the score registers as the A
// operand, FlashAttention-2's register reuse). One barrier a step. Q's
// [64 × D] tile is held one of two ways (QS):
// - resident: in shared memory for the block's life (rows of DP + 8, DP =
//   D rounded up to 64: 65 KB at D = 512, 99 KB at 768), giving each
//   64-column chunk's A fragments (ldmatrix) as the scores need them;
// - streamed: Q's 64-column chunk rides in the ring beside the K chunk of
//   the same columns ([64 × 64] more a stage, 27 KB), read again from L2
//   for every key tile; shared memory no longer grows with D, so any D.
// wide_q_streamed picks one by D: resident up to D = 512, where it read
// 2–7% faster in the two-pass orders at D = 192 and 256 on an H100
// (profile_slice.py --attn-wide-tiles, PERF.md §6), streamed above, where
// a resident tile leaves one block an SM: at B=2 T=512 H=2 D=640 (160
// blocks) streamed read 1.5× faster in every order.
// The key mask of a tile comes with its first K chunk, into a two-tile
// buffer. o stays in registers (NC/2 floats a thread) and leaves by 4-byte
// stores; the lse by the block of column tile 0.
// The column tile NC (wide_nc): one tile of 192 columns for D ≤ 192, the
// scores formed once a pass, unless that grid fills at most half of the
// 132 SMs; else tiles of 128, which double the grid and form the scores
// once a tile. Read on an H100 (profile_slice.py --attn-wide-tiles; PERF.md
// §6): at B=8 T=512 H=4 D=192 (256 blocks at 192) 192 runs 1.6–1.7× faster
// than 128 in every order, at B=2 T=749 1.1–1.2×; at B=2 T=512 H=4 (64
// blocks at 192) 128 runs 1.1× faster. A 256-column tile (one tile up to D
// = 256) held 128 accumulator floats a thread at 255 registers with
// spills in two of the three orders, and read no faster than 192 at D =
// 192: not built. Shared memory with Q resident: 80 KB a block at D = 192
// (2 blocks an SM), 121 KB at D = 512 (1); streamed: 83 KB at any D (2).
// In row 7's int8 chain (kUnnormalised) the kernel is launched under
// programmatic dependent launch (gemm.cuh): pdl_wait comes before its
// first read of q, k and v, pdl_trigger after its last load; launched
// without the attribute (every other row) both pass at once.
#include "attention_mma.cuh"

namespace {

constexpr int MQ = 64;         // query rows a block: 4 warps of 16
constexpr int MK = 128;        // keys a tile: row 6's key block (T_pad is a multiple)
constexpr int MC = 64;         // columns a ring stage holds, of K or V
constexpr int MLD = MC + 8;    // row of a ring stage: 8 distinct 16-byte bank groups for ldmatrix
constexpr int MSTAGES = 3;     // ring stages; copies run two steps ahead
constexpr int MTHREADS = 128;  // 4 warps
constexpr int SMEM_MAX = 232448;  // the shared memory a block can have on an H100
// Q stays resident up to this D and is streamed above it
constexpr int WIDE_Q_RESIDENT_MAX_D = 512;

// a ring stage: K's or V's chunk [MK × MLD], and Q's chunk [MQ × MLD]
// beside each K chunk where Q is streamed
__host__ __device__ constexpr int wide_stage(bool qs) { return (MK + (qs ? MQ : 0)) * MLD; }

size_t wide_mma_smem(int dp, bool qs) {
  return (qs ? 0 : (size_t)MQ * (dp + 8) * sizeof(bf16))       // sQ, where resident
         + (size_t)MSTAGES * wide_stage(qs) * sizeof(bf16)     // the ring
         + (size_t)2 * MK * sizeof(float);                     // the key mask of two tiles
}

bool wide_q_streamed(int D) { return D > WIDE_Q_RESIDENT_MAX_D; }

// The column tile where the caller leaves it open: one tile of 192 columns
// for D ≤ 192 (the scores formed once a pass), unless that grid would
// fill at most half of the 132 SMs, where 128-column tiles double it.
int wide_nc(int B, int T, int H, int D) {
  const long one_tile = (long)((T + MQ - 1) / MQ) * H * B;
  return D <= 192 && 2 * one_tile > 132 ? 192 : 128;
}

template <int NC, int ORDER, bool QS>
__global__ void __launch_bounds__(MTHREADS)
wide_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v, Strides lin,
                const float* __restrict__ mask, bf16* __restrict__ out, Strides lout, float* __restrict__ lse, int T,
                int H, int D, int nct, float scale) {
  constexpr int NPASS = ORDER == kOnline128 ? 1 : 2;
  constexpr int NVC = NC / MC;  // V chunks of a full column tile
  constexpr int STAGE = wide_stage(QS);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int DP = (D + MC - 1) / MC * MC, LDQ = DP + 8;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);                    // [MQ × LDQ], where resident
  bf16* sR = sQ + (QS ? 0 : MQ * LDQ);                             // [MSTAGES][STAGE]
  float* sMask = reinterpret_cast<float*>(sR + MSTAGES * STAGE);  // [2][MK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * MQ, h = blockIdx.y / nct, c0 = (blockIdx.y % nct) * NC, b = blockIdx.z;
  const float* mrow = mask + (size_t)b * T;
  const int nkt = (T + MK - 1) / MK, nkc = DP / MC, nvc = min(NC, DP - c0) / MC;
  // the steps: (NPASS − 1) passes of nkc K chunks a tile, then one of nkc
  // K chunks and nvc V chunks a tile
  const int per1 = nkc, per2 = nkc + nvc, steps1 = (NPASS - 1) * nkt * per1, steps = steps1 + nkt * per2;

  // step s's copy into stage s % MSTAGES: K's chunk c (columns 64c) of key
  // tile j, with the tile's key mask at c = 0 (and Q's chunk c, where
  // streamed), or V's chunk of the block's columns c0 + 64(c − nkc); an
  // empty group past the last step
  auto issue = [&](int s) {
    if (s < steps) {
      int g, c;  // g: the tile's index over both passes (its mask buffer g & 1)
      if (s < steps1) {
        g = s / per1;
        c = s % per1;
      } else {
        g = nkt * (NPASS - 1) + (s - steps1) / per2;
        c = (s - steps1) % per2;
      }
      const int t0 = (g % nkt) * MK, col = c < nkc ? c * MC : c0 + (c - nkc) * MC;
      bf16* dst = sR + (s % MSTAGES) * STAGE;
      load_tile_async<MK, MC, MTHREADS>(dst, (c < nkc ? k : v) + col, lin, b, h, t0, T, D - col, tid);
      if (QS && c < nkc) load_tile_async<MQ, MC, MTHREADS>(dst + MK * MLD, q + col, lin, b, h, q0, T, D - col, tid);
      if (c == 0) load_vec_async<MK, MTHREADS>(sMask + (g & 1) * MK, mrow, t0, T, tid);
    }
    cp_async_commit();
  };
  int step = 0;
  // → the stage of the next step, landed for every thread; the step after
  // it is in flight, and the one after that is issued into the stage every
  // warp has just finished with
  auto arrive = [&]() {
    cp_async_wait<1>();
    __syncthreads();
    issue(step + 2);
    return sR + (step++ % MSTAGES) * STAGE;
  };

  pdl_wait();  // in row 7's chain q, k and v are the QKV GEMM's output
  if constexpr (!QS) {
    for (int i = tid; i < MQ * (DP / 8); i += MTHREADS) {  // Q, zeros past D and T, lands with step 0
      const int r = i / (DP / 8), c = (i % (DP / 8)) * 8, t = q0 + r;
      const bool ok = t < T && c < D;
      cp_async16(sQ + r * LDQ + c, ok ? q + lin.at(b, h, t) + c : q, ok);
    }
  }
  issue(0);
  issue(1);

  // the lane's ldmatrix row of Q: in sQ, or in a stage's Q chunk
  const int qrow = warp * 16 + (lane & 15), qcol = (lane >> 4) << 3;
  const bf16* sQw = sQ + qrow * LDQ + qcol;
  // s = Q·Kᵀ·scale + bias over key tile g (the scores summed over D in
  // nkc steps, 64 columns each)
  auto scores = [&](float (&s)[MK / 8][4], int g) {
#pragma unroll
    for (int n = 0; n < MK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int c = 0; c < nkc; ++c) {
      const bf16* st = arrive();
      const bf16* qw = QS ? st + (MK + qrow) * MLD + qcol : sQw + c * MC;
      uint32_t qf[MC / 16][4];
#pragma unroll
      for (int kk = 0; kk < MC / 16; ++kk) ldsm_x4(qf[kk], qw + kk * 16);
      tile_dots_acc<MK, MC, MLD>(s, qf, st, lane);
    }
    score_epilogue<MK>(s, sMask + (g & 1) * MK, scale, lane);
  };

  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};  // rows g and g + 8 of the lane
  float o[NC / 8][4] = {};
  int g = 0;
  if constexpr (NPASS == 2) {  // pass 1: the exact row max m and the denominator l, online
    for (int j = 0; j < nkt; ++j, ++g) {
      float s[MK / 8][4], bm[2], sum[2] = {0.f, 0.f};
      scores(s, g);
      tile_row_max<MK>(s, bm);
      const float mn[2] = {fmaxf(m[0], bm[0]), fmaxf(m[1], bm[1])};
#pragma unroll
      for (int n = 0; n < MK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[e >> 1] += expf(s[n][e] - mn[e >> 1]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * expf(m[r] - mn[r]) + quad_sum(sum[r]);
        m[r] = mn[r];
      }
    }
  }
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
  for (int j = 0; j < nkt; ++j, ++g) {  // the last pass: P and P·V
    float s[MK / 8][4], alpha[2] = {1.f, 1.f};
    scores(s, g);
    if constexpr (ORDER == kOnline128) {
      float bm[2], sum[2] = {0.f, 0.f};
      tile_row_max<MK>(s, bm);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_cur = fmaxf(m[r], bm[r]);
        alpha[r] = expf(m[r] - m_cur);
        m[r] = m_cur;
      }
#pragma unroll
      for (int n = 0; n < MK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = expf(s[n][e] - m[e >> 1]);
          sum[e >> 1] += s[n][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = __fadd_rn(__fmul_rn(alpha[r], l[r]), quad_sum(sum[r]));
    } else {
#pragma unroll
      for (int n = 0; n < MK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[n][e] - m[e >> 1]);
          s[n][e] = ORDER == kUnnormalised ? p : div_rn(p, l[e >> 1], rl[e >> 1]);
        }
      }
    }
    uint32_t pf[MK / 16][4];
    p_frags<MK>(pf, s);
#pragma unroll
    for (int cc = 0; cc < NVC; ++cc) {
      if (cc < nvc) {
        const bf16* st = arrive();
        float(&oc)[MC / 8][4] = *reinterpret_cast<float(*)[MC / 8][4]>(&o[cc * (MC / 8)]);
        if constexpr (ORDER == kOnline128) {  // acc = acc·α + pv, the block's pv on its own, 32 columns at a time
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float pv[MC / 16][4] = {};
            tile_pv<MK, MC / 2, MLD>(pv, pf, st + half * (MC / 2), lane);
#pragma unroll
            for (int n = 0; n < MC / 16; ++n) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                float& a = oc[half * (MC / 16) + n][e];
                a = __fadd_rn(__fmul_rn(a, alpha[e >> 1]), pv[n][e]);
              }
            }
          }
        } else {
          tile_pv<MK, MC, MLD>(oc, pf, st, lane);
        }
      }
    }
  }
  pdl_trigger();  // every load is in

  float row_lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // o / the denominator, correctly rounded by div_rn (no division subroutine)
    const float den = ORDER == kOnline128 ? fmaxf(l[r], 1e-30f) : l[r], rd = __frcp_rn(den);
    row_lse[r] = m[r] + logf(den);
    if (ORDER != kNormBefore) {
#pragma unroll
      for (int n = 0; n < NC / 8; ++n) {
        o[n][2 * r] = div_rn(o[n][2 * r], den, rd);
        o[n][2 * r + 1] = div_rn(o[n][2 * r + 1], den, rd);
      }
    }
  }
  // o rounded once to bf16 at rows < T and columns < D; the lse from the
  // block of column tile 0
  const int gr = lane >> 2, t = q0 + warp * 16 + gr, cq = (lane & 3) << 1;
#pragma unroll
  for (int n = 0; n < NC / 8; ++n) {
    const int col = c0 + n * 8;
    if (col < D) {
      if (t < T) *reinterpret_cast<uint32_t*>(out + lout.at(b, h, t) + col + cq) = pack_bf16(o[n][0], o[n][1]);
      if (t + 8 < T) *reinterpret_cast<uint32_t*>(out + lout.at(b, h, t + 8) + col + cq) = pack_bf16(o[n][2], o[n][3]);
    }
  }
  if (lse != nullptr && c0 == 0 && (lane & 3) == 0) {
    float* row = lse + ((size_t)b * H + h) * T;
    if (t < T) row[t] = row_lse[0];
    if (t + 8 < T) row[t + 8] = row_lse[1];
  }
}

template <int NC, int ORDER, bool QS>
cudaError_t launch_wide_mma(const bf16* q, const bf16* k, const bf16* v, Strides lin, const float* mask, bf16* out,
                            Strides lout, float* lse, int B, int T, int H, int D, float scale, cudaStream_t s, bool pdl) {
  const int nct = (D + NC - 1) / NC;
  const size_t smem = wide_mma_smem((D + MC - 1) / MC * MC, QS);
  auto kernel = wide_mma_kernel<NC, ORDER, QS>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return launch_k(pdl, kernel, dim3((T + MQ - 1) / MQ, H * nct, B), dim3(MTHREADS), smem, s, q, k, v, lin, mask, out,
                  lout, lse, T, H, D, nct, scale);
}

template <int NC, bool QS>
cudaError_t launch_order(int order, const bf16* q, const bf16* k, const bf16* v, Strides lin, const float* mask,
                         bf16* out, Strides lout, float* lse, int B, int T, int H, int D, float scale, cudaStream_t s,
                         bool pdl) {
  return order == kNormBefore      ? launch_wide_mma<NC, kNormBefore, QS>(q, k, v, lin, mask, out, lout, lse, B, T, H, D, scale, s, pdl)
         : order == kUnnormalised ? launch_wide_mma<NC, kUnnormalised, QS>(q, k, v, lin, mask, out, lout, lse, B, T, H, D, scale, s, pdl)
                                  : launch_wide_mma<NC, kOnline128, QS>(q, k, v, lin, mask, out, lout, lse, B, T, H, D, scale, s, pdl);
}

}  // namespace

// qmode: 0 wide_q_streamed's rule, 1 Q resident (where it fits), 2 streamed
int attend_wide_mma(const void* q, const void* k, const void* v, int sb, int sh, int st, const void* mask, void* out,
                    int ob, int oh, int ot, void* lse, int B, int T, int H, int D, float scale, int order, int nc,
                    void* stream, int qmode, bool pdl) {
  if (nc == 0) nc = wide_nc(B, T, H, D);
  const bool qs = qmode == 0 ? wide_q_streamed(D) : qmode == 2;
  if (B < 1 || H < 1 || T < 1 || D <= 128 || D % 8 || (nc != 128 && nc != 192) || qmode < 0 || qmode > 2 ||
      wide_mma_smem((D + MC - 1) / MC * MC, qs) > SMEM_MAX || H * ((D + nc - 1) / nc) > 65535 ||
      order < kNormBefore || order > kOnline128)
    return static_cast<int>(cudaErrorInvalidValue);
  auto qp = static_cast<const bf16*>(q), kp = static_cast<const bf16*>(k), vp = static_cast<const bf16*>(v);
  auto m = static_cast<const float*>(mask);
  auto o = static_cast<bf16*>(out);
  auto l = static_cast<float*>(lse);
  const Strides lin{sb, sh, st}, lout{ob, oh, ot};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      nc == 128 ? (qs ? launch_order<128, true>(order, qp, kp, vp, lin, m, o, lout, l, B, T, H, D, scale, s, pdl)
                      : launch_order<128, false>(order, qp, kp, vp, lin, m, o, lout, l, B, T, H, D, scale, s, pdl))
                : (qs ? launch_order<192, true>(order, qp, kp, vp, lin, m, o, lout, l, B, T, H, D, scale, s, pdl)
                      : launch_order<192, false>(order, qp, kp, vp, lin, m, o, lout, l, B, T, H, D, scale, s, pdl));
  return static_cast<int>(e);
}

// The kernel on its own, with its column tile and Q's place chosen by the
// caller (profile_slice.py --attn-wide-tiles reads each): q, k, v and o
// [B, H, T, D] bf16 (contiguous), mask [B, T] f32 (1 = attend), lse
// [B, H, T] f32 or null; order kNormBefore (0), kUnnormalised (1) or
// kOnline128 (2); nc 128 or 192 (0: wide_nc's rule); qmode 0 (the rule),
// 1 (Q resident) or 2 (streamed).
extern "C" int msa_attention_wide_mma(const void* q, const void* k, const void* v, const void* mask, void* out,
                                      void* lse, int B, int T, int H, int D, int order, int nc, int qmode, float scale,
                                      void* stream) {
  const int sb = H * T * D, sh = T * D;
  return attend_wide_mma(q, k, v, sb, sh, D, mask, out, sb, sh, D, lse, B, T, H, D, scale, order, nc, stream, qmode);
}
