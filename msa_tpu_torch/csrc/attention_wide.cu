// The attention forward at head dims above 128, for every forward row: rows
// 1, 2, 5 and 6 (fused_attention, mha_attention, packed_qkv_attention_lse,
// flash_attention_lse) and the attention cores of rows 7 and 8
// (attention_block[_int8], and row 8 in f32), in bf16 and in f32. The
// kernels of those rows keep DP ≤ 128 columns of q, k, v and o in registers
// or shared memory; above 128 their entry points call attend_wide.
//
// Replaces, at D > 128, msa_tpu/ops/pallas/attention.py's
// _fused_attention_lse (pallas_call at :206), _mha_attention_lse (:150),
// _packed_qkv_attention_lse (:489), _flash_attention_lse (:948) and the
// attention of attention_block (:779, :819; body _attn_block_body
// :574-695). JAX pads D to 64 or 128 there and serves any D.
//
// The D tile: one block per (64-query tile, 128-column tile of the output,
// head, batch row). Each block computes the scores over the full D, with Q
// and K stepped through shared memory 32 columns at a time, and then runs
// P·V into its own 128 output columns, V stepped through shared memory 32
// keys at a time. Only the column-tile-0 block writes the lse. Columns past
// D are zero-filled by the copies, so D is any multiple of 8.
//
// Operands are bf16 or f32 (E); everything is computed in f32 on the CUDA
// cores with exact FMA: a product of two bf16 values is exact in f32, so
// the bf16 rows differ from their tensor-core kernels (and the plain
// versions) only in f32 summation order. E is rounded to at the points
// where each TPU kernel rounds (ORDER):
// - kNormBefore (rows 1, 2, 5): two passes over the keys; pass 1 the exact
//   row max m and the denominator l, online; pass 2 p/l rounded to v's
//   dtype before P·V; o rounded once; lse = m + log(l).
// - kUnnormalised (rows 7 and 8): pass 1 the exact row max; pass 2 the
//   unnormalised p = exp(s − m) rounded to bf16 for P·V, the denominator
//   Σp summed from the same f32 p, and o/denom rounded once after P·V.
// - kOnline128 (row 6, and every f32 row): one pass over row 6's 128-key
//   blocks: m_cur = max(m, rowmax(s)), α = exp(m − m_cur), p = exp(s −
//   m_cur), l = α·l + Σp, the unnormalised p rounded for P·V, o = o·α +
//   P·V (the plain version sums the block's P·V on its own first: an f32
//   rounding apart); o / max(l, 1e-30) and lse = m + log(max(l, 1e-30)).
//   In f32 every rounding is the identity, so every f32 row takes this one
//   pass (4·T²·D operations where two passes take 6).
// s = S·scale + bias, the product and the sum each rounded on its own,
// bias −1e9 on masked keys and on keys past T: T is padded to a multiple of
// 128, so a row with no valid key averages V over all T_pad keys, as on
// the TPU.
//
// What bounds it on the card: 4·T²·D operations per (row, head) (6 in two
// passes), which at these head dims no path of the system runs (the
// encoders' D is 64, the configs' widest 128). Speed is not this kernel's
// aim: it is the simple D-tiled design, one block per output tile, copies
// waited for before each step, 80 KB of shared memory a block.
#include "attention_mma.cuh"

namespace {

constexpr int WQ = 64;         // query rows per block
constexpr int WK = 128;        // keys per step: row 6's key block
constexpr int WC = 128;        // output columns per block: the D tile
constexpr int WDC = 32;        // D columns of Q and K per score step
constexpr int WVK = 32;        // keys of V per P·V step
constexpr int WTHREADS = 128;  // 4 warps of 16 query rows
constexpr int WLC = WDC + 4;   // row of sQ, sK: ≡ 4 (mod 32) words, conflict-free float4 reads
constexpr int WLV = WC + 4;    // row of sV
constexpr int WPL = WK + 8;    // row of sP: ≡ 8 (mod 32) words

constexpr size_t wide_smem_bytes() {
  return ((size_t)WQ * WLC + (size_t)WK * WLC + (size_t)WVK * WLV + (size_t)WQ * WPL + WK) * sizeof(float);
}

// In a warp, lane = 8·rg + kg: the thread holds query rows 16w + rg + 4i
// (i < 4) × keys kg + 8j (j < 16) of the 64 × 128 score tile, and the same
// rows × output columns 4kg + 32u + (0..3) (u < 4) of the block's D tile; a
// row's max and sum are reduced over its 8 lanes (xor 1, 2, 4).
template <typename E, int ORDER>
__global__ void __launch_bounds__(WTHREADS)
wide_attention_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v, Strides lin,
                      const float* __restrict__ mask, E* __restrict__ out, Strides lout, float* __restrict__ lse,
                      int H, int nct, int T, int T_pad, int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [WQ × WLC]
  float* sK = sQ + WQ * WLC;                       // [WK × WLC]
  float* sV = sK + WK * WLC;                       // [WVK × WLV]
  float* sP = sV + WVK * WLV;                      // [WQ × WPL]
  float* sMask = sP + WQ * WPL;                    // [WK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, rg = lane >> 3, kg = lane & 7;
  const int q0 = blockIdx.x * WQ, h = blockIdx.y / nct, c0 = (blockIdx.y % nct) * WC, b = blockIdx.z;
  const float* mrow = mask + (size_t)b * T;
  const int ndc = (D + WDC - 1) / WDC, nkb = T_pad / WK;
  const float* sQt = sQ + (warp * 16 + rg) * WLC;  // the thread's row i: + 4i·WLC
  float* sPt = sP + (warp * 16 + rg) * WPL;

  // s = (q·k)·scale + bias over the keys [k0, k0 + WK), the dot an f32 FMA
  // chain over d in order
  auto scores = [&](int k0, float (&s)[4][16]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 16; ++j) s[i][j] = 0.f;
    }
    for (int dc = 0; dc < ndc; ++dc) {
      __syncthreads();  // every warp is done with the last chunk (and the last block's mask)
      load_rows_f32<E, WQ, WDC, WTHREADS>(sQ, WLC, q, lin, b, h, q0, T, dc * WDC, D, tid);
      load_rows_f32<E, WK, WDC, WTHREADS>(sK, WLC, k, lin, b, h, k0, T, dc * WDC, D, tid);
      if (dc == 0) load_vec_async<WK, WTHREADS>(sMask, mrow, k0, T, tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll 2
      for (int d = 0; d < WDC; d += 4) {
        float4 qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(sQt + 4 * i * WLC + d);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(sK + (kg + 8 * j) * WLC + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float bias = sMask[kg + 8 * j] > 0.f ? 0.f : MASK_BIAS;
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][j] = __fadd_rn(__fmul_rn(s[i][j], scale), bias);
    }
  };

  float o[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 16; ++c) o[i][c] = 0.f;
  }
  // o += P·V over the keys [k0, k0 + WK), P (rounded to E) in the warp's
  // rows of sP; V's D tile stepped through shared memory WVK keys at a time
  auto pv = [&](int k0) {
    for (int kv0 = 0; kv0 < WK; kv0 += WVK) {
      __syncthreads();  // every warp is done with the last V step; sP is whole
      load_rows_f32<E, WVK, WC, WTHREADS>(sV, WLV, v, lin, b, h, k0 + kv0, T, c0, D, tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll 2
      for (int j0 = 0; j0 < WVK; j0 += 4) {
        float4 pq[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pq[i] = *reinterpret_cast<const float4*>(sPt + 4 * i * WPL + kv0 + j0);
#pragma unroll
        for (int jq = 0; jq < 4; ++jq) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 vv = *reinterpret_cast<const float4*>(sV + (j0 + jq) * WLV + 4 * kg + 32 * u);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = jq == 0 ? pq[i].x : jq == 1 ? pq[i].y : jq == 2 ? pq[i].z : pq[i].w;
              o[i][4 * u + 0] = fmaf(p, vv.x, o[i][4 * u + 0]);
              o[i][4 * u + 1] = fmaf(p, vv.y, o[i][4 * u + 1]);
              o[i][4 * u + 2] = fmaf(p, vv.z, o[i][4 * u + 2]);
              o[i][4 * u + 3] = fmaf(p, vv.w, o[i][4 * u + 3]);
            }
          }
        }
      }
    }
  };
  auto row_max = [&](const float (&s)[16]) {
    float mx = -1e30f;
#pragma unroll
    for (int j = 0; j < 16; ++j) mx = fmaxf(mx, s[j]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    return fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
  };
  auto row_sum = [&](float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    return x + __shfl_xor_sync(0xffffffffu, x, 4);
  };

  float m[4], l[4], mul[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
  }
  float s[4][16];
  if (ORDER == kOnline128) {
    for (int kb = 0; kb < nkb; ++kb) {
      scores(kb * WK, s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float m_cur = fmaxf(m[i], row_max(s[i])), alpha = expf(m[i] - m_cur);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float p = expf(s[i][j] - m_cur);
          sum += p;
          sPt[4 * i * WPL + kg + 8 * j] = round_to<E>(p);
        }
        l[i] = __fadd_rn(__fmul_rn(alpha, l[i]), row_sum(sum));
        m[i] = m_cur;
#pragma unroll
        for (int c = 0; c < 16; ++c) o[i][c] = __fmul_rn(o[i][c], alpha);
      }
      pv(kb * WK);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l[i] = fmaxf(l[i], 1e-30f);
      mul[i] = l[i];
    }
  } else {
    // pass 1: the exact row max m and the denominator l, online
    for (int kb = 0; kb < nkb; ++kb) {
      scores(kb * WK, s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float m_new = fmaxf(m[i], row_max(s[i]));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) sum += expf(s[i][j] - m_new);
        l[i] = l[i] * expf(m[i] - m_new) + row_sum(sum);
        m[i] = m_new;
      }
    }
    // pass 2: P·V with p/l (kNormBefore) or the unnormalised p, summed
    // again for the denominator (kUnnormalised), rounded to E
    float den[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kb = 0; kb < nkb; ++kb) {
      scores(kb * WK, s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          float p = expf(s[i][j] - m[i]);
          if (ORDER == kNormBefore) {
            p = __fdiv_rn(p, l[i]);
          } else {
            den[i] += p;
          }
          sPt[4 * i * WPL + kg + 8 * j] = round_to<E>(p);
        }
      }
      pv(kb * WK);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) mul[i] = ORDER == kNormBefore ? 1.f : row_sum(den[i]);
  }

  // o (/ the denominator) rounded once at rows < T and columns < D; the lse
  // from the column-tile-0 block
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + warp * 16 + rg + 4 * i;
    if (t >= T) continue;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + 4 * kg + 32 * u;
      if (c < D) {
        const float* oc = o[i] + 4 * u;
        if (ORDER == kNormBefore)
          store4<E>(out + lout.at(b, h, t) + c, oc[0], oc[1], oc[2], oc[3]);
        else
          store4<E>(out + lout.at(b, h, t) + c, oc[0] / mul[i], oc[1] / mul[i], oc[2] / mul[i], oc[3] / mul[i]);
      }
    }
    if (lse != nullptr && c0 == 0 && kg == 0) lse[((size_t)b * H + h) * T + t] = m[i] + logf(l[i]);
  }
}

template <typename E, int ORDER>
cudaError_t launch_wide(const void* q, const void* k, const void* v, Strides lin, const float* mask, void* out,
                        Strides lout, float* lse, int B, int T, int H, int D, float scale, cudaStream_t s) {
  const int T_pad = (T + WK - 1) / WK * WK, nct = (D + WC - 1) / WC;
  constexpr size_t smem = wide_smem_bytes();
  auto kernel = wide_attention_kernel<E, ORDER>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((T + WQ - 1) / WQ, H * nct, B), WTHREADS, smem, s>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v), lin, mask, static_cast<E*>(out),
      lout, lse, H, nct, T, T_pad, D, scale);
  return cudaGetLastError();
}

}  // namespace

int attend_wide(const void* q, const void* k, const void* v, int sb, int sh, int st, const void* mask, void* out,
                int ob, int oh, int ot, void* lse, int B, int T, int H, int D, float scale, int is_bf16, int order,
                void* stream) {
  if (T < 1 || D < 8 || D % 8 || H * ((D + WC - 1) / WC) > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Strides lin{sb, sh, st}, lout{ob, oh, ot};
  const float* m = static_cast<const float*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (!is_bf16) {  // every rounding is the identity: the one-pass order
    e = launch_wide<float, kOnline128>(q, k, v, lin, m, out, lout, l, B, T, H, D, scale, s);
  } else if (order == kNormBefore) {
    e = launch_wide<bf16, kNormBefore>(q, k, v, lin, m, out, lout, l, B, T, H, D, scale, s);
  } else if (order == kUnnormalised) {
    e = launch_wide<bf16, kUnnormalised>(q, k, v, lin, m, out, lout, l, B, T, H, D, scale, s);
  } else {
    e = launch_wide<bf16, kOnline128>(q, k, v, lin, m, out, lout, l, B, T, H, D, scale, s);
  }
  return static_cast<int>(e);
}
