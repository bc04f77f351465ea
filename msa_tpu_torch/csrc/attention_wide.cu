// The f32 attention forward at head dims above 128, for every f32 forward
// row: rows 1, 2, 5 and 6 (fused_attention, mha_attention,
// packed_qkv_attention_lse, flash_attention_lse on f32) and the f32
// attention cores of rows 7 and 8 (attention_block_int8 on f32 x, and row
// 8 in f32). The f32 core of those rows (attention_fused.cu) keeps DP ≤ 128
// columns of q, k, v and o in shared memory; above 128 it calls
// attend_wide. (The bf16 rows above 128 run the tensor-core kernel of
// attention_wide_mma.cu.)
//
// Replaces, at D > 128 on f32, msa_tpu/ops/pallas/attention.py's
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
// Everything is computed in f32 on the CUDA cores with exact FMA (no TF32),
// in row 6's one pass over 128-key blocks: m_cur = max(m, rowmax(s)), α =
// exp(m − m_cur), p = exp(s − m_cur), l = α·l + Σp, o = o·α + P·V (the plain
// version sums the block's P·V on its own first: an f32 rounding apart); o
// / max(l, 1e-30) and lse = m + log(max(l, 1e-30)). Every rounding to f32
// is the identity, so this one order serves every f32 row (4·T²·D
// operations where two passes take 6). s = S·scale + bias, the product and
// the sum each rounded on its own, bias −1e9 on masked keys and on keys
// past T: T is padded to a multiple of 128, so a row with no valid key
// averages V over all T_pad keys, as on the TPU.
//
// What bounds it on the card: 4·T²·D operations per (row, head) at the
// CUDA cores' 67 TFLOP/s, which at these head dims no path of the system
// runs (the encoders' D is 64, the configs' widest 128). Speed is not this
// kernel's aim: it is the simple D-tiled design, one block per output tile,
// copies waited for before each step, 80 KB of shared memory a block.
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
__global__ void __launch_bounds__(WTHREADS)
wide_attention_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, Strides lin,
                      const float* __restrict__ mask, float* __restrict__ out, Strides lout, float* __restrict__ lse,
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
      load_rows_f32<WQ, WDC, WTHREADS>(sQ, WLC, q, lin, b, h, q0, T, dc * WDC, D, tid);
      load_rows_f32<WK, WDC, WTHREADS>(sK, WLC, k, lin, b, h, k0, T, dc * WDC, D, tid);
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
  // o += P·V over the keys [k0, k0 + WK), P in the warp's rows of sP; V's D
  // tile stepped through shared memory WVK keys at a time
  auto pv = [&](int k0) {
    for (int kv0 = 0; kv0 < WK; kv0 += WVK) {
      __syncthreads();  // every warp is done with the last V step; sP is whole
      load_rows_f32<WVK, WC, WTHREADS>(sV, WLV, v, lin, b, h, k0 + kv0, T, c0, D, tid);
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

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
  }
  float s[4][16];
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
        sPt[4 * i * WPL + kg + 8 * j] = p;
      }
      l[i] = __fadd_rn(__fmul_rn(alpha, l[i]), row_sum(sum));
      m[i] = m_cur;
#pragma unroll
      for (int c = 0; c < 16; ++c) o[i][c] = __fmul_rn(o[i][c], alpha);
    }
    pv(kb * WK);
  }

  // o / max(l, 1e-30) at rows < T and columns < D; the lse from the
  // column-tile-0 block
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + warp * 16 + rg + 4 * i;
    if (t >= T) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + 4 * kg + 32 * u;
      if (c < D) {
        const float* oc = o[i] + 4 * u;
        *reinterpret_cast<float4*>(out + lout.at(b, h, t) + c) = make_float4(oc[0] / lc, oc[1] / lc, oc[2] / lc, oc[3] / lc);
      }
    }
    if (lse != nullptr && c0 == 0 && kg == 0) lse[((size_t)b * H + h) * T + t] = m[i] + logf(lc);
  }
}

}  // namespace

int attend_wide(const void* q, const void* k, const void* v, int sb, int sh, int st, const void* mask, void* out,
                int ob, int oh, int ot, void* lse, int B, int T, int H, int D, float scale, void* stream) {
  const int nct = (D + WC - 1) / WC;
  if (T < 1 || D < 8 || D % 8 || H * nct > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = wide_smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(wide_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  wide_attention_kernel<<<dim3((T + WQ - 1) / WQ, H * nct, B), WTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), Strides{sb, sh, st},
      static_cast<const float*>(mask), static_cast<float*>(out), Strides{ob, oh, ot}, static_cast<float*>(lse), H, nct,
      T, (T + WK - 1) / WK * WK, D, scale);
  return static_cast<int>(cudaGetLastError());
}
