// fused_attention for Hopper: single-pass softmax attention on q, k, v
// [B, H, T, D] at any T, in bf16 or f32, → o [B, H, T, D] in q's dtype and
// the row logsumexp lse [B, H, T] f32.
//
// Replaces msa_tpu/ops/pallas/attention.py:_fused_attention_lse
// (pallas_call at :206, kernel _attention_kernel :59-83), the function
// behind the public fused_attention. Unlike rows 2 and 5 it has no T limit
// and takes f32 as well as bf16.
//
// The TPU kernel's rounding points: s = (q·k)·scale + bias with the dot
// accumulated in f32 and bias −1e9 on masked keys; the exact row max m and
// denom = Σ exp(s − m) over every key of the padded row; P normalised
// BEFORE P·V, (p / denom) rounded to v's dtype; o accumulated in f32 and
// rounded once; lse = m + log(denom). T is padded to a multiple of 128 with
// zero keys under the −1e9 bias, so a row with no valid key averages V over
// all T_pad keys, as on the TPU. D is a multiple of 8 (the wrapper
// zero-pads other D, as JAX pads D; zeros add nothing), and DP (32, 64 or
// 128) in shared memory; above 128 bf16 calls the tensor-core kernel of
// attention_wide_mma.cu and f32 the wide kernel of attention_wide.cu.
//
// bf16: that is rows 5 and 2's function, so it runs their two-pass
// register-resident core (attention_packed.cu, attention_mma.cuh) through
// attend_heads_first, at any T.
//
// f32 (fused_f32_kernel, through attend_f32): q, k and v are read, and o
// written, through element strides (batch, head, time; D contiguous), so
// the same core serves row 1 on [B, H, T, D], rows 5 and 6 in f32 on the
// packed projection qkv [B, T, 3, H, D] → [B, T, H·D]
// (msa_packed_attention_f32), and row 8's f32 attention block
// (attention.cu) on its [B·T, 3·H·DP] projection buffer. Exact f32 FMA on
// the CUDA cores, no TF32 (JAX's
// f32 kernel is exact f32 on the CPU), in ONE pass with FlashAttention-2's
// online rescale: per 64-key chunk m_new = max(m, rowmax(s)), α = exp(m −
// m_new), p = exp(s − m_new), l = α·l + Σp, o = α·o + P·V, and o / l at the
// end. In f32, rounding p / denom to v's dtype is the identity, so
// normalising after P·V instead of before moves no rounding point: it only
// changes f32 rounding (about 1e-7 relative), and cuts the work from the
// two-pass 6·T²·D operations to 4·T²·D. lse = m + log(l).
//
// What bounds it on the card: per (row, head) 4·T_pad·T·D operations on
// 3·T·D·s bytes read and T·D·s + 4·T written (s the element size). At
// B=2, H=12, T=512, D=64 in f32 that is 1.6 GFLOP (24 µs at the CUDA cores'
// 67 TFLOP/s) over 12.6 MB (3.8 µs at 3.35 TB/s): bound by the FMA rate.
//
// The f32 design: one block per (64-query tile, head, batch row), 4 warps
// of 16 query rows. In a warp, lane = 8·rg + kg: the thread holds 4 query
// rows (16w + rg + 4i, i < 4) × 8 keys (kg + 8j, j < 8) of the score tile
// and the same 4 rows × DP/8 output columns (4kg + 32u + 0..3), so each
// operand it reads from shared memory feeds 4 or 8 FMAs. Q, K and V keep
// their [row][d] layout, in rows of LD = DP + 4 floats (LD ≡ 4 mod 32
// words): a thread reads 4 consecutive d (or keys, or columns) of one row
// as a float4, and the 4 or 8 distinct rows a warp reads at once fall in
// distinct 16-byte bank groups, so 12 float4 loads feed 128 FMAs with no
// bank conflict. A row's max and sum are reduced across its 8 lanes by
// shuffles (xor 1, 2, 4). P goes through the warp's own 16 rows of shared
// memory (rows of FK + 8 floats), read back as 4 keys of a row per float4.
// K and V have one shared-memory buffer each, filled by cp.async as in
// FlashAttention-2 (and row 6): chunk i's V copy flies while its scores and
// softmax step run, chunk i+1's K copy (with its key mask) while its P·V
// runs. 69 KB of shared memory a block at DP = 64 and 168 registers a
// thread, so 3 blocks share an SM: at B=2 H=12 T=749 the 288 blocks fit in
// one round of the 132 SMs. In the int8 chain of row 7 on f32 x it is
// launched under programmatic dependent launch (gemm.cuh): pdl_wait comes
// before its first read of q, k and v, pdl_trigger after its last load;
// launched without the attribute (rows 1, 2, 5, 6 and 8 in f32) both pass
// at once.
#include "attention_mma.cuh"

namespace {

constexpr int FQ = 64;         // query rows per block
constexpr int FK = 64;         // keys per ring stage
constexpr int FTHREADS = 128;  // 4 warps of 16 query rows
constexpr int PLD = FK + 8;    // row of sP: ≡ 8 (mod 32) words, so the 32 lanes' scalar stores differ in bank

template <int DP>
constexpr size_t f32_smem_bytes() {
  return ((size_t)(FQ + 2 * FK) * (DP + 4)  // sQ, sK, sV
          + (size_t)FQ * PLD                // sP
          + (size_t)FK)                     // the key mask of the chunk
         * sizeof(float);
}

// rows [t0, t0 + ROWS) of head h of batch row b of src (element strides
// st, D contiguous) f32 into smem [ROWS × (DP + 4)] by cp.async, 4 floats a
// copy: zeros past D and past T
template <int ROWS, int DP>
__device__ __forceinline__ void load_f32_tile_async(float* dst, const float* __restrict__ src, Strides st, int b, int h,
                                                    int t0, int T, int D, int tid) {
  constexpr int LD = DP + 4, VECS = DP / 4;
  static_assert(ROWS * VECS % FTHREADS == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < ROWS * VECS / FTHREADS; ++it) {
    const int i = tid + it * FTHREADS, r = i / VECS, c = (i % VECS) * 4, t = t0 + r;
    const bool ok = t < T && c < D;
    cp_async16(dst + r * LD + c, ok ? src + st.at(b, h, t) + c : src, ok);
  }
}

// at DP ≤ 64 registers are capped for 3 blocks an SM; at DP = 128 the
// tiles' 120 KB allow one, and the registers are left free
template <int DP>
__global__ void __launch_bounds__(FTHREADS, DP > 64 ? 1 : 3)
fused_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, Strides lin,
                 const float* __restrict__ mask, float* __restrict__ out, Strides lout, float* __restrict__ lse, int H,
                 int T, int T_pad, int D, float scale) {
  constexpr int LD = DP + 4;
  constexpr int NU = DP / 32;  // float4 column groups a thread owns: 4kg + 32u
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + FQ * LD;      // [FK × LD]
  float* sV = sK + FK * LD;      // [FK × LD]
  float* sP = sV + FK * LD;      // [FQ × PLD]
  float* sMask = sP + FQ * PLD;  // [FK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, rg = lane >> 3, kg = lane & 7;
  const int q0 = blockIdx.x * FQ, h = blockIdx.y, b = blockIdx.z;
  const float* mrow = mask + (size_t)b * T;
  const int nt = T_pad / FK;

  pdl_wait();  // in row 7's chain on f32 x, q, k and v are the QKV GEMM's output
  load_f32_tile_async<FQ, DP>(sQ, q, lin, b, h, q0, T, D, tid);
  load_f32_tile_async<FK, DP>(sK, k, lin, b, h, 0, T, D, tid);
  load_vec_async<FK, FTHREADS>(sMask, mrow, 0, T, tid);
  cp_async_commit();

  const float* sQt = sQ + (warp * 16 + rg) * LD;  // the thread's row i is sQt + 4i·LD
  float* sPt = sP + (warp * 16 + rg) * PLD;
  float m[4], l[4], o[4][4 * NU];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NU; ++c) o[i][c] = 0.f;
  }

  const float* sKs = sK + kg * LD;  // key j of the thread: + 8j·LD
  const float* sVs = sV + 4 * kg;   // column group u: + 32u
  for (int step = 0; step < nt; ++step) {
    cp_async_wait<0>();
    __syncthreads();  // K and the mask of this chunk have landed; every warp is done with the last V
    load_f32_tile_async<FK, DP>(sV, v, lin, b, h, step * FK, T, D, tid);
    cp_async_commit();

    // s = (q·k)·scale + bias, the dot an f32 FMA chain over d in order
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(sQt + 4 * i * LD + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(sKs + 8 * j * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }
    float bias[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) bias[j] = sMask[kg + 8 * j] > 0.f ? 0.f : MASK_BIAS;

    // the online step: m_new, α, p, l = α·l + Σp, o = α·o; P to the warp's rows of sP
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -1e30f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = __fadd_rn(__fmul_rn(s[i][j], scale), bias[j]);
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx), alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sPt[4 * i * PLD + kg + 8 * j] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NU; ++c) o[i][c] *= alpha;
    }
    cp_async_wait<0>();
    __syncthreads();  // V has landed (and the warp's 16 rows of P are whole); every warp is done with K
    if (step + 1 < nt) {
      load_f32_tile_async<FK, DP>(sK, k, lin, b, h, (step + 1) * FK, T, D, tid);
      load_vec_async<FK, FTHREADS>(sMask, mrow, (step + 1) * FK, T, tid);
      cp_async_commit();
    }

    // o += P·V, an FMA chain over the chunk's keys in order
#pragma unroll 4
    for (int j0 = 0; j0 < FK; j0 += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(sPt + 4 * i * PLD + j0);
#pragma unroll
      for (int jq = 0; jq < 4; ++jq) {
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const float4 vv = *reinterpret_cast<const float4*>(sVs + (j0 + jq) * LD + 32 * u);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = jq == 0 ? pv[i].x : jq == 1 ? pv[i].y : jq == 2 ? pv[i].z : pv[i].w;
            o[i][4 * u + 0] = fmaf(p, vv.x, o[i][4 * u + 0]);
            o[i][4 * u + 1] = fmaf(p, vv.y, o[i][4 * u + 1]);
            o[i][4 * u + 2] = fmaf(p, vv.z, o[i][4 * u + 2]);
            o[i][4 * u + 3] = fmaf(p, vv.w, o[i][4 * u + 3]);
          }
        }
      }
    }
  }
  pdl_trigger();  // every load is in

  // o / l at rows < T and columns < D (16-byte stores); lse per row
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + warp * 16 + rg + 4 * i;
    if (t >= T) continue;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int c = 4 * kg + 32 * u;
      if (c < D)
        *reinterpret_cast<float4*>(out + lout.at(b, h, t) + c) =
            make_float4(o[i][4 * u] / l[i], o[i][4 * u + 1] / l[i], o[i][4 * u + 2] / l[i], o[i][4 * u + 3] / l[i]);
    }
    if (kg == 0) lse[((size_t)b * H + h) * T + t] = m[i] + logf(l[i]);
  }
}

template <int DP>
cudaError_t launch_f32(const float* q, const float* k, const float* v, Strides lin, const float* mask, float* out,
                       Strides lout, float* lse, int B, int H, int T, int D, float scale, cudaStream_t s, bool pdl) {
  const int T_pad = (T + 127) / 128 * 128;
  constexpr size_t smem = f32_smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(fused_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return launch_k(pdl, fused_f32_kernel<DP>, dim3((T + FQ - 1) / FQ, H, B), dim3(FTHREADS), smem, s, q, k, v, lin, mask,
                  out, lout, lse, H, T, T_pad, D, scale);
}

}  // namespace

int attend_f32(const void* q, const void* k, const void* v, int sb, int sh, int st, const void* mask, void* out, int ob,
               int oh, int ot, void* lse, int B, int T, int H, int D, float scale, int plan, void* tickets, void* ws,
               void* stream, bool pdl) {
  if (T < 1 || D % 8 || D < 8) return static_cast<int>(cudaErrorInvalidValue);
  if (D > 128)  // the wide kernel (attention_wide.cu), one pass as here, on the wrapper's plan
    return attend_wide(q, k, v, sb, sh, st, mask, out, ob, oh, ot, lse, B, T, H, D, scale, plan, tickets, ws, stream,
                       pdl);
  auto qp = static_cast<const float*>(q);
  auto kp = static_cast<const float*>(k);
  auto vp = static_cast<const float*>(v);
  auto m = static_cast<const float*>(mask);
  auto o = static_cast<float*>(out);
  auto l = static_cast<float*>(lse);
  const Strides lin{sb, sh, st}, lout{ob, oh, ot};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // D is zero-padded to 32, 64 or 128 columns in shared memory
  const cudaError_t e = D <= 32   ? launch_f32<32>(qp, kp, vp, lin, m, o, lout, l, B, H, T, D, scale, s, pdl)
                        : D <= 64 ? launch_f32<64>(qp, kp, vp, lin, m, o, lout, l, B, H, T, D, scale, s, pdl)
                                  : launch_f32<128>(qp, kp, vp, lin, m, o, lout, l, B, H, T, D, scale, s, pdl);
  return static_cast<int>(e);
}

// q, k, v, out [B, H, T, D] (contiguous; bf16 when is_bf16, else f32),
// mask [B, T] f32 (1 = attend); lse [B, H, T] f32. Any T ≥ 1; D % 8 == 0
// (the wrapper zero-pads D; above 128 through attend_wide_mma in bf16
// and attend_wide in f32, which takes plan, tickets and ws: attend_wide's).
extern "C" int msa_fused_attention(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
                                   int B, int T, int H, int D, int is_bf16, int plan, void* tickets, void* ws,
                                   float scale, void* stream) {
  if (T < 1 || D % 8 || D < 8) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) return attend_heads_first(q, k, v, mask, out, lse, B, T, H, D, scale, stream);
  return attend_f32(q, k, v, H * T * D, T * D, D, mask, out, H * T * D, T * D, D, lse, B, T, H, D, scale, plan, tickets,
                    ws, stream);
}

// Rows 5 and 6 in f32 (the parity mode's encoders at d_model % 128 ≠ 0,
// and past T = 512): the one-pass f32 core on q, k and v strided out of
// qkv [B, T, 3, H, D] (contiguous), writing out [B, T, H·D] and lse
// [B, H, T], both f32; mask [B, T] f32 (1 = attend). Any T ≥ 1; D % 8 == 0
// (the wrapper zero-pads D; above 128 through attend_wide, on plan, tickets
// and ws).
extern "C" int msa_packed_attention_f32(const void* qkv, const void* mask, void* out, void* lse, int B, int T, int H,
                                        int D, int plan, void* tickets, void* ws, float scale, void* stream) {
  const float* q = static_cast<const float*>(qkv);
  const int HD = H * D;
  return attend_f32(q, q + HD, q + 2 * HD, 3 * T * HD, D, 3 * HD, mask, out, T * HD, D, HD, lse, B, T, H, D, scale,
                    plan, tickets, ws, stream);
}
