// The register-resident attention core of the flash (row 6), packed-QKV
// (rows 5 and 2, and row 1 in bf16) and backward dK/dV (row 4) kernels:
// tensor-core products through raw PTX (mma.sync.m16n8k16 bf16 → f32,
// operands from ldmatrix), tiles brought into shared memory with cp.async,
// and the per-row statistics of the softmax kept in registers. The raw
// product (tile_dots) is shared; the forward adds its epilogue
// (score_epilogue), row 4 its own (P and dS, keys as rows).
//
// A warp owns 16 query rows (16 key rows in row 4). In the m16n8k16
// layouts a lane holds, of each 16 × 8 accumulator tile, rows g = lane/4
// and g + 8 at columns 2·(lane%4) and 2·(lane%4) + 1: so a row's values are
// spread over the 4 lanes of one quad, which reduce a row max or a row sum
// with two shuffles (xor 1, 2).
// The score accumulators of key n-tiles 2i and 2i+1, rounded to bf16 and
// packed in pairs, are exactly the A operand of the P·V product over keys
// [16i, 16i + 16) (FlashAttention-2's register reuse): P never touches
// shared memory. The output accumulator stays in registers too, and is
// staged through the warp's own Q rows only to be written with 16-byte
// stores.
//
// Shared-memory tiles hold DP (32, 64 or 128) bf16 columns in rows of
// LD = DP + 8: the 8 rows an ldmatrix phase reads then start in 8 distinct
// 16-byte bank groups. Columns past D and rows past T are zero-filled by
// the copy (src-size 0); a key mask comes in beside its K tile, 0 past T.
#pragma once

#include "gemm.cuh"

namespace {

constexpr float MASK_BIAS = -1e9f;  // the TPU kernels' additive bias on masked keys

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d[16 × 8] += a[16 × 16] · b[16 × 8], bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 → one bf16x2 register, lo in the low half (round to nearest even)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// a / b rounded to nearest from r = RN(1/b): q = a·r is within an ulp, and
// one FMA step on the exact remainder a − q·b rounds it correctly
// (Markstein's theorem; a and a / b normal). Three instructions per
// element where the IEEE division is a longer sequence with a slow path.
__device__ __forceinline__ float div_rn(float a, float b, float r) {
  const float q = __fmul_rn(a, r);
  return __fmaf_rn(__fmaf_rn(-q, b, a), r, q);
}

// rows [t0, t0 + ROWS) of head h of batch row b of src, D columns, into
// smem [ROWS × (DP + 8)] by cp.async: zeros past D and past T. FOLD_D
// folds the test against D into the count of rows the thread copies (its
// column is the same in every copy): a loop-invariant predicate held
// across a kernel's loop is what ptxas spilled in the dQ and flash
// kernels. Row 4 keeps the per-copy test: folded, it spilled 8 bytes at
// DP 64 and ran 1.7% slower on an H100 (PERF.md).
template <int ROWS, int DP, int NTHREADS, bool FOLD_D = true>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* __restrict__ src, Strides st, int b, int h,
                                                int t0, int T, int D, int tid) {
  constexpr int LD = DP + 8, VECS = DP / 8;
  static_assert(ROWS * VECS % NTHREADS == 0 && NTHREADS % VECS == 0, "whole copies, one column a thread");
  if constexpr (FOLD_D) {
    const int c = (tid % VECS) * 8, r0 = tid / VECS;
    const int rows = c < D ? T - t0 : 0;
#pragma unroll
    for (int it = 0; it < ROWS * VECS / NTHREADS; ++it) {
      const int r = r0 + it * (NTHREADS / VECS);
      const bool ok = r < rows;
      cp_async16(dst + r * LD + c, ok ? src + st.at(b, h, t0 + r) + c : src, ok);
    }
  } else {
#pragma unroll
    for (int it = 0; it < ROWS * VECS / NTHREADS; ++it) {
      const int i = tid + it * NTHREADS, r = i / VECS, c = (i % VECS) * 8, t = t0 + r;
      const bool ok = t < T && c < D;
      cp_async16(dst + r * LD + c, ok ? src + st.at(b, h, t) + c : src, ok);
    }
  }
}

// ROWS floats of a per-time f32 row from t0 into smem, 0 past T: the key
// mask of one batch row (mask + b·T), or the lse or Δ of one head
template <int ROWS, int NTHREADS>
__device__ __forceinline__ void load_vec_async(float* dst, const float* __restrict__ row, int t0, int T, int tid) {
  for (int i = tid; i < ROWS; i += NTHREADS) {
    const bool ok = t0 + i < T;
    cp_async4(dst + i, ok ? row + t0 + i : row, ok);
  }
}

// the A fragments of the warp's 16 rows (sQw: its first row), all DP
// columns: its query rows in the forward, its key or V rows in row 4
template <int DP>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[DP / 16][4], const bf16* sQw, int lane) {
  constexpr int LD = DP + 8;
  const bf16* p = sQw + (lane & 15) * LD + ((lane >> 4) << 3);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) ldsm_x4(qf[kk], p + kk * 16);
}

// s += Q·Kᵀ for the warp's 16 rows over NK keys of sK [NK × LD], in f32
// from bf16 operands, over the DC columns whose A fragments are qf (and
// whose first column sK points at), summed over 16-column slices in order.
// s[n] is the accumulator tile of keys [8n, 8n + 8). The backward takes it
// with other operands: Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ. The kernels above D = 128
// (attention_wide_mma.cu, attention_bwd_wide.cu) sum a score tile over D
// one 64-column chunk at a time.
template <int NK, int DC, int LD>
__device__ __forceinline__ void tile_dots_acc(float (&s)[NK / 8][4], const uint32_t (&qf)[DC / 16][4], const bf16* sK,
                                              int lane) {
  // ldmatrix.x4 over keys [16j, 16j + 16) × columns [16kk, 16kk + 16):
  // matrices (keys 0-7, cols 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
  // are the B fragments (b0, b1) of n-tiles 2j and 2j + 1
  const bf16* p = sK + ((lane & 7) + ((lane >> 4) << 3)) * LD + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int kk = 0; kk < DC / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < NK / 16; ++j) {
      uint32_t kf[4];
      ldsm_x4(kf, p + j * 16 * LD + kk * 16);
      mma_bf16(s[2 * j], qf[kk], kf[0], kf[1]);
      mma_bf16(s[2 * j + 1], qf[kk], kf[2], kf[3]);
    }
  }
}

// s = Q·Kᵀ over all DP columns of sK [NK × (DP + 8)]: tile_dots_acc from zero
template <int NK, int DP>
__device__ __forceinline__ void tile_dots(float (&s)[NK / 8][4], const uint32_t (&qf)[DP / 16][4], const bf16* sK,
                                          int lane) {
#pragma unroll
  for (int n = 0; n < NK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  tile_dots_acc<NK, DP, DP + 8>(s, qf, sK, lane);
}

// the forward's epilogue on a tile_dots result: s = S·scale + bias, the
// product and the sum each rounded on its own as the plain versions
// compute it; bias = 0 where sMask > 0, else −1e9 (sMask: the NK keys)
template <int NK>
__device__ __forceinline__ void score_epilogue(float (&s)[NK / 8][4], const float* sMask, float scale, int lane) {
  const int c = (lane & 3) << 1;
#pragma unroll
  for (int n = 0; n < NK / 8; ++n) {
    const float2 mk = *reinterpret_cast<const float2*>(sMask + n * 8 + c);
    const float b0 = mk.x > 0.f ? 0.f : MASK_BIAS, b1 = mk.y > 0.f ? 0.f : MASK_BIAS;
    s[n][0] = __fadd_rn(__fmul_rn(s[n][0], scale), b0);
    s[n][1] = __fadd_rn(__fmul_rn(s[n][1], scale), b1);
    s[n][2] = __fadd_rn(__fmul_rn(s[n][2], scale), b0);
    s[n][3] = __fadd_rn(__fmul_rn(s[n][3], scale), b1);
  }
}

// the max over the tile of rows g (m[0]) and g + 8 (m[1]), across the quad
template <int NK>
__device__ __forceinline__ void tile_row_max(const float (&s)[NK / 8][4], float (&m)[2]) {
  m[0] = fmaxf(s[0][0], s[0][1]);
  m[1] = fmaxf(s[0][2], s[0][3]);
#pragma unroll
  for (int n = 1; n < NK / 8; ++n) {
    m[0] = fmaxf(m[0], fmaxf(s[n][0], s[n][1]));
    m[1] = fmaxf(m[1], fmaxf(s[n][2], s[n][3]));
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
}

// P [16 × NK] in f32 accumulator tiles → the bf16 A fragments of P·V
template <int NK>
__device__ __forceinline__ void p_frags(uint32_t (&pf)[NK / 16][4], const float (&p)[NK / 8][4]) {
#pragma unroll
  for (int i = 0; i < NK / 16; ++i) {
    pf[i][0] = pack_bf16(p[2 * i][0], p[2 * i][1]);
    pf[i][1] = pack_bf16(p[2 * i][2], p[2 * i][3]);
    pf[i][2] = pack_bf16(p[2 * i + 1][0], p[2 * i + 1][1]);
    pf[i][3] = pack_bf16(p[2 * i + 1][2], p[2 * i + 1][3]);
  }
}

// o[16 × NC] += P[16 × NK] · V[NK × NC]: sV points at the first column of
// an [NK × LD] tile; o[n] is the accumulator tile of columns [8n, 8n + 8)
template <int NK, int NC, int LD>
__device__ __forceinline__ void tile_pv(float (&o)[NC / 8][4], const uint32_t (&pf)[NK / 16][4], const bf16* sV,
                                        int lane) {
  // ldmatrix.x4.trans over keys [16i, 16i + 16) × columns [16j, 16j + 16):
  // matrices (keys 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15),
  // transposed, are the B fragments (b0, b1) of n-tiles 2j and 2j + 1
  const bf16* p = sV + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + ((lane >> 4) << 3);
#pragma unroll
  for (int i = 0; i < NK / 16; ++i) {
#pragma unroll
    for (int j = 0; j < NC / 16; ++j) {
      uint32_t vf[4];
      ldsm_x4_trans(vf, p + i * 16 * LD + j * 16);
      mma_bf16(o[2 * j], pf[i], vf[0], vf[1]);
      mma_bf16(o[2 * j + 1], pf[i], vf[2], vf[3]);
    }
  }
}

// o·mul (the warp's 16 rows in f32) → bf16 at the first D columns of rows
// t0 + r < T of out, through sw, the warp's own 16 rows of a tile no longer
// read (DP + 8 bf16 a row), so that each lane writes 16 bytes
template <int DP>
__device__ __forceinline__ void write_rows(const float (&o)[DP / 8][4], float mul, bf16* sw, bf16* __restrict__ out,
                                           Strides st, int b, int h, int t0, int T, int D, int lane) {
  constexpr int LD = DP + 8;
  const int g = lane >> 2, c = (lane & 3) << 1;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    *reinterpret_cast<uint32_t*>(sw + g * LD + n * 8 + c) = pack_bf16(__fmul_rn(o[n][0], mul), __fmul_rn(o[n][1], mul));
    *reinterpret_cast<uint32_t*>(sw + (g + 8) * LD + n * 8 + c) =
        pack_bf16(__fmul_rn(o[n][2], mul), __fmul_rn(o[n][3], mul));
  }
  __syncwarp();
  const int vecs = D / 8;
  for (int i = lane; i < 16 * vecs; i += 32) {
    const int r = i / vecs, cc = (i % vecs) * 8, t = t0 + r;
    if (t < T) *reinterpret_cast<uint4*>(out + st.at(b, h, t) + cc) = *reinterpret_cast<const uint4*>(sw + r * LD + cc);
  }
}

// o (the warp's 16 rows, already final in f32) → bf16 rows of out through
// the warp's own rows of the Q tile (sQw, free once the Q fragments are in
// registers); row_lse[r] to lse [B, H, T] for rows g and g + 8, unless lse
// is null
template <int DP>
__device__ __forceinline__ void store_rows(const float (&o)[DP / 8][4], const float (&row_lse)[2], bf16* sQw,
                                           bf16* __restrict__ out, Strides lout, float* __restrict__ lse, int b,
                                           int h, int H, int t0, int T, int D, int lane) {
  write_rows<DP>(o, 1.f, sQw, out, lout, b, h, t0, T, D, lane);
  if (lse && (lane & 3) == 0) {
    const int g = lane >> 2;
    float* row = lse + ((size_t)b * H + h) * T;
    if (t0 + g < T) row[t0 + g] = row_lse[0];
    if (t0 + g + 8 < T) row[t0 + g + 8] = row_lse[1];
  }
}

// the rounding order of attend_wide_mma (attention_wide_mma.cu): p/l
// rounded before P·V (rows 1, 2, 5), the unnormalised p with o/denom after
// P·V (rows 7, 8), row 6's online 128-key blocks
enum : int { kNormBefore = 0, kUnnormalised = 1, kOnline128 = 2 };

// rows [t0, t0 + ROWS) × columns [c0, c0 + COLS) of head h of batch row b
// of f32 src (element strides st, D contiguous) into smem rows of ld
// floats by cp.async, 4 floats a copy: zeros past D and past T (the caller
// waits and syncs). The f32 SIMT kernels' copy (attention_wide.cu,
// attention_bwd_f32.cu).
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld, const float* __restrict__ src, Strides st, int b,
                                              int h, int t0, int T, int c0, int D, int tid) {
  constexpr int VECS = COLS / 4;
  for (int i = tid; i < ROWS * VECS; i += NT) {
    const int r = i / VECS, c = (i % VECS) * 4, t = t0 + r;
    const bool ok = t < T && c0 + c < D;
    cp_async16(dst + r * ld + c, ok ? src + st.at(b, h, t) + c0 + c : src, ok);
  }
}

}  // namespace

// The two-pass core of rows 5 and 2 (attention_packed.cu) on q, k, v and o
// [B, H, T, D] at any T: row 1's bf16 path (attention_fused.cu). D % 8 == 0
// (above 128 through attend_wide_mma, D ≤ 512); returns a cudaError_t.
int attend_heads_first(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse, int B,
                       int T, int H, int D, float scale, void* stream);

// The two-pass core in rows 7 and 8's order (attention_packed.cu: bf16 of
// the unnormalised exp(s − m) into P·V, o / l after it, no lse) on q, k, v
// and o addressed by element strides (batch, head, time; D contiguous):
// the attention core of attention.cu. T ≤ 512, D % 8 == 0 (above 128
// through attend_wide_mma in the same order, D ≤ 512); returns a
// cudaError_t. pdl: launched with the programmatic-serialization attribute
// (row 7's chain: the kernel waits for the QKV GEMM before it reads q, k, v).
int attend_unnormalised(const void* q, const void* k, const void* v, int sb, int sh, int st, const void* mask,
                        void* out, int ob, int oh, int ot, int B, int T, int H, int D, float scale, void* stream,
                        bool pdl = false);

// The one-pass f32 core of row 1 (attention_fused.cu) on q, k, v and o
// addressed by element strides (batch, head, time; D contiguous): rows 1,
// 5, 6 and 8 in f32. D % 8 == 0 (above 128 through attend_wide, with its
// plan, tickets and workspace; ignored at D ≤ 128), any T; returns a
// cudaError_t. pdl as attend_unnormalised's (row 7 on f32 x).
int attend_f32(const void* q, const void* k, const void* v, int sb, int sh, int st, const void* mask, void* out, int ob,
               int oh, int ot, void* lse, int B, int T, int H, int D, float scale, int plan, void* tickets, void* ws,
               void* stream, bool pdl = false);

// f32 attention at any head dim D (a multiple of 8), the f32 forward rows'
// path above D = 128 (attention_wide.cu): S formed once per key block at
// D ≤ 256, in row 6's one-pass order (every rounding to f32 is the
// identity). lse may be null. plan = BQ | splits << 10
// (ops/kernels/attention_wide_plan.py): BQ 64, 32 or 16 query rows a block,
// 1 ≤ splits ≤ ⌈T/128⌉ runs of the key loop; above one split, tickets (the
// int32 buffer of the plan, zero at rest) and ws (f32 partials) are
// required. Any T; returns a cudaError_t (cudaErrorInvalidValue on a plan
// it cannot take). pdl as attend_unnormalised's.
int attend_wide(const void* q, const void* k, const void* v, int sb, int sh, int st, const void* mask, void* out,
                int ob, int oh, int ot, void* lse, int B, int T, int H, int D, float scale, int plan, void* tickets,
                void* ws, void* stream, bool pdl = false);

// bf16 attention above head dim 128 on the tensor cores, the bf16 forward
// rows' path there (attention_wide_mma.cu), rounding to bf16 in ``order``
// (kNormBefore, kUnnormalised, kOnline128). q, k and v by element strides
// (sb, sh, st), o by (ob, oh, ot); lse may be null. D > 128, D % 8 == 0,
// any T. nc: the column tile of o (128 or 192; 0 picks it by D and the
// grid, wide_nc); qmode: Q's tile resident in shared memory (1) or
// streamed through the ring (2), 0 picks it by D (wide_q_streamed).
// Returns a cudaError_t. pdl as attend_unnormalised's.
int attend_wide_mma(const void* q, const void* k, const void* v, int sb, int sh, int st, const void* mask, void* out,
                    int ob, int oh, int ot, void* lse, int B, int T, int H, int D, float scale, int order, int nc,
                    void* stream, int qmode = 0, bool pdl = false);

// The D-tiled SIMT backward on f32 operands (attention_bwd_f32.cu): rows 3
// (dq non-null) and 4 (dk and dv non-null) at any D. Arguments as
// msa_attention_bwd_dq_f32/dkv_f32; returns a cudaError_t.
int attend_bwd_simt(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                    const void* delta, const void* mask, void* dq, void* dk, void* dv, int B, int T, int H, int D,
                    int sx_b, int sx_h, int sx_t, int so_b, int so_h, int so_t, float scale, void* stream);

// The bf16 backward above head dim 128 on the tensor cores
// (attention_bwd_wide.cu): row 3 (dq non-null) or row 4 (dk and dv
// non-null). Arguments as msa_attention_bwd_dq/dkv; D > 128, D % 8 == 0,
// any T; nc: the column tile (128, or 192 for dQ at D ≤ 192; 0 picks it
// by D and the grid, dq_nc); omode: the owned rows' tiles resident in
// shared memory (1) or streamed through the ring (2), 0 streams them only
// where they do not fit (wide_owned_streamed). Returns a cudaError_t.
int attend_bwd_wide(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                    const void* delta, const void* mask, void* dq, void* dk, void* dv, int B, int T, int H, int D,
                    int sx_b, int sx_h, int sx_t, int so_b, int so_h, int so_t, float scale, void* stream,
                    int nc = 0, int omode = 0);
