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
// What it computes: row 6's one pass over 128-key blocks, in f32 on the
// CUDA cores with exact FMA (no TF32): m_cur = max(m, rowmax(s)), α =
// exp(m − m_cur), p = exp(s − m_cur), l = α·l + Σp, o = o·α + P·V (the
// plain version sums the block's P·V on its own first: an f32 rounding
// apart); o / max(l, 1e-30) and lse = m + log(max(l, 1e-30)). Every
// rounding to f32 is the identity, so this one order serves every f32 row.
// s = S·scale + bias, the product and the sum each rounded on its own, the
// dot an FMA chain over d in order; bias −1e9 on masked keys and on keys
// past T: T is padded to a multiple of 128, so a row with no valid key
// averages V over all T_pad keys, as on the TPU.
//
// The design (wide_f32_kernel<RPW>): a block owns BQ = 8·RPW query rows
// (64, 32 or 16) and a column tile of up to 256 columns of o, and walks its
// split of the 128-key blocks. Per key block it forms S = Q·Kᵀ over the
// full D ONCE, then o += P·V into all the tile's columns: 4·T²·D operations
// a (row, head) at D ≤ 256. Above D = 256 the column tiles of 256 each
// form S again: ⌈D/256⌉ times.
// - 8 warps; warp w owns query rows RPW·w .. RPW·w + RPW − 1 whole: its
//   lanes hold each row's keys lane + 32j (j < 4) of S and columns 2·lane +
//   64u (u < 4, float2) of o, so a row's max and sum are warp reductions,
//   P goes through the warp's own rows of shared memory (no block barrier),
//   and o (RPW × 8 a thread) stays in registers across the key loop.
// - One cp.async ring of NS = 3 stages of 64 KB carries the work items in
//   order: per key block ⌈D/64⌉ chunks of 64 columns of Q and K, then 2
//   steps of 64 keys of V's column tile; the item NS − 1 ahead is in
//   flight while the FMAs of this one run (one barrier an item; items of
//   32 columns and keys on 4 stages read 8% slower: PERF.md §6).
// - The query tile and the split of the key loop come from the wrapper's
//   planner (ops/kernels/attention_wide_plan.py), which fills the 132 SMs;
//   the entry refuses a plan it cannot take. A split writes its o, m and l
//   to a workspace; the last block of a (b, h, query tile, column tile) to
//   count itself in a per-stream ticket (which it sets back to 0: zero at
//   rest) combines them in split order, as the online softmax would:
//   M = max(m, m_s), l = e^(m−M)·l + e^(m_s−M)·l_s, o = e^(m−M)·o +
//   e^(m_s−M)·o_s. No float atomics: two calls are bit-equal.
//
// What bounds it on the card: 4·T²·D operations a (row, head) at the CUDA
// cores' 67 TFLOP/s (B=2 T=512 H=4 D=192: 1.61 GFLOP, 0.0240 ms) over a
// few MB. Shared memory: the ring 192 KB and P BQ × 132 floats (225 KB at
// BQ = 64), one block of 8 warps an SM. Whole rows a lane for S, so Q's
// loads are warp-wide broadcasts: lanes in row groups (2 rows × 16 keys a
// lane) read 10–30% slower on the card.
//
// In the int8 chain of row 7 on f32 x it is launched under programmatic
// dependent launch (gemm.cuh): pdl_wait comes before its first read of q,
// k and v and before any touch of the workspace and tickets, which the
// chain's kernels share; pdl_trigger after its last load. Launched without
// the attribute (the other f32 rows) both pass at once.
#include "attention_mma.cuh"

namespace {

constexpr int WK = 128;        // keys a step of the key loop: row 6's key block
constexpr int WCT = 256;       // columns of o a block (the column tile above D = 256)
constexpr int WDC = 64;        // D columns of Q and K a ring item
constexpr int WVK = 64;        // keys of V a ring item
constexpr int WNV = WK / WVK;  // V items a key block
constexpr int WTHREADS = 256;  // 8 warps
constexpr int WNS = 3;         // ring stages
constexpr int WLC = WDC + 4;   // row of a Q or K chunk: ≡ 4 (mod 32) words, conflict-free float4 reads
constexpr int WSTAGE = WVK * WCT;  // floats a stage: a V item (16384), or a Q and a K chunk ((BQ + 128) · 68 ≤ 13056)
constexpr int WPL = WK + 4;    // row of sP

template <int RPW>
constexpr size_t wide_f32_smem_bytes() {
  return ((size_t)WNS * WSTAGE + (size_t)8 * RPW * WPL) * sizeof(float) + 16;
}

template <int RPW>
__global__ void __launch_bounds__(WTHREADS, 1)
wide_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, Strides lin,
                const float* __restrict__ mask, float* __restrict__ out, Strides lout, float* __restrict__ lse,
                float* ws, int* tickets, int H, int T, int D, int nqt, int nct, int nkb, int splits, float scale) {
  constexpr int BQ = 8 * RPW, PART = BQ * WCT + 2 * BQ;
  static_assert((BQ + WK) * WLC <= WSTAGE, "a Q and a K chunk fit a stage");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);  // [WNS × WSTAGE]
  float* sP = ring + WNS * WSTAGE;                    // [BQ × WPL]
  int* sFlag = reinterpret_cast<int*>(sP + BQ * WPL);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the block: split fastest, then the column tile, the query tile, (b, h)
  const int sp = blockIdx.x % splits, grp = blockIdx.x / splits;
  const int ct = grp % nct, qt = grp / nct % nqt, bh = grp / nct / nqt, b = bh / H, h = bh % H;
  const int q0 = qt * BQ, c0 = ct * WCT;
  const int kb0 = sp * nkb / splits, kb1 = (sp + 1) * nkb / splits;
  const int nd = (D + WDC - 1) / WDC, per_kb = nd + WNV, items = (kb1 - kb0) * per_kb;
  const int nu = (min(D - c0, WCT) + 63) / 64;  // float2 column groups of o that hold columns < D
  const float* mrow = mask + (size_t)b * T;
  const int r0 = warp * RPW;  // the warp's first query row in the tile
  float* sPw = sP + r0 * WPL;

  // item i of the block: per key block, nd Q/K chunks then WNV V steps
  auto load_item = [&](int i, float* st) {
    const int k0 = (kb0 + i / per_kb) * WK, r = i % per_kb;
    if (r < nd) {
      load_rows_f32<BQ, WDC, WTHREADS>(st, WLC, q, lin, b, h, q0, T, r * WDC, D, tid);
      load_rows_f32<WK, WDC, WTHREADS>(st + BQ * WLC, WLC, k, lin, b, h, k0, T, r * WDC, D, tid);
    } else {
      load_rows_f32<WVK, WCT, WTHREADS>(st, WCT, v, lin, b, h, k0 + (r - nd) * WVK, T, c0, D, tid);
    }
  };

  float o[RPW][8], m[RPW], l[RPW], s[RPW][4];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) o[i][c] = 0.f;
  }

  pdl_wait();  // in row 7's chain on f32 x, q, k and v are the QKV GEMM's output
#pragma unroll
  for (int st = 0; st < WNS - 1; ++st) {
    if (st < items) load_item(st, ring + st * WSTAGE);
    cp_async_commit();
  }
  for (int it = 0; it < items; ++it) {
    cp_async_wait<WNS - 2>();
    // item it is in for every thread, and every warp is done with item
    // it − 1, whose stage the next copy overwrites
    __syncthreads();
    if (it + WNS - 1 < items) load_item(it + WNS - 1, ring + (it + WNS - 1) % WNS * WSTAGE);
    cp_async_commit();
    const float* st = ring + it % WNS * WSTAGE;
    const int r = it % per_kb;
    if (r < nd) {  // s += Q·Kᵀ over this chunk's columns, in order of d
      if (r == 0) {
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        }
      }
      const float* sQ = st + r0 * WLC;
      const float* sK = st + BQ * WLC + lane * WLC;
      const int dw = min(WDC, D - r * WDC);
#pragma unroll 2
      for (int d = 0; d < dw; d += 4) {
        float4 qv[RPW];
#pragma unroll
        for (int i = 0; i < RPW; ++i) qv[i] = *reinterpret_cast<const float4*>(sQ + i * WLC + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(sK + 32 * j * WLC + d);
#pragma unroll
          for (int i = 0; i < RPW; ++i) {
            s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
          }
        }
      }
      if (r == nd - 1) {  // the key block's scores are whole: the online softmax step
        const int k0 = (kb0 + it / per_kb) * WK;
        float bias[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = k0 + lane + 32 * j;
          bias[j] = t < T && mrow[t] > 0.f ? 0.f : MASK_BIAS;
        }
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          float mx = -1e30f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = __fadd_rn(__fmul_rn(s[i][j], scale), bias[j]);
            mx = fmaxf(mx, s[i][j]);
          }
#pragma unroll
          for (int x = 1; x < 32; x <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
          const float m_cur = fmaxf(m[i], mx), alpha = expf(m[i] - m_cur);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p = expf(s[i][j] - m_cur);
            sum += p;
            sPw[i * WPL + lane + 32 * j] = p;
          }
#pragma unroll
          for (int x = 1; x < 32; x <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, x);
          l[i] = __fadd_rn(__fmul_rn(alpha, l[i]), sum);
          m[i] = m_cur;
#pragma unroll
          for (int c = 0; c < 8; ++c) o[i][c] = __fmul_rn(o[i][c], alpha);
        }
        __syncwarp();  // the warp's P rows are whole
      }
    } else {  // o += P·V over this item's 64 keys, an FMA chain over the keys in order
      const int kv0 = (r - nd) * WVK;
      const float* sV = st + 2 * lane;
#pragma unroll 2
      for (int j0 = 0; j0 < WVK; j0 += 4) {
        float4 pq[RPW];
#pragma unroll
        for (int i = 0; i < RPW; ++i) pq[i] = *reinterpret_cast<const float4*>(sPw + i * WPL + kv0 + j0);
#pragma unroll
        for (int jq = 0; jq < 4; ++jq) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (u >= nu) continue;  // warp-uniform: columns past D
            const float2 vv = *reinterpret_cast<const float2*>(sV + (j0 + jq) * WCT + 64 * u);
#pragma unroll
            for (int i = 0; i < RPW; ++i) {
              const float p = jq == 0 ? pq[i].x : jq == 1 ? pq[i].y : jq == 2 ? pq[i].z : pq[i].w;
              o[i][2 * u] = fmaf(p, vv.x, o[i][2 * u]);
              o[i][2 * u + 1] = fmaf(p, vv.y, o[i][2 * u + 1]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  pdl_trigger();  // every load is in

  if (splits > 1) {
    // this split's o, m and l into the workspace; the last block of the
    // group to count itself combines the splits in split order
    float* part = ws + ((size_t)grp * splits + sp) * PART;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        __stcg(reinterpret_cast<float2*>(part + (r0 + i) * WCT + 2 * lane + 64 * u), make_float2(o[i][2 * u], o[i][2 * u + 1]));
      if (lane == 0) {
        __stcg(part + BQ * WCT + r0 + i, m[i]);
        __stcg(part + BQ * WCT + BQ + r0 + i, l[i]);
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const bool last = atomicAdd(tickets + grp, 1) == splits - 1;
      if (last) tickets[grp] = 0;  // zero at rest
      *sFlag = last;
    }
    __syncthreads();
    if (!*sFlag) return;
    __threadfence();
    const float* base = ws + (size_t)grp * splits * PART;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int row = r0 + i;
      float mm = __ldcg(base + BQ * WCT + row), ll = __ldcg(base + BQ * WCT + BQ + row);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 x = __ldcg(reinterpret_cast<const float2*>(base + row * WCT + 2 * lane + 64 * u));
        o[i][2 * u] = x.x;
        o[i][2 * u + 1] = x.y;
      }
      for (int s2 = 1; s2 < splits; ++s2) {
        const float* p2 = base + (size_t)s2 * PART;
        const float ms = __ldcg(p2 + BQ * WCT + row), ls = __ldcg(p2 + BQ * WCT + BQ + row);
        const float mn = fmaxf(mm, ms), a = expf(mm - mn), bb = expf(ms - mn);
        ll = __fadd_rn(__fmul_rn(a, ll), __fmul_rn(bb, ls));
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 x = __ldcg(reinterpret_cast<const float2*>(p2 + row * WCT + 2 * lane + 64 * u));
          o[i][2 * u] = __fadd_rn(__fmul_rn(a, o[i][2 * u]), __fmul_rn(bb, x.x));
          o[i][2 * u + 1] = __fadd_rn(__fmul_rn(a, o[i][2 * u + 1]), __fmul_rn(bb, x.y));
        }
        mm = mn;
      }
      m[i] = mm;
      l[i] = ll;
    }
  }

  // o / max(l, 1e-30) at rows < T and columns < D; the lse from column tile 0
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int t = q0 + r0 + i;
    if (t >= T) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + 2 * lane + 64 * u;
      if (c < D) *reinterpret_cast<float2*>(out + lout.at(b, h, t) + c) = make_float2(o[i][2 * u] / lc, o[i][2 * u + 1] / lc);
    }
    if (lse != nullptr && ct == 0 && lane == 0) lse[((size_t)b * H + h) * T + t] = m[i] + logf(lc);
  }
}

template <int RPW>
cudaError_t launch_wide_f32(const float* q, const float* k, const float* v, Strides lin, const float* mask, float* out,
                            Strides lout, float* lse, float* ws, int* tickets, int B, int T, int H, int D, int splits,
                            float scale, cudaStream_t stream, bool pdl) {
  constexpr int BQ = 8 * RPW;
  constexpr size_t smem = wide_f32_smem_bytes<RPW>();
  const int nqt = (T + BQ - 1) / BQ, nct = (D + WCT - 1) / WCT, nkb = (T + WK - 1) / WK;
  const long long blocks = (long long)B * H * nqt * nct * splits;
  if (splits < 1 || splits > nkb || blocks > 0x7fffffff || (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(wide_f32_kernel<RPW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return launch_k(pdl, wide_f32_kernel<RPW>, dim3((unsigned)blocks), dim3(WTHREADS), smem, stream, q, k, v, lin, mask,
                  out, lout, lse, ws, tickets, H, T, D, nqt, nct, nkb, splits, scale);
}

}  // namespace

int attend_wide(const void* q, const void* k, const void* v, int sb, int sh, int st, const void* mask, void* out,
                int ob, int oh, int ot, void* lse, int B, int T, int H, int D, float scale, int plan, void* tickets,
                void* ws, void* stream, bool pdl) {
  const int bq = plan & 1023, splits = plan >> 10;
  if (B < 1 || H < 1 || T < 1 || D < 8 || D % 8 || (bq != 64 && bq != 32 && bq != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto qf = static_cast<const float*>(q), kf = static_cast<const float*>(k), vf = static_cast<const float*>(v);
  auto mf = static_cast<const float*>(mask);
  auto of = static_cast<float*>(out), lf = static_cast<float*>(lse), wf = static_cast<float*>(ws);
  auto tk = static_cast<int*>(tickets);
  auto s = static_cast<cudaStream_t>(stream);
  const Strides lin{sb, sh, st}, lout{ob, oh, ot};
  const cudaError_t e =
      bq == 64   ? launch_wide_f32<8>(qf, kf, vf, lin, mf, of, lout, lf, wf, tk, B, T, H, D, splits, scale, s, pdl)
      : bq == 32 ? launch_wide_f32<4>(qf, kf, vf, lin, mf, of, lout, lf, wf, tk, B, T, H, D, splits, scale, s, pdl)
                 : launch_wide_f32<2>(qf, kf, vf, lin, mf, of, lout, lf, wf, tk, B, T, H, D, splits, scale, s, pdl);
  return static_cast<int>(e);
}
