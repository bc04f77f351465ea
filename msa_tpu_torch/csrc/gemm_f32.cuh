// The port's one f32 GEMM, exact FMA on the CUDA cores (no TF32):
//   C[m, n] = act( Σ_k A[m, k]·B(k, n) + bias[n] ),
// A row-major with a row stride lda (the stride-2 conv reads its input
// rows 2C apart, overlapping), B either [N, K] (PyTorch's Linear layout,
// B_NK) or [K, N] row-major (the conv's weight [k·C, C']), an optional f32
// bias and the exact GELU of gemm.cuh (A&S 7.1.26, as the TPU kernels), C
// row-major [M, N]. A batch axis steps A and C by their own strides, so one
// launch serves the conv's batch rows. Under rows 10 and 8 in f32
// (ffn.cu, attention.cu) and row 11 in f32 (ops/kernels/conv.py), all
// through the one C entry msa_gemm_f32 (gemm_f32.cu).
//
// The TPU kernels compute these products in f32 inside their Pallas bodies
// (ffn_fused, attention_block and conv_stride2_fused in f32); XLA's CPU
// dot is exact f32, so this GEMM is too: each output's sum over a run of K
// is one fmaf chain over k in order, runs are added in k order, and the
// epilogue adds the bias and applies the GELU in f32. Only the summation
// order differs from a BLAS (the plain versions).
//
// What bounds it on the card: 2·M·N·K FLOP at 67 TFLOP/s (the H100 SXM's
// f32 FMA peak) against (M·K + N·K + M·N)·4 bytes at 3.35 TB/s; at the
// encoder's shapes (M = B·T ≤ 1498, K and N 768–3072) the FMA rate, but a
// tile of 128 × 128 holds 1/132 of the work only by chance: the encoder's
// GEMMs cut into 24–192 such tiles, and a grid of 144 tiles leaves 120 SMs
// idle while 12 finish a second. So:
//
// - Stream-K: the plan (bm | bn << 10 | ctas << 20; planned per (M, N, K)
//   by msa_tpu_torch/ops/kernels/gemm_plan.py, read off the card's sweep)
//   names the tile and a grid of G CTAs; the tiles' k-steps, I = tiles ·
//   ⌈K/32⌉ of them in tile order, are cut into G runs of ⌊g·I/G⌋ ..
//   ⌊(g+1)·I/G⌋, one a CTA, so every SM gets the same FMAs (G = 0: one CTA
//   a tile, whole K, no partials). A CTA walks its run through as many
//   tiles as it spans; a run that covers a tile whole stores it, one that
//   covers part of it stores its f32 partial sums to its own slot of the
//   workspace (2 slots a CTA: its first and its last tile), and the tile's
//   last CTA to arrive (a per-tile counter, __threadfence before and after)
//   adds every partial of the tile in k order, whichever CTA it is, zeroes
//   the counter for the next launch and runs the epilogue. No float
//   atomics, no second launch: two calls on the same inputs give the same
//   bits, and the counters are zero at rest.
// - The k-loop: 32-deep k-steps copied by cp.async 16-byte chunks into a
//   ring of 3 stages in dynamic shared memory (opted in past 48 KB), one
//   __syncthreads a step; the copies run on across tile boundaries and
//   through the epilogues. A and (B_NK) B tiles are K-contiguous rows
//   padded to 36 floats, read as float4 along k with no transpose through
//   registers; a [K, N] B tile is N-contiguous and read as float4 along n.
//   Rows past M and chunks past K are zero-filled (src-size 0): any M,
//   K % 4 == 0.
// - A thread holds 8 rows × TN columns (rows RS = BM/8 apart, columns CS =
//   BN/TN apart for B_NK, else groups of 4), a warp 8 thread rows × 4
//   thread columns, so each float4 read of a k-step serves 8 A rows or 4 B
//   rows in one wavefront. With w [N, K], tiles of 64 × 128 take 8 × 8
//   (64 operand registers a k-group beside 64 sums: 254 registers, two
//   CTAs and 8 warps an SM) and 128 × 64 take 8 × 4 (16 warps an SM at 128
//   registers); with w [K, N], 128 × 128 tiles take 8 × 8 on one CTA an SM.
//   Every thinner register budget for 8 × 8 spilled on the card (PERF.md
//   §6).
//
// Limits the entry checks: N % bn == 0, K % 4 == 0, lda % 4 == 0, every
// pointer 16-byte aligned (the wrappers), 0 ≤ ctas ≤ I. M is arbitrary
// (rows past M read as zeros and are not stored).
#pragma once

#include "gemm.cuh"

namespace {

constexpr int F32_BK = 32;          // k depth of a ring stage
constexpr int F32_LD = F32_BK + 4;  // a K-contiguous smem row (floats): rows 4 banks apart

template <int BM, int BN, bool B_NK>
struct F32Cfg {
  static constexpr int TN = BN == 64 ? 4 : 8;  // a thread's columns (its rows: 8)
  static constexpr int THREADS = BM * BN / (8 * TN);
  // CTAs an SM: 8 × 8 outputs a thread take up to 255 registers (8 warps an
  // SM), 8 × 4 at most 128 (16 warps)
  static constexpr int MIN_CTAS = TN == 4 ? 2 : 256 / THREADS;
  static constexpr int STAGES = 3;
  static constexpr int RS = BM / 8, CS = BN / TN;  // thread rows / columns of the tile
  static constexpr int A_FLOATS = BM * F32_LD;
  static constexpr int B_FLOATS = B_NK ? BN * F32_LD : F32_BK * BN;
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr int SMEM = STAGES * STAGE_FLOATS * 4;
};

// the plan as the entry takes it: bm | bn << 10 | ctas << 20 (0: one CTA a tile)
struct F32Plan {
  int bm, bn, ctas;
  explicit F32Plan(int code) : bm(code & 0x3FF), bn((code >> 10) & 0x3FF), ctas(code >> 20) {}
};

// output row i / column j of thread (tx, ty): rows RS apart; columns CS
// apart (B_NK), else groups of 4, 4·CS apart
template <class Cfg>
__device__ __forceinline__ int f32_row(int ty, int i) {
  return ty + Cfg::RS * i;
}
template <class Cfg, bool B_NK>
__device__ __forceinline__ int f32_col(int tx, int j) {
  return B_NK ? tx + Cfg::CS * j : (j >> 2) * (4 * Cfg::CS) + 4 * tx + (j & 3);
}

// the first CTA whose run holds k-step x: max g with ⌊g·I/G⌋ ≤ x
__device__ __forceinline__ int f32_owner(long long x, long long I, int G) {
  return static_cast<int>(((x + 1) * G - 1) / I);
}

template <int BM, int BN, bool B_NK, bool GELU>
__global__ void __launch_bounds__(F32Cfg<BM, BN, B_NK>::THREADS, F32Cfg<BM, BN, B_NK>::MIN_CTAS)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B, const float* __restrict__ bias,
                float* __restrict__ C, int M, int N, int K, int lda, int batch, int a_batch, int c_batch,
                float* __restrict__ ws, int* __restrict__ counters) {
  using Cfg = F32Cfg<BM, BN, B_NK>;
  constexpr int NT = Cfg::THREADS, RS = Cfg::RS, CS = Cfg::CS, STAGES = Cfg::STAGES, TN = Cfg::TN;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_last;

  // a warp: 4 thread columns × 8 thread rows, so its float4 reads of a k-step
  // touch 4 B rows and 8 A rows, one wavefront each
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = (warp % (CS / 4)) * 4 + lane % 4, ty = (warp / (CS / 4)) * 8 + lane / 4;
  const int n_tiles = N / BN, m_tiles = (M + BM - 1) / BM;
  const int ipt = (K + F32_BK - 1) / F32_BK;  // k-steps a tile
  const long long I = (long long)m_tiles * n_tiles * batch * ipt;  // < 2^31 (the entry checks)
  const int G = gridDim.x, g = blockIdx.x;
  const int it0 = static_cast<int>(g * I / G), it1 = static_cast<int>((g + 1) * I / G);

  // one ring stage of k-step it: A rows m0.. and (B_NK) B rows n0.., k0..k0+31,
  // K-contiguous; or B rows k0.. of [K, N]. 16-byte chunks, a thread's rows
  // 32 (or NT/8) apart
  auto load = [&](int it, int st) {
    const int t = it / ipt, k0 = (it % ipt) * F32_BK;
    const int z = t / (m_tiles * n_tiles), m0 = ((t / n_tiles) % m_tiles) * BM, n0 = (t % n_tiles) * BN;
    float* sA = smem + st * Cfg::STAGE_FLOATS;
    float* sB = sA + Cfg::A_FLOATS;
    constexpr int ROWS = NT / (F32_BK / 4);  // rows a pass of the CTA's chunks covers
    const int r0 = tid / (F32_BK / 4), c = (tid % (F32_BK / 4)) * 4;
    const bool kok = k0 + c < K;
    const float* a_src = A + (size_t)z * a_batch + (size_t)(m0 + r0) * lda + k0 + c;
#pragma unroll
    for (int q = 0; q < BM / ROWS; ++q, a_src += (size_t)ROWS * lda) {
      const bool ok = kok && m0 + r0 + q * ROWS < M;
      cp_async16(sA + (r0 + q * ROWS) * F32_LD + c, ok ? a_src : A, ok);
    }
    if constexpr (B_NK) {
      const float* b_src = B + (size_t)(n0 + r0) * K + k0 + c;
#pragma unroll
      for (int q = 0; q < BN / ROWS; ++q, b_src += (size_t)ROWS * K)
        cp_async16(sB + (r0 + q * ROWS) * F32_LD + c, kok ? b_src : B, kok);
    } else {
#pragma unroll
      for (int q = 0; q < F32_BK * (BN / 4) / NT; ++q) {
        const int i = tid + q * NT, r = i / (BN / 4), cc = (i % (BN / 4)) * 4;
        const bool ok = k0 + r < K;
        cp_async16(sB + r * BN + cc, ok ? B + (size_t)(k0 + r) * N + n0 + cc : B, ok);
      }
    }
  };

  float acc[8][TN];

  // the 32·TN FMAs a thread runs per 4 k of a stage, k in order: its 8 rows
  // and (B_NK) TN columns as float4 along k; a [K, N] B as float4 along n
  auto compute = [&](int st) {
    const float* sA = smem + st * Cfg::STAGE_FLOATS + ty * F32_LD;
    const float* sB = smem + st * Cfg::STAGE_FLOATS + Cfg::A_FLOATS;
#pragma unroll
    for (int kg = 0; kg < F32_BK / 4; ++kg) {
      float a[8][4], b[4][TN];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(a[i]) = *reinterpret_cast<const float4*>(sA + RS * i * F32_LD + kg * 4);
      if constexpr (B_NK) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(sB + (tx + CS * j) * F32_LD + kg * 4);
          b[0][j] = v.x, b[1][j] = v.y, b[2][j] = v.z, b[3][j] = v.w;
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int h = 0; h < TN / 4; ++h)
            *reinterpret_cast<float4*>(&b[kk][4 * h]) =
                *reinterpret_cast<const float4*>(sB + (kg * 4 + kk) * BN + h * (4 * CS) + 4 * tx);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i][kk], b[kk][j], acc[i][j]);
    }
  };

  // element e = TN·i + j of a partial tile lives at slot · BM·BN + e·NT + tid
  auto slot_of = [&](int c, int t) {
    const int first = static_cast<int>(c * I / G) / ipt;  // the first tile of CTA c's run
    return 2 * c + (t == first ? 0 : 1);
  };

  // the end of a run in tile t (at k-step it): the tile's outputs if the
  // run covered it whole, or if this CTA is the tile's last to arrive and
  // has added every run's partial in k order; + bias, the GELU, rows past M
  // not stored
  auto finish = [&](int it) {
    const int t = it / ipt;
    const int z = t / (m_tiles * n_tiles), m0 = ((t / n_tiles) % m_tiles) * BM, n0 = (t % n_tiles) * BN;
    const int x0 = t * ipt, x1 = x0 + ipt;
    if (it0 > x0 || it != x1 - 1) {
      const int first = f32_owner(x0, I, G), last = f32_owner(x1 - 1, I, G);
      float* part = ws + (size_t)slot_of(g, t) * (BM * BN) + tid;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) __stcg(part + (TN * i + j) * NT, acc[i][j]);
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        s_last = atomicAdd(counters + t, 1) == last - first;
        if (s_last) counters[t] = 0;  // every run of the tile has arrived: ready for the next launch
      }
      __syncthreads();
      if (!s_last) return;
      __threadfence();
      for (int c = first; c <= last; ++c) {  // the partials in k order
        const float* p = ws + (size_t)slot_of(c, t) * (BM * BN) + tid;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const float v = __ldcg(p + (TN * i + j) * NT);
            acc[i][j] = c == first ? v : acc[i][j] + v;
          }
      }
    }
    float bv[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = bias ? bias[n0 + f32_col<Cfg, B_NK>(tx, j)] : 0.f;
    float* Cz = C + (size_t)z * c_batch;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + f32_row<Cfg>(ty, i);
      if (row >= M) continue;
      float* out = Cz + (size_t)row * N + n0;
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = bias ? acc[i][4 * h + e] + bv[4 * h + e] : acc[i][4 * h + e];
          y[e] = GELU ? gelu_as(v) : v;
        }
        if constexpr (B_NK) {
#pragma unroll
          for (int e = 0; e < 4; ++e) out[f32_col<Cfg, B_NK>(tx, 4 * h + e)] = y[e];
        } else {
          *reinterpret_cast<float4*>(out + f32_col<Cfg, B_NK>(tx, 4 * h)) = make_float4(y[0], y[1], y[2], y[3]);
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (it0 + s < it1) load(it0 + s, s);
    cp_async_commit();
  }
  for (int it = it0, st = 0; it < it1;) {
    const int seg_end = min(it1, (it / ipt + 1) * ipt);  // this run's k-steps of the tile
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (; it < seg_end; ++it, st = st == STAGES - 1 ? 0 : st + 1) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage st has landed; every thread is done with the stage refilled next
      if (it + STAGES - 1 < it1) load(it + STAGES - 1, st == 0 ? STAGES - 1 : st - 1);
      cp_async_commit();
      compute(st);
    }
    finish(it - 1);
  }
  cp_async_wait<0>();
}

template <int BM, int BN, bool B_NK, bool GELU>
cudaError_t launch_f32(const float* A, const float* B, const float* bias, float* C, int M, int N, int K, int lda,
                       int batch, int a_batch, int c_batch, int ctas, float* ws, int* counters, cudaStream_t s) {
  using Cfg = F32Cfg<BM, BN, B_NK>;
  auto kernel = gemm_f32_kernel<BM, BN, B_NK, GELU>;
  static unsigned attr_set = 0;  // one bit per device: shared memory above 48 KB is opted into once
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (!(attr_set >> dev & 1u)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (e != cudaSuccess) return e;
    attr_set |= 1u << dev;
  }
  const int tiles = ((M + BM - 1) / BM) * (N / BN) * batch;
  kernel<<<ctas ? ctas : tiles, Cfg::THREADS, Cfg::SMEM, s>>>(A, B, bias, C, M, N, K, lda, batch, a_batch, c_batch,
                                                             ws, counters);
  return cudaGetLastError();
}

}  // namespace

// C [batch][M, N] f32 = act(A [batch][M rows of stride lda] · B + bias) on
// the planned tile and grid (defined in gemm_f32.cu; rows 8 and 10 in f32
// launch it from attention.cu and ffn.cu, row 11 in f32 from
// ops/kernels/conv.py): w [N, K] (w_nk ≠ 0) or [K, N], bias [N] or null,
// gelu ≠ 0 for the A&S GELU; A and C step a_batch and c_batch elements a
// batch row; ws: the partials (f32, 2 · ctas · bm · bn), counters: one int32
// a tile, zero at rest (both may be null when ctas is 0 or the tile
// count); plan: bm | bn << 10 | ctas << 20. Tiles 64 × 128 and 128 × 64
// with w [N, K]; 128 × 128 with w [K, N].
extern "C" int msa_gemm_f32(const void* a, const void* w, const void* bias, void* c, void* ws, void* counters,
                            int M, int N, int K, int lda, int w_nk, int batch, int a_batch, int c_batch, int plan,
                            int gelu, void* stream);
