// The port's one f32 GEMM, exact FMA on the CUDA cores (no TF32):
//   C[m, n] = act( Σ_k A[m, k]·B(k, n) + bias[n] ),
// A row-major with a row stride lda (the stride-2 conv reads its input
// rows 2C apart, overlapping), B either [N, K] (PyTorch's Linear layout,
// B_NK) or [K, N] row-major (the conv's weight [k·C, C']), an optional f32
// bias and the exact GELU of gemm.cuh (A&S 7.1.26, as the TPU kernels), C
// row-major [M, N]. A batch axis (grid z) steps A and C by their own
// strides, so one launch serves the conv's batch rows.
//
// The TPU kernels compute these products in f32 inside their Pallas bodies
// (ffn_fused, attention_block and conv_stride2_fused in f32); XLA's CPU
// dot is exact f32, so this GEMM is too: each output is one fmaf chain
// over k in order, and the epilogue adds the bias and applies the GELU in
// f32. Only the summation order differs from a BLAS (the plain versions).
//
// The design is the classic SIMT SGEMM: 128 × 128 output tiles over
// 8-deep k steps, 256 threads of 8 × 8 outputs (two 4-row and two 4-column
// groups 64 apart, so a warp's float4 reads of a k row fall in distinct
// banks), A and B tiles transposed into k-major shared-memory rows of 132
// floats (the stores of a warp then differ in bank), and the next k step's
// tiles fetched into registers while this one's 64 FMAs a k run: one
// __syncthreads a step, 64 FMAs per 4 float4 loads from shared memory.
// Where the tiles do not fill the card's 132 SMs once (the encoder's Wo and
// fc_out, N = 768: 48 tiles at M = 1024, 24 at M = 500), K is split in S
// equal ranges over S times the tiles, each writing its f32 partial sums to
// a workspace, and a second kernel adds the S partials in order, then the
// bias and the GELU: deterministic, no atomics, the same rounding points
// (S partial chains in place of one).
//
// What bounds it on the card: 2·M·N·K FLOP at 67 TFLOP/s (the H100 SXM's
// f32 FMA peak) against (M·K + N·K + M·N)·4 bytes at 3.35 TB/s; at the
// encoder's shapes (M = B·T_pad ≤ 1024, K and N 768–3072) it is bound by
// the FMA rate.
//
// Limits the wrappers check: N % 128 == 0, K % 8 == 0, lda % 4 == 0, every
// pointer 16-byte aligned. M is arbitrary (rows past M read as zeros and
// are not stored).
#pragma once

#include "gemm.cuh"

namespace {

constexpr int FGM = 128;          // block tile rows
constexpr int FGN = 128;          // block tile columns
constexpr int FGK = 8;            // k depth per step
constexpr int FGLD = FGM + 4;     // k-major smem row (floats): the transposed stores differ in bank
constexpr int FGTHREADS = 256;    // 16 × 16 threads of 8 × 8 outputs
constexpr int FG_SMS = 132;       // an H100 SXM's SMs: the grid the tiles should fill
constexpr int FG_MAX_SPLIT = 16;
// floats of split-K workspace an entry is given (msa_gemm_f32_workspace_elems
// tells the wrappers): a split is taken where the tiles do not fill the SMs
// once, so S·M·N stays under twice 132 tiles' worth (17.3 MB)
constexpr size_t FG_WS_ELEMS = (size_t)2 * FG_SMS * FGM * FGN;

// grid z: batch rows (k_len = K, partial null), or the S splits of K (k_len
// = K/S, batch 1), which write raw sums to partial [S, M, N]
// 2 blocks an SM: at most 128 registers a thread (the conv's GELU instance
// took 130 uncapped, which leaves room for one block an SM)
template <bool B_NK, bool GELU>
__global__ void __launch_bounds__(FGTHREADS, 2)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B, const float* __restrict__ bias,
                float* __restrict__ C, int M, int N, int K, int lda, size_t a_batch, size_t c_batch, int k_len,
                float* __restrict__ partial) {
  __shared__ __align__(16) float sA[2][FGK][FGLD];
  __shared__ __align__(16) float sB[2][FGK][FGLD];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * FGN, m0 = blockIdx.y * FGM, z = blockIdx.z;
  const int k_begin = partial ? z * k_len : 0;
  if (!partial) {
    A += z * a_batch;
    C += z * c_batch;
  }

  // the copies: A row m0 + tid/2, k 4·(tid%2)..+3; B (as [N, K]) the same
  // with n, or (as [K, N]) k row tid/32, n 4·(tid%32)..+3
  const int ar = tid / 2, ac = (tid % 2) * 4;
  const bool a_ok = m0 + ar < M;
  const float* a_src = A + (size_t)(a_ok ? m0 + ar : 0) * lda + k_begin + ac;
  const int br = B_NK ? tid / 2 : tid / 32, bc = B_NK ? (tid % 2) * 4 : (tid % 32) * 4;
  const float* b_src = B_NK ? B + (size_t)(n0 + br) * K + k_begin + bc : B + (size_t)(k_begin + br) * N + n0 + bc;

  float4 a_reg, b_reg;
  auto fetch = [&](int k0) {
    a_reg = a_ok ? *reinterpret_cast<const float4*>(a_src + k0) : make_float4(0.f, 0.f, 0.f, 0.f);
    b_reg = *reinterpret_cast<const float4*>(B_NK ? b_src + k0 : b_src + (size_t)k0 * N);
  };
  auto stash = [&](int st) {
    sA[st][ac + 0][ar] = a_reg.x;
    sA[st][ac + 1][ar] = a_reg.y;
    sA[st][ac + 2][ar] = a_reg.z;
    sA[st][ac + 3][ar] = a_reg.w;
    if constexpr (B_NK) {
      sB[st][bc + 0][br] = b_reg.x;
      sB[st][bc + 1][br] = b_reg.y;
      sB[st][bc + 2][br] = b_reg.z;
      sB[st][bc + 3][br] = b_reg.w;
    } else {
      *reinterpret_cast<float4*>(&sB[st][br][bc]) = b_reg;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = k_len / FGK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) fetch((kt + 1) * FGK);  // in flight while this step's FMAs run
#pragma unroll
    for (int kk = 0; kk < FGK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sA[st][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sA[st][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sB[st][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sB[st][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < nk) stash(st ^ 1);  // the other buffer: every thread finished reading it a step ago
    __syncthreads();
  }

  float* out = partial ? partial + (size_t)z * M * N : C;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gr >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gc = n0 + half * 64 + tx * 4;
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = acc[i][half * 4 + j];
        if (!partial) {
          if (bias) v += bias[gc + j];
          v = GELU ? gelu_as(v) : v;
        }
        y[j] = v;
      }
      *reinterpret_cast<float4*>(out + (size_t)gr * N + gc) = make_float4(y[0], y[1], y[2], y[3]);
    }
  }
}

// C = act(Σ_s partial[s] + bias), the S partials added in order; 4 outputs
// a thread
template <bool GELU>
__global__ void __launch_bounds__(256)
split_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ bias, float* __restrict__ C, int M,
                    int N, int S) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x, quads = (size_t)M * N / 4;
  if (i >= quads) return;
  const float4* p = reinterpret_cast<const float4*>(partial);
  float4 v = p[i];
  for (int sp = 1; sp < S; ++sp) {
    const float4 w = p[sp * quads + i];
    v.x += w.x, v.y += w.y, v.z += w.z, v.w += w.w;
  }
  const int n = (int)((i * 4) % N);
  float y[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (bias) y[j] += bias[n + j];
    if (GELU) y[j] = gelu_as(y[j]);
  }
  reinterpret_cast<float4*>(C)[i] = make_float4(y[0], y[1], y[2], y[3]);
}

// The splits of K for M × N tiles: 1 where the tiles fill the SMs once (or
// there is no workspace), else the least S that does, with K/S a multiple
// of the k step and the S partials within FG_WS_ELEMS.
inline int gemm_f32_splits(int M, int N, int K, int batch, bool have_ws) {
  const int tiles = (N / FGN) * ((M + FGM - 1) / FGM) * batch;
  if (batch != 1 || tiles >= FG_SMS || !have_ws) return 1;
  for (int sp = (FG_SMS + tiles - 1) / tiles; sp <= FG_MAX_SPLIT; ++sp)
    if ((K / FGK) % sp == 0 && (size_t)sp * M * N <= FG_WS_ELEMS) return sp;
  return 1;
}

// C [batch][M, N] = act(A [batch][M rows of stride lda] · B + bias); see
// the header for the layouts and limits. ws (FG_WS_ELEMS floats, or none)
// is the split-K workspace: a split whose S partials do not fit is not taken.
template <bool B_NK>
cudaError_t launch_gemm_f32(const float* A, const float* B, const float* bias, float* C, int M, int N, int K, int lda,
                            bool gelu, cudaStream_t s, int batch = 1, size_t a_batch = 0, size_t c_batch = 0,
                            float* ws = nullptr) {
  if (N % FGN || K % FGK || lda % 4 || M < 1) return cudaErrorInvalidValue;
  const int sp = gemm_f32_splits(M, N, K, batch, ws != nullptr);
  float* partial = sp > 1 ? ws : nullptr;
  dim3 grid(N / FGN, (M + FGM - 1) / FGM, sp > 1 ? sp : batch);
  if (gelu && sp == 1)
    gemm_f32_kernel<B_NK, true><<<grid, FGTHREADS, 0, s>>>(A, B, bias, C, M, N, K, lda, a_batch, c_batch, K, nullptr);
  else
    gemm_f32_kernel<B_NK, false><<<grid, FGTHREADS, 0, s>>>(A, B, bias, C, M, N, K, lda, a_batch, c_batch, K / sp,
                                                            partial);
  if (sp == 1) return cudaGetLastError();
  const unsigned blocks = (unsigned)(((size_t)M * N / 4 + 255) / 256);
  if (gelu)
    split_reduce_kernel<true><<<blocks, 256, 0, s>>>(ws, bias, C, M, N, sp);
  else
    split_reduce_kernel<false><<<blocks, 256, 0, s>>>(ws, bias, C, M, N, sp);
  return cudaGetLastError();
}

}  // namespace
