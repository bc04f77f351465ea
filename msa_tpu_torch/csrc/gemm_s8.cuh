// int8 GEMM with a dequantising epilogue, for the W8A8 kernels (rows 7 and 9):
//   C[m, n] = act( f32(Σ_k A[m, k]·W[n, k]) · row_scale[m] · col_scale[n] + bias[n] )
// A int8 [M, K], W int8 [N, K] (PyTorch's Linear layout), int32
// accumulation, f32 epilogue, C f32 or bf16.
//
// The f32 epilogue keeps the TPU kernels' order of products, since f32
// multiplication is not associative: (acc·rs)·cs + b, except for the
// columns in [swap_lo, swap_hi), which take (acc·cs)·rs + b (the K
// projection of msa_tpu/ops/pallas/attention.py:615-624 is computed
// transposed). __fmul_rn/__fadd_rn keep nvcc from contracting them into an
// FMA, so the dequantised value is bit-equal to the plain version's.
//
// What bounds it on the card: at the encoders' shapes (M = B·T ≤ 1024 rows,
// K and N 768–3072) one GEMM is 1.2–4.8 G int8 operations, 0.6–2.4 µs at
// 1,979 TOP/s, against 1–4 MB of compulsory traffic: the operations, but
// so few that a launch that leaves SMs idle or walks K serially sets the
// time. So the design fills the card first:
//
// - Tensor cores through wgmma.mma_async.m64nBNk32.s32.s8.s8, A and W both
//   read from shared memory by descriptor (K-major, the only layout wgmma
//   takes for 8-bit types; both operands are K-major already), one
//   warpgroup per 64 rows of the tile, the int32 accumulators in registers.
// - Square tiles of 64 or 128 and a split of K into S runs of whole
//   128-byte k-tiles, picked per (M, N, K) by the planner
//   (msa_tpu_torch/ops/kernels/gemm_plan.py) from the card's timings of every
//   candidate and passed as arguments: 128 × 128 where that grid alone
//   fills the SMs, else 64 × 64 (one warpgroup a CTA), and K = 3072 split
//   where its tiles hold under half the SMs.
// - k-tiles of 128 bytes come in through a ring of 4 stages (64 × 64, 64
//   KB) or 3 (128 × 128, 96 KB), so that three or two CTAs share an SM, by
//   cp.async, written in the 128-byte swizzle that the wgmma descriptors
//   name; rows past M and bytes past K are zero-filled (src-size 0) and
//   never stored: the ring, loader and descriptor of wgmma.cuh, which the
//   bf16 GEMM (gemm_bf16.cuh) shares. cp.async, not TMA: A is a scratch
//   tensor whose address changes every call, so TMA would encode a tensor
//   map on the host per launch, and the host already sets the wall. Every
//   thread copies; a CTA barrier and cp.async groups guard the ring.
// - Split-K stays exact: each split adds its int32 partial tile into an
//   int32 workspace with atomic adds (in the accumulators' register order,
//   so they are coalesced; integer sums are the same in any order), and
//   the last CTA of the tile to arrive (a per-tile counter, __threadfence
//   before and after) reads the sum back, zeroes the workspace and the
//   counter for the next launch, and runs the epilogue: the sum is
//   converted to f32 once, as the plain version's int8_matmul does.
//   Converting per split would round wherever a partial passes 2^24 (|sum|
//   reaches 127²·3072 ≈ 4.95·10^7 at K = 3072). Reading back each split's
//   own partial instead cost an L2 round trip per split.
// - fc_in's epilogue (GELU) also max-reduces |h| of each row into
//   row_amax (atomicMax on the f32 bits, exact in any order for values
//   ≥ 0), so that the hidden tile's row quantization (quant.cu,
//   msa_quantize_rows_amax) runs no reduction; fc_out's launch (no GELU,
//   row_amax given) zeroes those rows again for the next call.
// - In the int8 chains of rows 7 and 9 the GEMMs launch under
//   programmatic dependent launch (gemm.cuh): the first k-tile of W, the
//   layer's constant, is copied before pdl_wait; A, the scales, the
//   split-K workspace and counters and row_amax only after it.
//
// The wrappers check what the kernel takes: N % 128 == 0, K % 16 == 0,
// A and W 16-byte aligned, any M; the entry points check the plan.
#pragma once

#include "wgmma.cuh"

namespace {

__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]),
        "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]),
        "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]),
        "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),
        "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),
        "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BM, int BN, bool GELU, typename OutT>
__global__ void __launch_bounds__(WgCfg<BM, BN>::THREADS)
gemm_s8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W, const float* __restrict__ row_scale,
               const float* __restrict__ col_scale, const float* __restrict__ bias, OutT* __restrict__ C, int M,
               int N, int K, int swap_lo, int swap_hi, int splits, int* __restrict__ ws,
               int* __restrict__ counters, int* __restrict__ row_amax) {
  using Cfg = WgCfg<BM, BN>;
  constexpr int NT = Cfg::THREADS, NREG = Cfg::NREG;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_last;
  uint8_t* smem;
  const uint32_t sbase = wg_smem(smem_raw, smem);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int n_tiles = N / BN, tile = blockIdx.x, split = blockIdx.y;
  const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
  const int nk = (K + WG_BK - 1) / WG_BK;
  const int kt0 = split * nk / splits, nkt = (split + 1) * nk / splits - kt0;

  int acc[NREG];
#pragma unroll
  for (int r = 0; r < NREG; ++r) acc[r] = 0;

  // W's first k-tile comes in before pdl_wait, A (the last kernel's codes) after it
  auto a8 = reinterpret_cast<const uint8_t*>(A), w8 = reinterpret_cast<const uint8_t*>(W);
  wg_k_loop<Cfg, 0, true>(smem, sbase, a8 + (size_t)m0 * K, M - m0, w8 + (size_t)n0 * K, K, kt0, nkt, tid,
                          [&](uint32_t sa, uint32_t sb) {
#pragma unroll
                            for (int kk = 0; kk < WG_BK / 32; ++kk)  // 32-byte k steps inside the swizzle row
                              wgmma_s8(acc, wg_desc(sa + wg * 64 * WG_BK + kk * 32), wg_desc(sb + kk * 32));
                          });
  fence_regs(acc);
  // fc_in lets the hidden tile's quantization (elementwise, small blocks)
  // start now; QKV's dependent, the attention core, starts when the GEMM
  // ends: begun beside the GEMM's last wave, the core's blocks crowded the
  // SMs that wave had left (1.4x the core's time inside the chain on an
  // H100 at B=2 T=512)
  if constexpr (GELU) pdl_trigger();
  // fc_out: the hidden rows' amax, which the quantization before it has read, zero again
  if (!GELU && row_amax && n0 == 0 && split == 0 && tid < BM && m0 + tid < M) row_amax[m0 + tid] = 0;

  if (splits > 1) {  // exact split-K: int32 atomic sums, read back by the tile's last CTA
    int* sum = ws + (size_t)tile * (BM * BN) + tid;
#pragma unroll
    for (int r = 0; r < NREG; ++r) atomicAdd(sum + r * NT, acc[r]);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      s_last = atomicAdd(counters + tile, 1) == splits - 1;
      if (s_last) counters[tile] = 0;  // every split has arrived: ready for the next launch
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
#pragma unroll
    for (int r = 0; r < NREG; ++r) {
      acc[r] = __ldcg(sum + r * NT);
      __stcg(sum + r * NT, 0);  // zero at rest, for the next launch
    }
  }

  // epilogue: accumulator 4j + 2h + e holds row 16·warp + g + 8h of the
  // warpgroup's 64, column 8j + 2·tig + e
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gr = m0 + wg * 64 + warp * 16 + g + half * 8;
    if (gr >= M) continue;
    const float rs = row_scale[gr];
    float amax = 0.f;  // of this thread's |h| in row gr (GELU: fc_in)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int gc = n0 + j * 8 + tig * 2;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a = __int2float_rn(acc[j * 4 + half * 2 + e]);
        const float cs = col_scale[gc + e];
        const bool swap = gc + e >= swap_lo && gc + e < swap_hi;
        float x = swap ? __fmul_rn(__fmul_rn(a, cs), rs) : __fmul_rn(__fmul_rn(a, rs), cs);
        x = __fadd_rn(x, bias[gc + e]);
        v[e] = GELU ? gelu_as(x) : x;
        amax = fmaxf(amax, fabsf(v[e]));
      }
      store2(C + (size_t)gr * N + gc, v[0], v[1]);
    }
    if (GELU && row_amax) {  // the 4 lanes of a quad hold row gr
      const unsigned quad = 0xFu << (lane & ~3);
      amax = fmaxf(amax, __shfl_xor_sync(quad, amax, 1));
      amax = fmaxf(amax, __shfl_xor_sync(quad, amax, 2));
      if (tig == 0) atomicMax(row_amax + gr, __float_as_int(amax));
    }
  }
}

template <int BM, int BN, bool GELU, typename OutT>
cudaError_t launch_s8(const int8_t* A, const int8_t* W, const float* rs, const float* cs, const float* bias, OutT* C,
                      int M, int N, int K, int splits, int* ws, int* counters, int* row_amax, cudaStream_t stream,
                      int swap_lo, int swap_hi, bool pdl) {
  using Cfg = WgCfg<BM, BN>;
  auto kernel = gemm_s8_kernel<BM, BN, GELU, OutT>;
  static unsigned attr_set = 0;  // one bit per device: shared memory above 48 KB is opted into once
  const cudaError_t e = wg_smem_attr(kernel, Cfg::SMEM, attr_set);
  if (e != cudaSuccess) return e;
  const dim3 grid(((M + BM - 1) / BM) * (N / BN), splits);
  return launch_k(pdl, kernel, grid, dim3(Cfg::THREADS), Cfg::SMEM, stream, A, W, rs, cs, bias, C, M, N, K, swap_lo,
                  swap_hi, splits, ws, counters, row_amax);
}

// C = epilogue(A·Wᵀ) on the planned tile and split; ws and counters are the
// split-K workspace (the padded M × N int32) and the per-tile counters, both
// zero at rest and both from the wrapper; row_amax (int32 [M], or null):
// with GELU each row's max |h| is merged into it as f32 bits (it is zero
// before), without GELU it is zeroed (fc_out restores fc_in's buffer);
// pdl: launched with the programmatic-serialization attribute (in a chain,
// after the kernel that writes A)
template <bool GELU, typename OutT>
cudaError_t launch_gemm_s8(const void* A, const void* W, const void* rs, const void* cs, const void* bias, void* C,
                           int M, int N, int K, int plan_code, void* ws, void* counters, cudaStream_t stream,
                           int swap_lo = 0, int swap_hi = 0, void* row_amax = nullptr, bool pdl = false) {
  const WgPlan p(plan_code);
  const int nk = (K + WG_BK - 1) / WG_BK;
  if ((p.bm != 64 && p.bm != 128) || p.bn != p.bm || N % p.bn || K % 16 || M < 1 || p.splits < 1 || p.splits > nk ||
      (p.splits > 1 && (!ws || !counters)))
    return cudaErrorInvalidValue;
  auto a = static_cast<const int8_t*>(A), w = static_cast<const int8_t*>(W);
  auto r = static_cast<const float*>(rs), c = static_cast<const float*>(cs), b = static_cast<const float*>(bias);
  auto out = static_cast<OutT*>(C);
  auto wsp = static_cast<int*>(ws), cnt = static_cast<int*>(counters), amax = static_cast<int*>(row_amax);
  if (p.bm == 128)
    return launch_s8<128, 128, GELU>(a, w, r, c, b, out, M, N, K, p.splits, wsp, cnt, amax, stream, swap_lo, swap_hi,
                                     pdl);
  return launch_s8<64, 64, GELU>(a, w, r, c, b, out, M, N, K, p.splits, wsp, cnt, amax, stream, swap_lo, swap_hi, pdl);
}

}  // namespace

// Row quantization, defined in quant.cu (behind the C entries the wrapper
// of msa_tpu_torch/ops/kernels/quant.py calls): from x alone, and from f32
// x with each row's amax already reduced (fc_in's epilogue above); pdl as
// launch_gemm_s8's. Each returns a cudaError_t.
int quantize_rows_launch(const void* x, int x_is_bf16, void* q, void* scale, int rows, int cols, cudaStream_t s,
                         bool pdl);
int quantize_rows_amax_launch(const void* x, const void* amax, void* q, void* scale, int rows, int cols,
                              cudaStream_t s, bool pdl);
