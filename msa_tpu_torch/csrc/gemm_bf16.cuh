// bf16 GEMM with f32 accumulation and a fused bias (+ optional GELU)
// epilogue, for rows 8 and 10 (attention_block's QKV and Wo projections,
// ffn_fused's fc_in and fc_out):
//   C[m, n] = bf16( act( Σ_k A[m, k]·W[n, k] + bias[n] ) )
// A bf16 [M, K], W bf16 [N, K] (PyTorch's Linear layout), the sum in f32,
// bias f32 (row 8's bqkv, bout) or bf16 (row 10's b1, b2), act the A&S
// 7.1.26 GELU of gemm.cuh or none, C bf16; rows past M are never stored.
// The TPU kernels' dots (msa_tpu/ops/pallas/ffn.py:49-63,
// msa_tpu/ops/pallas/attention.py:574-695) round at these points.
//
// What bounds it on the card: at the encoders' shapes (M = B·T ≤ 1024
// rows, K and N 768–3072) one GEMM is 1.2–4.8 GFLOP, 1.3–4.9 µs at 989
// TFLOP/s, against 2–10 MB of compulsory traffic (0.7–2.9 µs at 3.35
// TB/s): the operations, but so few that a grid that leaves SMs idle, or a
// CTA that walks all of K alone, sets the time. The WMMA kernel it
// replaces had fixed 128 × 128 tiles: 48 CTAs on 132 SMs at Wo and fc_out
// (M = 1024), 6 at M = 64, each walking K = 3072 in 96 steps alone. So:
//
// - Tensor cores through wgmma.mma_async.m64nBNk16.f32.bf16.bf16, A and W
//   both read from shared memory by descriptor (K-major, the transpose
//   immediates 0), one warpgroup per 64 rows of the tile, the f32
//   accumulators in registers.
// - Tiles of BM × BN (64 or 128 each) and a split of K into S runs of
//   whole k-tiles, picked per (M, N, K) by the planner
//   (msa_tpu_torch/ops/kernels/gemm_plan.py, its bf16 rule read off the
//   card's timings of every candidate) and passed as arguments.
// - A k-tile is 64 bf16 (128 bytes, one swizzle row); the ring, the
//   cp.async loader and the descriptors are wgmma.cuh's, shared with the
//   int8 GEMM (gemm_s8.cuh): a k16 step is 32 bytes, as its k32 step is.
//   Rows past M and 16-byte chunks past K are zero-filled, so any M and any
//   K % 8 == 0 (Wo's K = H·DP at DP 32, 64, 128 and above).
// - Split-K stays deterministic: f32 sums depend on their order, so no
//   float atomics. Each split stores its f32 partial tile into its own
//   slice of the workspace (plain stores in the accumulators' register
//   order, coalesced), and the tile's last CTA to arrive (a per-tile
//   counter, __threadfence before and after) adds the S partials in split
//   order 0 … S−1, whichever CTA it is, zeroes the counter for the next
//   launch and runs the epilogue: two calls on the same inputs give the
//   same bits. The workspace needs no zeroing; the counters are zero at
//   rest.
#pragma once

#include "wgmma.cuh"

namespace {

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]),
        "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]),
        "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]),
        "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

// m64n256k16: the 128 × 256 tiles of row 11's convolution (conv_stride2.cu)
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]),
        "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}


// gemm.cuh's A&S 7.1.26 GELU (gelu_as) for an output rounded to bf16 at
// once: the same polynomial and exp, with 1 / (1 + p·|z|) from the
// hardware reciprocal refined by one Newton step instead of the IEEE
// division, whose slow-path branch kept a thread's GELUs from overlapping:
// with it, fc_in's GELU cost as much as its product at M = 1024 on the
// card (PERF.md §6). The reciprocal is within an f32 ulp, far under
// the bf16 rounding that follows.
__device__ __forceinline__ float gelu_to_bf16(float x) {
  const float z = x * 0.70710678118654752f;
  const float s = z > 0.f ? 1.f : (z < 0.f ? -1.f : 0.f);
  const float za = fabsf(z);
  const float d = 1.0f + 0.3275911f * za;
  float t = __fdividef(1.0f, d);
  t = fmaf(t, fmaf(-d, t, 1.0f), t);
  const float poly = t * (0.254829592f +
                          t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return 0.5f * x * (1.0f + s * (1.0f - poly * expf(-za * za)));
}

// C rows m0 .. (of M) and columns n0 .. of a tile from its f32 sums:
// accumulator 4j + 2h + e of thread tid holds row 16·warp + g + 8h of its
// warpgroup's 64, column 8j + 2·tig + e. + bias, the GELU, bf16, staged
// through shared memory (the ring's, idle once every warpgroup is past the
// k-loop; rows BN·2 + 16 bytes apart, so a quad's 8 rows fall on distinct
// banks) and stored as whole 16-byte chunks of a row, a warp writing
// whole rows: the direct 4-byte stores of the accumulators' layout took a
// third of the GEMM's time at M = 1024 on the card (PERF.md §6).
template <int BM, int BN, bool GELU, typename BiasT>
__device__ __forceinline__ void bf16_epilogue(const float (&acc)[BN / 2], const BiasT* __restrict__ bias,
                                              bf16* __restrict__ C, int M, int N, int m0, int n0, int tid,
                                              uint8_t* smem) {
  constexpr int NT = 2 * BM, LD = BN * 2 + 16, CHUNKS = BN / 8;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  __syncthreads();  // every warpgroup's wgmma has read its last stage
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wg * 64 + warp * 16 + g + half * 8;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = j * 8 + tig * 2;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = __fadd_rn(acc[j * 4 + half * 2 + e], to_f32(bias[n0 + c + e]));
        v[e] = GELU ? gelu_to_bf16(x) : x;
      }
      store2(reinterpret_cast<bf16*>(smem + r * LD) + c, v[0], v[1]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < BM * CHUNKS / NT; ++k) {
    const int i = tid + k * NT, r = i / CHUNKS, c = i % CHUNKS;
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(C + (size_t)(m0 + r) * N + n0 + c * 8) =
          *reinterpret_cast<const uint4*>(smem + r * LD + c * 16);
  }
}

// each tile's ring (the depth the card's timings chose; one wgmma group
// left in flight while the next k-tile is waited for)
template <int BM, int BN>
struct Bf16Ring {
  static constexpr int STAGES = BM == 64 && BN == 64 ? 6 : BM == 128 && BN == 128 ? 3 : 4;
  static constexpr int LAG = 1;
};

template <int BM, int BN, bool GELU, typename BiasT>
__global__ void __launch_bounds__(WgCfg<BM, BN>::THREADS)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W, const BiasT* __restrict__ bias,
                 bf16* __restrict__ C, int M, int N, int K, int splits, float* __restrict__ ws,
                 int* __restrict__ counters) {
  using Cfg = WgCfg<BM, BN, Bf16Ring<BM, BN>::STAGES>;
  constexpr int NT = Cfg::THREADS, NREG = Cfg::NREG;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_last;
  uint8_t* smem;
  const uint32_t sbase = wg_smem(smem_raw, smem);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int n_tiles = N / BN, tile = blockIdx.x, split = blockIdx.y;
  const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
  const int row_bytes = K * 2, nk = (row_bytes + WG_BK - 1) / WG_BK;
  const int kt0 = split * nk / splits, nkt = (split + 1) * nk / splits - kt0;

  float acc[NREG];
#pragma unroll
  for (int r = 0; r < NREG; ++r) acc[r] = 0.f;

  auto a8 = reinterpret_cast<const uint8_t*>(A + (size_t)m0 * K);
  auto w8 = reinterpret_cast<const uint8_t*>(W + (size_t)n0 * K);
  auto mma = [&](uint32_t sa, uint32_t sb) {
#pragma unroll
    for (int kk = 0; kk < WG_BK / 32; ++kk)  // k16 steps of 32 bytes inside the swizzle row
      wgmma_bf16(acc, wg_desc(sa + wg * 64 * WG_BK + kk * 32), wg_desc(sb + kk * 32));
  };
  wg_k_loop<Cfg, Bf16Ring<BM, BN>::LAG>(smem, sbase, a8, M - m0, w8, row_bytes, kt0, nkt, tid, mma);
  fence_regs(acc);

  if (splits > 1) {  // deterministic split-K: partials summed in split order by the tile's last CTA
    float* part = ws + (size_t)tile * splits * (BM * BN) + tid;
#pragma unroll
    for (int r = 0; r < NREG; ++r) __stcg(part + (size_t)split * (BM * BN) + r * NT, acc[r]);
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
    for (int r = 0; r < NREG; ++r) acc[r] = __ldcg(part + r * NT);
    for (int s = 1; s < splits; ++s) {
#pragma unroll
      for (int r = 0; r < NREG; ++r) acc[r] = __fadd_rn(acc[r], __ldcg(part + (size_t)s * (BM * BN) + r * NT));
    }
  }

  bf16_epilogue<BM, BN, GELU>(acc, bias, C, M, N, m0, n0, tid, smem);
}

template <int BM, int BN, bool GELU, typename BiasT>
cudaError_t launch_bf16(const bf16* A, const bf16* W, const BiasT* bias, bf16* C, int M, int N, int K, int splits,
                        float* ws, int* counters, cudaStream_t stream) {
  using Cfg = WgCfg<BM, BN, Bf16Ring<BM, BN>::STAGES>;
  auto kernel = gemm_bf16_kernel<BM, BN, GELU, BiasT>;
  static unsigned attr_set = 0;  // one bit per device: shared memory above 48 KB is opted into once
  const cudaError_t e = wg_smem_attr(kernel, Cfg::SMEM, attr_set);
  if (e != cudaSuccess) return e;
  const dim3 grid(((M + BM - 1) / BM) * (N / BN), splits);
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(A, W, bias, C, M, N, K, splits, ws, counters);
  return cudaGetLastError();
}

}  // namespace

// C [M, N] bf16 = act(A·Wᵀ + bias) on the planned tile and split (defined
// in gemm_bf16.cu; rows 8 and 10 launch it from attention.cu and ffn.cu):
// a [M, K] and w [N, K] bf16, bias [N] bf16 (bias_bf16 ≠ 0) or f32, gelu ≠
// 0 for the A&S GELU; ws: the split-K partials (f32, tiles · splits · bm ·
// bn of them), counters: one int32 a tile, zero at rest (both may be null
// without a split); plan: bm | bn << 10 | splits << 20. N % bn == 0,
// K % 8 == 0, M ≥ 1, 1 ≤ splits ≤ the k-tiles of 64 values.
extern "C" int msa_gemm_bf16(const void* a, const void* w, const void* bias, int bias_bf16, void* c, void* ws,
                             void* counters, int M, int N, int K, int plan, int gelu, void* stream);
