// conv_stride2_fused for Hopper: VALID stride-2 conv1d over x [B, L, C]
// with kernel w [k, C, C'] (k ∈ {2, 3}, nn.Conv's layout), optional exact
// GELU, → out [B, (L − k)/2 + 1, C'] in x's dtype (bf16 or f32).
//
// Replaces msa_tpu/ops/pallas/conv.py:conv_stride2_fused (pallas_call at
// :111, kernel _conv_kernel :54-75), the pair-matmul kernel the wav2vec2
// extractor's stride-2 layers were written for. On the TPU the kernel had
// to regroup rows [2·bl, C] → [bl, 2C] in VMEM, and that relayout sank it
// (conv.py:27-38). Here no relayout is needed: the k taps of output row i
// are the k·C elements that start at x[b, 2i, 0], and they are contiguous.
// So each batch row's conv is ONE GEMM [out_len, k·C] × [k·C, C'] whose A
// operand is the input buffer itself read with a row stride of 2C (the
// rows overlap for k = 3): no im2col, no halo, no copy. The weight [k, C,
// C'] is already the [k·C, C'] B operand, row-major. Batch rows do not
// share a stride (L is odd), so the grid is (C' tile, M tile, batch row).
//
// Rounding as the TPU kernel: products accumulate in f32 over all k taps
// (JAX adds its two partial sums, taps 0–1 and tap 2, in f32 before the
// GELU); the GELU is the A&S 7.1.26 erf form of ops/pallas/ffn.py, in f32;
// the result is rounded once to x's dtype. The wrapper casts the weight to
// x's dtype first, as conv.py:109-110 does.
//
// bf16 (this file's msa_conv_stride2): tensor cores through WMMA
// (16×16×16, f32 accumulators), 128×128 output tiles over 32-deep k steps,
// cp.async double buffering (the tile constants of gemm.cuh), with the B
// operand read row-major. f32: the port's shared f32 SIMT GEMM
// (gemm_f32.cuh: exact FMA, not TF32) through its own entry msa_gemm_f32,
// which ops/kernels/conv.py calls with A read at the row stride 2C, B as
// [k·C, C'] row-major and the batch rows on its stream-K grid.
//
// What bounds it on the card: 2·B·out_len·k·C·C' operations on the input
// read once (B·L·C elements), the weight and the output written once. At
// the wav2vec2 extractor's first stride-2 layer (B=64, L=15999, k=3,
// C=C'=512, bf16) that is 805 GFLOP, 0.81 ms at 989 TFLOP/s, against
// 1.57 GB moved, 0.47 ms at 3.35 TB/s: bound by operations. This first
// design runs the WMMA API without wgmma or TMA; a fast version (wgmma
// with a TMA ring, the A tile loaded once for both overlapping taps) is
// later work.
#include "gemm.cuh"

namespace {

constexpr int CWLD = GBN + 8;  // padded smem row of the weight tile (bf16)

__global__ void __launch_bounds__(GTHREADS)
conv_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ out, int L, int C,
                 int N, int K, int out_len, bool gelu) {
  // [stage]: A tile [128 × GLD], then W tile [GBK × CWLD]; 37 KB in all
  __shared__ __align__(128) bf16 smem[2][GBM * GLD + GBK * CWLD];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = blockIdx.x * GBN, m0 = blockIdx.y * GBM, b = blockIdx.z;
  const bf16* xb = x + (size_t)b * L * C;

  auto load_stage = [&](int stage, int k0) {
    bf16* sA = smem[stage];
    bf16* sW = sA + GBM * GLD;
    for (int i = tid; i < GBM * GBK / 8; i += GTHREADS) {
      const int r = i / (GBK / 8), c = (i % (GBK / 8)) * 8;
      const bool ok = m0 + r < out_len;
      // output row i's taps start at input row 2i: row stride 2C
      cp_async16(&sA[r * GLD + c], xb + (ok ? (size_t)2 * (m0 + r) * C + k0 + c : 0), ok);
    }
    for (int i = tid; i < GBK * GBN / 8; i += GTHREADS) {
      const int r = i / (GBN / 8), c = (i % (GBN / 8)) * 8;
      cp_async16(&sW[r * CWLD + c], w + (size_t)(k0 + r) * N + n0 + c, true);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) wmma::fill_fragment(acc[mi][ni], 0.0f);

  const int nk = K / GBK;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_stage((kt + 1) & 1, (kt + 1) * GBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sA = smem[kt & 1];
    const bf16* sW = sA + GBM * GLD;
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw[2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) wmma::load_matrix_sync(a[mi], sA + (wm * 64 + mi * 16) * GLD + kk, GLD);
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) wmma::load_matrix_sync(bw[ni], sW + kk * CWLD + wn * 32 + ni * 16, CWLD);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) wmma::mma_sync(acc[mi][ni], a[mi], bw[ni], acc[mi][ni]);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // epilogue: each warp stages one 16×16 f32 fragment at a time in its own
  // 1 KB of the idle tile buffer, applies the GELU and writes 8 bf16 per lane
  float* scratch = reinterpret_cast<float*>(&smem[0][0]) + warp * 256;
  const int r = lane >> 1, c = (lane & 1) * 8;
  bf16* ob = out + (size_t)b * out_len * N;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      wmma::store_matrix_sync(scratch, acc[mi][ni], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * 64 + mi * 16 + r;
      const int gc = n0 + wn * 32 + ni * 16 + c;
      if (gr < out_len) {
        __align__(16) bf16 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float y = scratch[r * 16 + c + j];
          v[j] = __float2bfloat16(gelu ? gelu_as(y) : y);
        }
        *reinterpret_cast<uint4*>(ob + (size_t)gr * N + gc) = *reinterpret_cast<const uint4*>(v);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// x [B, L, C], w [k, C, N], out [B, (L − k)/2 + 1, N], all contiguous bf16;
// k ∈ {2, 3}, C and N multiples of 128, L ≥ k.
extern "C" int msa_conv_stride2(const void* x, const void* w, void* out, int B, int L, int C, int N, int k,
                                int gelu, void* stream) {
  if ((k != 2 && k != 3) || C % 128 || N % 128 || L < k || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int out_len = (L - k) / 2 + 1, K = k * C;
  conv_bf16_kernel<<<dim3(N / GBN, (out_len + GBM - 1) / GBM, B), GTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(out), L, C, N, K, out_len,
      gelu != 0);
  return static_cast<int>(cudaGetLastError());
}
