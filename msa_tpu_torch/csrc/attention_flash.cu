// flash_attention for Hopper: blockwise attention with an online softmax,
// for sequences longer than the single-pass kernels take (T > 512). Reads
// q, k and v strided out of the fused QKV projection, qkv [B, T, 3, H, D]
// bf16, and writes o [B, T, H·D] bf16 and lse [B, H, T] f32.
//
// Replaces msa_tpu/ops/pallas/attention.py:_flash_attention_lse
// (pallas_call at :948, kernel _flash_kernel :880-926), which JAX's encoder
// reaches through attention_with_vjp at T > 512: the audio encoder on
// segments longer than ~10 s (T = 749 at 15 s). JAX's q/k/v are
// [B, H, T, D] transposes of the same projection; reading them in place
// computes the same function without the three copies.
//
// Same order of operations as the TPU kernel, over the same 128-key blocks:
// m starts at −1e30 and l at 0; per block s = S·scale + bias (−1e9 on
// masked and padded keys), m_cur = max(m, rowmax(s)), α = exp(m − m_cur),
// p = exp(s − m_cur), l = α·l + Σp, the UNNORMALISED p is rounded to bf16
// for P·V and acc = acc·α + pv (packed_qkv_attention rounds p/denom
// instead); at the end o = acc / max(l, 1e-30) and lse = m + log(max(l,
// 1e-30)). The products and sums of that recurrence are rounded one at a
// time (__fmul_rn/__fadd_rn), as the plain version computes them. T is
// padded to a multiple of 128 inside (zero rows under masked keys), so a
// row with no valid key averages V over all padded rows, as on the TPU; D
// is any multiple of 8 up to 128, zero-padded to DP (32, 64 or 128) in
// shared memory.
//
// One block per (64-query tile, head, batch row), 4 warps of 16 query rows,
// with a loop over the 128-key blocks: the loop takes the place of the TPU
// grid's sequential fourth axis, and the running m, l and the f32 output
// accumulator stay in shared memory between its steps.
//
// What bounds it on the card: 4·T²·D operations per (row, head) on
// 3·T·D·2 bytes in and T·D·2 + 4·T out. At B=2, H=12, T=749, D=64 that is
// 3.45 GFLOP (3.5 µs at 989 TFLOP/s) over 9.2 MB (2.7 µs at 3.35 TB/s):
// bound by operations. This first design loads each K/V block without
// cp.async double buffering and keeps the accumulator in shared memory
// (WMMA fragments cannot be rescaled per row in registers); wgmma with a
// register accumulator and a TMA pipeline are later work.
#include "gemm.cuh"

namespace {

constexpr int FQ = 64;          // query rows per block
constexpr int FK = 128;         // keys per block: the TPU kernel's block_k
constexpr int FTHREADS = 128;   // 4 warps, 16 query rows each
constexpr int FLS = FK + 4;     // padded f32 row of a score block
constexpr int FLP = FK + 8;     // padded bf16 row of a P block

template <int DP>
constexpr size_t flash_smem_bytes() {
  constexpr int LD = DP + 8;
  return (size_t)(FQ + 2 * FK) * LD * sizeof(bf16)  // sQ, sK, sV
         + (size_t)FQ * FLP * sizeof(bf16)           // sP
         + (size_t)FQ * FLS * sizeof(float)          // sS: scores, then pv
         + (size_t)FQ * (DP + 4) * sizeof(float)     // sAcc
         + (size_t)FK * sizeof(float)                // mask bias of the block
         + (size_t)3 * FQ * sizeof(float);           // m, l, α per row
}

template <int DP>
__device__ __forceinline__ void load_block(bf16* dst, const bf16* __restrict__ qkv, int b, int r0, int nrows,
                                           int which, int h, int T, int H, int D, int tid) {
  constexpr int LD = DP + 8;
  const int vecs = DP / 8;
  for (int i = tid; i < nrows * vecs; i += FTHREADS) {
    const int r = i / vecs, c = (i % vecs) * 8, t = r0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t < T && c < D) v = *reinterpret_cast<const uint4*>(qkv + (((size_t)b * T + t) * 3 + which) * H * D + h * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
  }
}

template <int DP>
__global__ void __launch_bounds__(FTHREADS)
flash_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask, bf16* __restrict__ out,
             float* __restrict__ lse, int T, int T_pad, int H, int D, float scale) {
  constexpr int LD = DP + 8;
  constexpr int LA = DP + 4;
  constexpr int NF = DP / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + FQ * LD;
  bf16* sV = sK + FK * LD;
  bf16* sP = sV + FK * LD;
  float* sS = reinterpret_cast<float*>(sP + FQ * FLP);
  float* sAcc = sS + FQ * FLS;
  float* sBias = sAcc + FQ * LA;
  float* sM = sBias + FK;
  float* sL = sM + FQ;
  float* sAlpha = sL + FQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * FQ, h = blockIdx.y, b = blockIdx.z;

  load_block<DP>(sQ, qkv, b, q0, FQ, 0, h, T, H, D, tid);
  for (int i = tid; i < FQ * LA; i += FTHREADS) sAcc[i] = 0.f;
  for (int i = tid; i < FQ; i += FTHREADS) {
    sM[i] = -1e30f;
    sL[i] = 0.f;
  }
  float* sSw = sS + warp * 16 * FLS;
  bf16* sPw = sP + warp * 16 * FLP;
  float* sAccw = sAcc + warp * 16 * LA;

  for (int k0 = 0; k0 < T_pad; k0 += FK) {
    __syncthreads();  // every warp is done with the previous block
    load_block<DP>(sK, qkv, b, k0, FK, 1, h, T, H, D, tid);
    load_block<DP>(sV, qkv, b, k0, FK, 2, h, T, H, D, tid);
    for (int i = tid; i < FK; i += FTHREADS) {
      const int t = k0 + i;
      sBias[i] = (t < T && mask[(size_t)b * T + t] > 0.f) ? 0.f : -1e9f;
    }
    __syncthreads();

    // S = Q·Kᵀ for this warp's 16 rows over the block's 128 keys
#pragma unroll
    for (int j = 0; j < FK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kt;
        wmma::load_matrix_sync(a, sQ + warp * 16 * LD + kk, LD);
        wmma::load_matrix_sync(kt, sK + j * 16 * LD + kk, LD);
        wmma::mma_sync(acc, a, kt, acc);
      }
      wmma::store_matrix_sync(sSw + j * 16, acc, FLS, wmma::mem_row_major);
    }
    __syncwarp();

    // the online-softmax step per row: m_cur, α, p (rounded to bf16 for
    // P·V), l = α·l + Σp
    for (int r = 0; r < 16; ++r) {
      float* row = sSw + r * FLS;
      float bm = -3.402823466e38f;
      for (int c = lane; c < FK; c += 32) {
        const float s = __fadd_rn(__fmul_rn(row[c], scale), sBias[c]);
        row[c] = s;
        bm = fmaxf(bm, s);
      }
      bm = warp_max(bm);
      const float m_prev = sM[warp * 16 + r];
      const float m_cur = fmaxf(m_prev, bm);
      float sum = 0.f;
      for (int c = lane; c < FK; c += 32) {
        const float p = expf(row[c] - m_cur);
        sPw[r * FLP + c] = __float2bfloat16(p);
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        sAlpha[warp * 16 + r] = alpha;
        sL[warp * 16 + r] = __fadd_rn(__fmul_rn(alpha, sL[warp * 16 + r]), sum);
        sM[warp * 16 + r] = m_cur;
      }
    }
    __syncwarp();

    // pv = P·V into the warp's score rows (free now), then acc = acc·α + pv
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> pv;
      wmma::fill_fragment(pv, 0.0f);
#pragma unroll
      for (int kk = 0; kk < FK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> p;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> v;
        wmma::load_matrix_sync(p, sPw + kk, FLP);
        wmma::load_matrix_sync(v, sV + kk * LD + j * 16, LD);
        wmma::mma_sync(pv, p, v, pv);
      }
      wmma::store_matrix_sync(sSw + j * 16, pv, FLS, wmma::mem_row_major);
    }
    __syncwarp();
    for (int i = lane; i < 16 * DP; i += 32) {
      const int r = i / DP, c = i % DP;
      sAccw[r * LA + c] = __fadd_rn(__fmul_rn(sAccw[r * LA + c], sAlpha[warp * 16 + r]), sSw[r * FLS + c]);
    }
    __syncwarp();
  }

  // o = acc / max(l, 1e-30) → bf16 at this head's columns; lse per row
  for (int i = lane; i < 16 * (D / 8); i += 32) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8, t = q0 + warp * 16 + r;
    if (t >= T) continue;
    const float l = fmaxf(sL[warp * 16 + r], 1e-30f);
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(sAccw[r * LA + c + e] / l);
    *reinterpret_cast<uint4*>(out + ((size_t)b * T + t) * H * D + h * D + c) = *reinterpret_cast<const uint4*>(v);
  }
  if (lane < 16) {
    const int t = q0 + warp * 16 + lane;
    if (t < T) lse[((size_t)b * H + h) * T + t] = sM[warp * 16 + lane] + logf(fmaxf(sL[warp * 16 + lane], 1e-30f));
  }
}

template <int DP>
cudaError_t launch_flash(const bf16* qkv, const float* mask, bf16* out, float* lse, int B, int T, int H, int D,
                         float scale, cudaStream_t s) {
  const int T_pad = (T + FK - 1) / FK * FK;
  constexpr size_t smem = flash_smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  flash_kernel<DP><<<dim3(T_pad / FQ, H, B), FTHREADS, smem, s>>>(qkv, mask, out, lse, T, T_pad, H, D, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, T, 3, H, D] bf16 (contiguous), mask [B, T] f32 (1 = attend);
// out [B, T, H·D] bf16, lse [B, H, T] f32. Any T ≥ 1; D % 8 == 0, D ≤ 128.
extern "C" int msa_flash_attention(const void* qkv, const void* mask, void* out, void* lse, int B, int T, int H,
                                   int D, float scale, void* stream) {
  if (T < 1 || D % 8 || D < 8 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  auto q = static_cast<const bf16*>(qkv);
  auto m = static_cast<const float*>(mask);
  auto o = static_cast<bf16*>(out);
  auto l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // D is zero-padded to 32, 64 or 128 columns in shared memory
  const cudaError_t e = D <= 32   ? launch_flash<32>(q, m, o, l, B, T, H, D, scale, s)
                        : D <= 64 ? launch_flash<64>(q, m, o, l, B, T, H, D, scale, s)
                                  : launch_flash<128>(q, m, o, l, B, T, H, D, scale, s);
  return static_cast<int>(e);
}
