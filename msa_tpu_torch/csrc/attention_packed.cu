// packed_qkv_attention for Hopper: attention straight on the fused QKV
// projection, qkv [B, T, 3, H, D] bf16 → o [B, T, H·D] bf16 and the row
// logsumexp lse [B, H, T] f32, for T ≤ 512.
//
// Replaces msa_tpu/ops/pallas/attention.py:_packed_qkv_attention_lse
// (pallas_call at :489, kernel _packed_qkv_kernel :425-462), which JAX's
// encoder takes where attention_block cannot: d_model % 128 ≠ 0. Same
// rounding points: scores accumulate in f32 from bf16 q and k, s = S·scale
// + bias with bias −1e9 on masked keys (a row with no valid key stays
// finite and averages V over every padded row); the exact row max and
// denom = Σ exp(s − max) over all T_pad keys; P is normalised BEFORE the
// P·V product, (p / denom) rounded to bf16 (attention_block rounds the
// unnormalised P and divides after); o accumulates in f32 and is rounded
// once; lse = max + log(denom).
//
// T is padded to a multiple of 128 inside the kernel: rows past T read as
// zeros under masked keys, and the query rows past T are not written. D is
// any multiple of 8 up to 128; it is zero-padded to DP (32, 64 or 128) in
// shared memory for the 16×16×16 WMMA steps (zeros add nothing).
//
// One block per (64-query tile, head, batch row), 4 warps of 16 query rows.
// The whole f32 score block of the tile (64 × T_pad, ≤ 129 KB) stays in
// shared memory, so the row statistics are exact before P is rounded, as in
// the TPU kernel; K and then V stream through in 64-key chunks.
//
// What bounds it on the card: per (row, head) it does 4·T²·D operations on
// 3·T·D·2 bytes read and T·D·2 + 4·T written. At the full-width training
// shape (B=2, T=512, H=12, D=64) that is 1.6 GFLOP (1.6 µs at 989 TFLOP/s)
// over 6.3 MB (1.9 µs at 3.35 TB/s): about balanced, near both bounds. The
// custom widths of the serving path (D=24, T=40) are tiny and bound by the
// launch. This first design reloads K and V from L2 for every query tile
// and runs the WMMA API without cp.async pipelining; a fast version
// (wgmma, one K/V pass per row and head) is later work.
#include "gemm.cuh"

namespace {

constexpr int PQ = 64;         // query rows per block
constexpr int PK = 64;         // keys per shared-memory chunk
constexpr int PTHREADS = 128;  // 4 warps, 16 query rows each
constexpr int PLP = PK + 8;    // padded bf16 row of a P chunk

template <int DP>
size_t packed_smem_bytes(int T_pad) {
  constexpr int LD = DP + 8;
  return (size_t)(PQ + PK) * LD * sizeof(bf16)       // sQ, sKV
         + (size_t)PQ * PLP * sizeof(bf16)            // sP
         + (size_t)PQ * (T_pad + 4) * sizeof(float)   // sS: scores, then p, then o
         + (size_t)T_pad * sizeof(float)              // mask bias
         + (size_t)2 * PQ * sizeof(float);            // row max, row denom
}

// rows [r0, r0 + nrows) of one of q/k/v (which = 0/1/2) for head h of batch
// row b into smem [nrows × LD] bf16: D columns, zero past D and past T
template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ qkv, int b, int r0, int nrows,
                                          int which, int h, int T, int H, int D, int tid) {
  constexpr int LD = DP + 8;
  const int vecs = DP / 8;
  for (int i = tid; i < nrows * vecs; i += PTHREADS) {
    const int r = i / vecs, c = (i % vecs) * 8, t = r0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t < T && c < D) v = *reinterpret_cast<const uint4*>(qkv + (((size_t)b * T + t) * 3 + which) * H * D + h * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
  }
}

template <int DP>
__global__ void __launch_bounds__(PTHREADS)
packed_qkv_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask, bf16* __restrict__ out,
                  float* __restrict__ lse, int T, int T_pad, int H, int D, float scale) {
  constexpr int LD = DP + 8;
  constexpr int NF = DP / 16;  // 16-wide output fragments per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sKV = sQ + PQ * LD;
  bf16* sP = sKV + PK * LD;
  const int LDS = T_pad + 4;
  float* sS = reinterpret_cast<float*>(sP + PQ * PLP);
  float* sBias = sS + PQ * LDS;
  float* sMax = sBias + T_pad;
  float* sDen = sMax + PQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * PQ, h = blockIdx.y, b = blockIdx.z;

  for (int i = tid; i < T_pad; i += PTHREADS) sBias[i] = (i < T && mask[(size_t)b * T + i] > 0.f) ? 0.f : -1e9f;
  load_rows<DP>(sQ, qkv, b, q0, PQ, 0, h, T, H, D, tid);

  // S = Q·Kᵀ (raw f32 dots) for this warp's 16 rows, one 64-key chunk at a time
  float* sSw = sS + warp * 16 * LDS;
  for (int kc = 0; kc < T_pad; kc += PK) {
    __syncthreads();
    load_rows<DP>(sKV, qkv, b, kc, PK, 1, h, T, H, D, tid);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kt;
        wmma::load_matrix_sync(a, sQ + warp * 16 * LD + kk, LD);
        wmma::load_matrix_sync(kt, sKV + j * 16 * LD + kk, LD);
        wmma::mma_sync(acc, a, kt, acc);
      }
      wmma::store_matrix_sync(sSw + kc + j * 16, acc, LDS, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // row statistics in f32 over all T_pad keys: s = S·scale + bias,
  // p = exp(s − max) kept unrounded, denom = Σ p
  for (int r = 0; r < 16; ++r) {
    float* row = sSw + r * LDS;
    float m = -3.402823466e38f;
    for (int c = lane; c < T_pad; c += 32) {
      const float s = __fadd_rn(__fmul_rn(row[c], scale), sBias[c]);
      row[c] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int c = lane; c < T_pad; c += 32) {
      const float p = expf(row[c] - m);
      row[c] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      sMax[warp * 16 + r] = m;
      sDen[warp * 16 + r] = sum;
    }
  }
  __syncwarp();

  // O = bf16(p / denom) · V, 64 keys at a time
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(o[j], 0.0f);
  bf16* sPw = sP + warp * 16 * PLP;
  for (int kc = 0; kc < T_pad; kc += PK) {
    __syncthreads();  // every warp is done with sKV
    load_rows<DP>(sKV, qkv, b, kc, PK, 2, h, T, H, D, tid);
    for (int i = lane; i < 16 * PK; i += 32) {
      const int r = i / PK, c = i % PK;
      sPw[r * PLP + c] = __float2bfloat16(sSw[r * LDS + kc + c] / sDen[warp * 16 + r]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < PK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> p;
      wmma::load_matrix_sync(p, sPw + kk, PLP);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> v;
        wmma::load_matrix_sync(v, sKV + kk * LD + j * 16, LD);
        wmma::mma_sync(o[j], p, v, o[j]);
      }
    }
  }

  // o → bf16 at this head's D columns of out [B, T, H·D]; lse per row
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::store_matrix_sync(sSw + j * 16, o[j], LDS, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * (D / 8); i += 32) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8, t = q0 + warp * 16 + r;
    if (t >= T) continue;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(sSw[r * LDS + c + e]);
    *reinterpret_cast<uint4*>(out + ((size_t)b * T + t) * H * D + h * D + c) = *reinterpret_cast<const uint4*>(v);
  }
  if (lane < 16) {
    const int t = q0 + warp * 16 + lane;
    if (t < T) lse[((size_t)b * H + h) * T + t] = sMax[warp * 16 + lane] + logf(sDen[warp * 16 + lane]);
  }
}

template <int DP>
cudaError_t launch_packed(const bf16* qkv, const float* mask, bf16* out, float* lse, int B, int T, int H, int D,
                          float scale, cudaStream_t s) {
  const int T_pad = (T + 127) / 128 * 128;
  const size_t smem = packed_smem_bytes<DP>(T_pad);
  cudaError_t e =
      cudaFuncSetAttribute(packed_qkv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  packed_qkv_kernel<DP><<<dim3(T_pad / PQ, H, B), PTHREADS, smem, s>>>(qkv, mask, out, lse, T, T_pad, H, D, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, T, 3, H, D] bf16 (contiguous), mask [B, T] f32 (1 = attend);
// out [B, T, H·D] bf16, lse [B, H, T] f32. T ≤ 512, D % 8 == 0, D ≤ 128.
extern "C" int msa_packed_qkv_attention(const void* qkv, const void* mask, void* out, void* lse, int B, int T, int H,
                                        int D, float scale, void* stream) {
  if (T < 1 || T > 512 || D % 8 || D < 8 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  auto q = static_cast<const bf16*>(qkv);
  auto m = static_cast<const float*>(mask);
  auto o = static_cast<bf16*>(out);
  auto l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // D is zero-padded to 32, 64 or 128 columns in shared memory
  const cudaError_t e = D <= 32   ? launch_packed<32>(q, m, o, l, B, T, H, D, scale, s)
                        : D <= 64 ? launch_packed<64>(q, m, o, l, B, T, H, D, scale, s)
                                  : launch_packed<128>(q, m, o, l, B, T, H, D, scale, s);
  return static_cast<int>(e);
}
