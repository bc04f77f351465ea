// fused_attention for Hopper: single-pass softmax attention on q, k, v
// [B, H, T, D] at any T, in bf16 or f32, → o [B, H, T, D] in q's dtype and
// the row logsumexp lse [B, H, T] f32.
//
// Replaces msa_tpu/ops/pallas/attention.py:_fused_attention_lse
// (pallas_call at :206, kernel _attention_kernel :59-83), the function
// behind the public fused_attention. Unlike rows 2 and 5 it has no T limit
// and takes f32 as well as bf16, so it is a kernel of its own.
//
// Same rounding points as the TPU kernel: s = (q·k)·scale + bias with the
// dot accumulated in f32 and bias −1e9 on masked keys; the exact row max m
// and denom = Σ exp(s − m) over every key of the padded row; P normalised
// BEFORE P·V, (p / denom) rounded to v's dtype; o accumulated in f32 and
// rounded once; lse = m + log(denom). T is padded to a multiple of 128 with
// zero keys under the −1e9 bias, so a row with no valid key averages V over
// all T_pad keys, as on the TPU. D ≤ 128 is zero-padded to DP (32, 64 or
// 128) in shared memory; zeros add nothing.
//
// One block per (64-query tile, head, batch row), 128 threads; thread 2r
// and 2r+1 own query row r of the tile, each half of its keys and half of
// its output columns. Two passes over 64-key chunks, so the score row never
// has to fit in shared memory: pass 1 keeps the running max and the f32
// denominator (l rescaled by exp(m_old − m_new) when the max moves), pass 2
// recomputes the scores, forms p / denom and accumulates P·V. The padded
// query rows are computed and not written.
//
// bf16: both dots on tensor cores (16×16×16 WMMA, f32 accumulators, each
// warp its 16 query rows). f32: both dots in f32 FMA on the CUDA cores, not
// TF32, which keeps ~3 digits: JAX's f32 kernel is exact f32 on the CPU.
//
// What bounds it on the card: per (row, head) 4·T_pad²·D operations on
// 3·T·D·s bytes read and T·D·s + 4·T written (s the element size). At the
// encoder's shape (B=2, H=12, T=512, D=64, bf16) that is 1.6 GFLOP (1.6 µs
// at 989 TFLOP/s) over 6.3 MB (1.9 µs at 3.35 TB/s). This simple design
// computes the scores twice and reloads K (twice) and V from L2 for every
// query tile, without cp.async pipelining; the f32 path is bound by the
// CUDA cores' 67 TFLOP/s. A fast version is later work.
#include "gemm.cuh"

namespace {

constexpr int FQ = 64;         // query rows per block
constexpr int FK = 64;         // keys per chunk
constexpr int FTHREADS = 128;  // 2 threads per query row
constexpr int FHALF = FK / 2;  // keys of a chunk per thread

// rows [r0, r0 + FQ) of (b, h) of src [B, H, T, D] into smem [FQ × LD]:
// D columns, zero past D and past T
template <typename T, int DP, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int r0, int T_len, int D, int tid) {
  for (int i = tid; i < FQ * DP; i += FTHREADS) {
    const int r = i / DP, c = i % DP, t = r0 + r;
    dst[r * LD + c] = (t < T_len && c < D) ? src[(size_t)t * D + c] : T(0.f);
  }
}

// the chunk's mask bias: 0 where the key is valid, −1e9 on masked and
// padded keys
__device__ __forceinline__ void load_bias(float* sBias, const float* __restrict__ mask, int b, int kc, int T_len,
                                          int tid) {
  if (tid < FK) {
    const int t = kc + tid;
    sBias[tid] = (t < T_len && mask[(size_t)b * T_len + t] > 0.f) ? 0.f : -1e9f;
  }
}

// s = dot·scale + bias, rounded one step at a time (no contraction)
__device__ __forceinline__ float score(float dot, float scale, float bias) {
  return __fadd_rn(__fmul_rn(dot, scale), bias);
}

// pass 1's update of (m, l) from this thread's FHALF scores of a chunk;
// the partner thread (same row) sees the same values after the shuffles
__device__ __forceinline__ void online_update(const float (&s)[FHALF], float& m, float& l) {
  float cmax = s[0];
#pragma unroll
  for (int j = 1; j < FHALF; ++j) cmax = fmaxf(cmax, s[j]);
  cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 1));
  const float m_new = fmaxf(m, cmax);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < FHALF; ++j) sum += expf(s[j] - m_new);
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  l = l * expf(m - m_new) + sum;
  m = m_new;
}

template <int DP>
size_t bf16_smem_bytes() {
  constexpr int LD = DP + 8, SLD = (DP > FK ? DP : FK) + 4, PLD = FK + 8;
  return (size_t)2 * FQ * LD * sizeof(bf16) + (size_t)FQ * SLD * sizeof(float) + (size_t)FQ * PLD * sizeof(bf16) +
         FK * sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(FTHREADS)
fused_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                  const float* __restrict__ mask, bf16* __restrict__ out, float* __restrict__ lse, int H, int T_len,
                  int T_pad, int D, float scale) {
  constexpr int LD = DP + 8;                    // bf16 row of Q, K or V
  constexpr int SLD = (DP > FK ? DP : FK) + 4;  // f32 row of scores, then of o
  constexpr int PLD = FK + 8;                   // bf16 row of P
  constexpr int NF = DP / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sKV = sQ + FQ * LD;
  float* sS = reinterpret_cast<float*>(sKV + FQ * LD);
  bf16* sP = reinterpret_cast<bf16*>(sS + FQ * SLD);
  float* sBias = reinterpret_cast<float*>(sP + FQ * PLD);

  const int tid = threadIdx.x, warp = tid >> 5, r = tid >> 1, half = tid & 1;
  const int q0 = blockIdx.x * FQ, h = blockIdx.y, b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * T_len * D;
  load_tile<bf16, DP, LD>(sQ, q + head, q0, T_len, D, tid);

  // S chunk = Q·Kᵀ for this warp's 16 rows into sS (raw f32 dots)
  auto scores = [&](int kc) {
    __syncthreads();  // every warp is done with sKV and sBias
    load_tile<bf16, DP, LD>(sKV, k + head, kc, T_len, D, tid);
    load_bias(sBias, mask, b, kc, T_len, tid);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < FK / 16; ++j) {
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
      wmma::store_matrix_sync(sS + warp * 16 * SLD + j * 16, acc, SLD, wmma::mem_row_major);
    }
    __syncwarp();
  };

  // pass 1: the row max and the f32 denominator
  float m = -3.402823466e38f, l = 0.f;
  float s[FHALF];
  for (int kc = 0; kc < T_pad; kc += FK) {
    scores(kc);
#pragma unroll
    for (int j = 0; j < FHALF; ++j) s[j] = score(sS[r * SLD + half * FHALF + j], scale, sBias[half * FHALF + j]);
    online_update(s, m, l);
  }

  // pass 2: O = bf16(p / denom) · V
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(o[j], 0.0f);
  for (int kc = 0; kc < T_pad; kc += FK) {
    scores(kc);
#pragma unroll
    for (int j = 0; j < FHALF; ++j) {
      const int c = half * FHALF + j;
      const float p = expf(score(sS[r * SLD + c], scale, sBias[c]) - m);
      sP[r * PLD + c] = __float2bfloat16(p / l);
    }
    __syncthreads();  // every warp is done with K in sKV
    load_tile<bf16, DP, LD>(sKV, v + head, kc, T_len, D, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
      wmma::load_matrix_sync(pf, sP + warp * 16 * PLD + kk, PLD);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, sKV + kk * LD + j * 16, LD);
        wmma::mma_sync(o[j], pf, vf, o[j]);
      }
    }
  }

  // o → bf16 at rows < T and columns < D; lse per row
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::store_matrix_sync(sS + warp * 16 * SLD + j * 16, o[j], SLD, wmma::mem_row_major);
  __syncwarp();
  const int t = q0 + r;
  if (t < T_len) {
    for (int c = half; c < D; c += 2) out[head + (size_t)t * D + c] = __float2bfloat16(sS[r * SLD + c]);
    if (half == 0) lse[((size_t)b * H + h) * T_len + t] = m + logf(l);
  }
}

template <int DP>
size_t f32_smem_bytes() {
  constexpr int LD = DP + 1, SLD = FK + 1;
  return ((size_t)2 * FQ * LD + (size_t)FQ * SLD + FK) * sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(FTHREADS)
fused_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ mask, float* __restrict__ out, float* __restrict__ lse, int H, int T_len,
                 int T_pad, int D, float scale) {
  constexpr int LD = DP + 1;   // odd row: the 16 rows a warp reads differ in bank
  constexpr int SLD = FK + 1;  // f32 row of P
  constexpr int OC = DP / 2;   // output columns per thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sKV = sQ + FQ * LD;
  float* sP = sKV + FQ * LD;
  float* sBias = sP + FQ * SLD;

  const int tid = threadIdx.x, r = tid >> 1, half = tid & 1;
  const int q0 = blockIdx.x * FQ, h = blockIdx.y, b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * T_len * D;
  load_tile<float, DP, LD>(sQ, q + head, q0, T_len, D, tid);

  // this thread's FHALF scores of row r in chunk kc, in f32 FMA
  float s[FHALF];
  auto scores = [&](int kc) {
    __syncthreads();
    load_tile<float, DP, LD>(sKV, k + head, kc, T_len, D, tid);
    load_bias(sBias, mask, b, kc, T_len, tid);
    __syncthreads();
    float acc[FHALF];
#pragma unroll
    for (int j = 0; j < FHALF; ++j) acc[j] = 0.f;
    for (int d = 0; d < DP; ++d) {
      const float qd = sQ[r * LD + d];
#pragma unroll
      for (int j = 0; j < FHALF; ++j) acc[j] = fmaf(qd, sKV[(half * FHALF + j) * LD + d], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < FHALF; ++j) s[j] = score(acc[j], scale, sBias[half * FHALF + j]);
  };

  float m = -3.402823466e38f, l = 0.f;
  for (int kc = 0; kc < T_pad; kc += FK) {
    scores(kc);
    online_update(s, m, l);
  }

  float o[OC];
#pragma unroll
  for (int c = 0; c < OC; ++c) o[c] = 0.f;
  for (int kc = 0; kc < T_pad; kc += FK) {
    scores(kc);
#pragma unroll
    for (int j = 0; j < FHALF; ++j) sP[r * SLD + half * FHALF + j] = expf(s[j] - m) / l;
    __syncthreads();  // every thread is done with K in sKV
    load_tile<float, DP, LD>(sKV, v + head, kc, T_len, D, tid);
    __syncthreads();
    for (int j = 0; j < FK; ++j) {
      const float p = sP[r * SLD + j];
#pragma unroll
      for (int c = 0; c < OC; ++c) o[c] = fmaf(p, sKV[j * LD + half * OC + c], o[c]);
    }
  }

  const int t = q0 + r;
  if (t < T_len) {
#pragma unroll
    for (int c = 0; c < OC; ++c)
      if (half * OC + c < D) out[head + (size_t)t * D + half * OC + c] = o[c];
    if (half == 0) lse[((size_t)b * H + h) * T_len + t] = m + logf(l);
  }
}

template <int DP>
cudaError_t launch_dp(bool is_bf16, const void* q, const void* k, const void* v, const float* mask, void* out,
                      float* lse, int B, int H, int T_len, int D, float scale, cudaStream_t s) {
  const int T_pad = (T_len + 127) / 128 * 128;
  const dim3 grid((T_len + FQ - 1) / FQ, H, B);
  cudaError_t e;
  if (is_bf16) {
    const size_t smem = bf16_smem_bytes<DP>();
    e = cudaFuncSetAttribute(fused_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    fused_bf16_kernel<DP><<<grid, FTHREADS, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), mask,
        static_cast<bf16*>(out), lse, H, T_len, T_pad, D, scale);
  } else {
    const size_t smem = f32_smem_bytes<DP>();
    e = cudaFuncSetAttribute(fused_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    fused_f32_kernel<DP><<<grid, FTHREADS, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), mask,
        static_cast<float*>(out), lse, H, T_len, T_pad, D, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out [B, H, T, D] (contiguous; bf16 when is_bf16, else f32),
// mask [B, T] f32 (1 = attend); lse [B, H, T] f32. Any T ≥ 1, D ≤ 128.
extern "C" int msa_fused_attention(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
                                   int B, int T, int H, int D, int is_bf16, float scale, void* stream) {
  if (T < 1 || D < 1 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  auto m = static_cast<const float*>(mask);
  auto l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  const cudaError_t e = D <= 32   ? launch_dp<32>(bf, q, k, v, m, out, l, B, H, T, D, scale, s)
                        : D <= 64 ? launch_dp<64>(bf, q, k, v, m, out, l, B, H, T, D, scale, s)
                                  : launch_dp<128>(bf, q, k, v, m, out, l, B, H, T, D, scale, s);
  return static_cast<int>(e);
}
