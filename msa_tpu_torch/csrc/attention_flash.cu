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
// for P·V, and acc = acc·α + pv with the block's pv summed on its own
// (packed_qkv_attention rounds p/denom instead); at the end o = acc /
// max(l, 1e-30) and lse = m + log(max(l, 1e-30)). The products and sums of
// that recurrence are rounded one at a time (__fmul_rn/__fadd_rn), as the
// plain version computes them. T is padded to a multiple of 128 (zero rows
// under masked keys), so a row with no valid key averages V over all padded
// rows, as on the TPU; D is any multiple of 8 up to 128, zero-padded to DP
// (32, 64 or 128) by the copies; above 128 the entry calls attend_wide_mma
// (attention_wide_mma.cu), in the same order.
//
// What bounds it on the card: 4·T²·D operations per (row, head) on
// 3·T·D·2 bytes in and T·D·2 + 4·T out. At B=2, H=12, T=749, D=64 that is
// 3.45 GFLOP (3.5 µs at 989 TFLOP/s) over 9.2 MB (2.7 µs at 3.35 TB/s); at
// B=1, T=1499, 6.9 GFLOP (7.0 µs) over 9.2 MB: bound by operations, so the
// tensor cores have to be kept fed.
//
// The design (attention_mma.cuh): one block per (64-query tile, head,
// batch row), 4 warps of 16 query rows, and a loop over the 128-key blocks
// in place of the TPU grid's sequential fourth axis. Q's fragments, the
// 16 × 128 score tile, m, l, α and the f32 output accumulator live in
// registers (mma.sync.m16n8k16 with operands from ldmatrix); P goes from
// the score registers straight into the P·V product. K and V have a
// shared-memory buffer each, filled by cp.async as FlashAttention-2 does:
// block j's V copy flies while its scores and softmax step run, block
// j+1's K copy while its P·V runs. 45.5 KB of shared memory a block at
// DP = 64, so several blocks share an SM.
#include "attention_mma.cuh"

namespace {

constexpr int FQ = 64;         // query rows per block
constexpr int FK = 128;        // keys per block: the TPU kernel's block_k
constexpr int FTHREADS = 128;  // 4 warps, 16 query rows each

template <int DP>
constexpr size_t flash_smem_bytes() {
  return (size_t)(FQ + 2 * FK) * (DP + 8) * sizeof(bf16)  // sQ, sK, sV
         + (size_t)FK * sizeof(float);                     // the key mask of the block
}

template <int DP>
__global__ void __launch_bounds__(FTHREADS)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v, Strides lin,
             const float* __restrict__ mask, bf16* __restrict__ out, Strides lout, float* __restrict__ lse, int T,
             int T_pad, int H, int D, float scale) {
  constexpr int LD = DP + 8;
  constexpr int NC = DP < 64 ? DP : 64;  // output columns per P·V pass: bounds pv's registers
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + FQ * LD;
  bf16* sV = sK + FK * LD;
  float* sMask = reinterpret_cast<float*>(sV + FK * LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * FQ, h = blockIdx.y, b = blockIdx.z;
  const float* mrow = mask + (size_t)b * T;
  bf16* sQw = sQ + warp * 16 * LD;

  load_tile_async<FQ, DP, FTHREADS>(sQ, q, lin, b, h, q0, T, D, tid);
  load_tile_async<FK, DP, FTHREADS>(sK, k, lin, b, h, 0, T, D, tid);
  load_vec_async<FK, FTHREADS>(sMask, mrow, 0, T, tid);
  cp_async_commit();

  uint32_t qf[DP / 16][4];
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};  // rows g and g + 8 of the lane
  float acc[DP / 8][4] = {};
  for (int k0 = 0; k0 < T_pad; k0 += FK) {
    cp_async_wait<0>();
    __syncthreads();  // K and the mask of this block have landed; every warp is done with the last V
    if (k0 == 0) load_q_frags<DP>(qf, sQw, lane);
    load_tile_async<FK, DP, FTHREADS>(sV, v, lin, b, h, k0, T, D, tid);
    cp_async_commit();

    // the online-softmax step: m_cur, α, p, l = α·l + Σp
    float s[FK / 8][4], bm[2], alpha[2], sum[2] = {0.f, 0.f};
    tile_dots<FK, DP>(s, qf, sK, lane);
    score_epilogue<FK>(s, sMask, scale, lane);
    tile_row_max<FK>(s, bm);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_cur = fmaxf(m[r], bm[r]);
      alpha[r] = expf(m[r] - m_cur);
      m[r] = m_cur;
    }
#pragma unroll
    for (int n = 0; n < FK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = __fadd_rn(__fmul_rn(alpha[r], l[r]), quad_sum(sum[r]));
    uint32_t pf[FK / 16][4];
    p_frags<FK>(pf, s);

    cp_async_wait<0>();
    __syncthreads();  // V has landed; every warp is done with K and the mask
    if (k0 + FK < T_pad) {
      load_tile_async<FK, DP, FTHREADS>(sK, k, lin, b, h, k0 + FK, T, D, tid);
      load_vec_async<FK, FTHREADS>(sMask, mrow, k0 + FK, T, tid);
      cp_async_commit();
    }

    // acc = acc·α + pv, the block's pv = P·V summed on its own
#pragma unroll
    for (int c0 = 0; c0 < DP; c0 += NC) {
      float pv[NC / 8][4] = {};
      tile_pv<FK, NC, LD>(pv, pf, sV + c0, lane);
#pragma unroll
      for (int n = 0; n < NC / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[c0 / 8 + n][e] = __fadd_rn(__fmul_rn(acc[c0 / 8 + n][e], alpha[e >> 1]), pv[n][e]);
      }
    }
  }

  // o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))
  const float lc[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = acc[n][e] / lc[e >> 1];
  }
  const float row_lse[2] = {m[0] + logf(lc[0]), m[1] + logf(lc[1])};
  store_rows<DP>(acc, row_lse, sQw, out, lout, lse, b, h, H, q0 + warp * 16, T, D, lane);
}

template <int DP>
cudaError_t launch_flash(const bf16* q, const bf16* k, const bf16* v, Strides lin, const float* mask, bf16* out,
                         Strides lout, float* lse, int B, int T, int H, int D, float scale, cudaStream_t s) {
  const int T_pad = (T + FK - 1) / FK * FK;
  constexpr size_t smem = flash_smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  flash_kernel<DP><<<dim3(T_pad / FQ, H, B), FTHREADS, smem, s>>>(q, k, v, lin, mask, out, lout, lse, T, T_pad, H, D,
                                                                  scale);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, T, 3, H, D] bf16 (contiguous), mask [B, T] f32 (1 = attend);
// out [B, T, H·D] bf16, lse [B, H, T] f32. Any T ≥ 1; D % 8 == 0
// (above 128 through attend_wide_mma, attention_wide_mma.cu).
extern "C" int msa_flash_attention(const void* qkv, const void* mask, void* out, void* lse, int B, int T, int H,
                                   int D, float scale, void* stream) {
  if (T < 1 || D % 8 || D < 8) return static_cast<int>(cudaErrorInvalidValue);
  auto q = static_cast<const bf16*>(qkv);
  auto m = static_cast<const float*>(mask);
  auto o = static_cast<bf16*>(out);
  auto l = static_cast<float*>(lse);
  const Strides lin{3 * T * H * D, D, 3 * H * D}, lout{T * H * D, D, H * D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > 128)  // the tensor-core kernel above 128, in row 6's order over the same 128-key blocks
    return attend_wide_mma(q, q + H * D, q + 2 * H * D, lin.b, lin.h, lin.t, mask, out, lout.b, lout.h, lout.t, lse,
                           B, T, H, D, scale, kOnline128, 0, stream);
  // D is zero-padded to 32, 64 or 128 columns in shared memory
  const cudaError_t e = D <= 32   ? launch_flash<32>(q, q + H * D, q + 2 * H * D, lin, m, o, lout, l, B, T, H, D, scale, s)
                        : D <= 64 ? launch_flash<64>(q, q + H * D, q + 2 * H * D, lin, m, o, lout, l, B, T, H, D, scale, s)
                                  : launch_flash<128>(q, q + H * D, q + 2 * H * D, lin, m, o, lout, l, B, T, H, D, scale, s);
  return static_cast<int>(e);
}
