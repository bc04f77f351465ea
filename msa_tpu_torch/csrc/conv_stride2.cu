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
// rows overlap for k = 3): no im2col, no halo, no copy.
//
// Rounding as the TPU kernel: products accumulate in f32 over all k taps
// (JAX adds its two partial sums, taps 0–1 and tap 2, in f32 before the
// GELU); the GELU is the A&S 7.1.26 erf form of ops/pallas/ffn.py, in f32;
// the result is rounded once to x's dtype. The wrapper casts the weight to
// x's dtype first, as conv.py:109-110 does. The bf16 kernel takes the GELU
// as gemm_bf16.cuh's gelu_to_bf16 (rows 8 and 10's): gelu_as's polynomial
// and exp, its 1 / (1 + p·|z|) from the hardware reciprocal and one Newton
// step (within an f32 ulp, under the bf16 rounding that follows) instead
// of the IEEE division; with the division the GELU took 0.448 of 1.563 ms
// at B=64 L=15999 on an H100 (profile_slice.py --conv, PERF.md §6).
//
// f32: the port's shared f32 SIMT GEMM (gemm_f32.cuh: exact FMA, not TF32)
// through its own entry msa_gemm_f32, which ops/kernels/conv.py calls with
// A read at the row stride 2C, B as [k·C, C'] row-major and the batch rows
// on its stream-K grid. bf16: this file's msa_conv_stride2.
//
// What bounds it on the card: 2·B·out_len·k·C·C' operations on the input
// read once (B·L·C elements), the weight and the output written once. At
// the wav2vec2 extractor's first stride-2 layer (B=64, L=15999, k=3,
// C=C'=512, bf16) that is 805 GFLOP, 0.81 ms at 989 TFLOP/s, against
// 1.57 GB moved, 0.47 ms at 3.35 TB/s: bound by operations, and the
// largest GEMM of the repository. The WMMA kernel this replaces read 175
// TFLOP/s there (4.595 ms against cuDNN's 2.573, PERF.md §6): mma.sync
// under the WMMA API, two cp.async stages a 32-deep k step with two CTA
// barriers each, 16,128 short-lived blocks, and an epilogue one 16 × 16
// fragment at a time. So:
//
// - Tensor cores through wgmma.mma_async.m64n256k16.f32.bf16.bf16, A and B
//   both from shared memory by descriptor (wgmma.cuh's wg_desc: K-major,
//   the 128-byte swizzle); tiles of 128 output rows × 256 columns, two
//   consumer warpgroups of 64 rows each (128 f32 accumulators a thread).
// - Loads by TMA into a ring of 4 stages of one 64-deep k-tile (16 KB of A,
//   32 KB of B), completed on mbarriers: one producer warp issues them
//   (its warpgroup gives its registers to the consumers with setmaxnreg),
//   and each consumer warpgroup frees a stage once the wgmma group that
//   read it has completed (one group kept in flight).
// - A's rows overlap, so A has one tensor map per tap t: dims [B, out_len,
//   C] over x + t·C with a row stride of 2C elements, so its row i is
//   x[b, 2i + t, :]. A k-tile k0 = t·C + c0 of the tile's rows i0 … is the
//   box (c0, i0, b) of tap t's map (C % 64 == 0, so a k-tile never spans two
//   taps). Row 2(out_len − 1) + t ≤ L − 1 is the last row a map reaches,
//   so no box reads past a batch row or the allocation, L odd or even;
//   rows past out_len come back as zeros (the map's bounds) and are never
//   stored. TMA counts a box's bytes whole, zero-filled or not.
// - The weight: wgmma reads B K-major, and w [k·C, C'] is N-major, so the
//   wrapper writes it once a call as wt [C', k·C] in bf16: the cast it did
//   already, as one strided copy (1.5 MB at C = C' = 512), no extra launch.
//   Its map is [C', k·C]; columns past C' come back as zeros and are not
//   stored.
// - The tensor maps are built on the host every call
//   (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint: the
//   link stays the runtime's, no -lcuda) and passed as __grid_constant__
//   parameters.
// - Persistent: one CTA an SM (the wrapper passes the count), each walking
//   tiles blockIdx.x, + gridDim.x, … in the order (batch row, M tile, N
//   tile) with N fastest: the N tiles of one M tile run side by side, so
//   A's rows come from L2 the second time. No split-K (K = 1,536 or
//   1,024 against M in the hundreds of thousands): each output has one
//   owner and one summation order, so two calls give the same bits.
// - Epilogue: the GELU in f32, one rounding, staged 64 columns at a time
//   through each consumer warpgroup's own shared memory (rows 144 bytes
//   apart, so a quad's 8 rows fall on distinct banks) and stored as 16-byte
//   chunks, a warp writing whole 128-byte rows; rows ≥ out_len and columns
//   ≥ C' are never stored. It does not overlap the products (both
//   consumer warpgroups finish a tile together, and a second accumulator
//   set does not fit their registers): at B=64 L=15999 on an H100 the GELU
//   still costs 0.25–0.30 of 1.36 ms (PERF.md §6).
#include "gemm_bf16.cuh"

namespace {

constexpr int CBM = 128;                              // output rows a tile: two consumer warpgroups of 64
constexpr int CBN = 256;                              // output columns a tile
constexpr int CBK = 64;                               // k a stage: 64 bf16, one 128-byte swizzle row
constexpr int CSTAGES = 4;                            // the ring
constexpr int CTHREADS = 384;                         // the producer's warpgroup, then two consumers
constexpr int CA_BYTES = CBM * CBK * 2;               // A's box: 16 KB
constexpr int CB_BYTES = CBN * CBK * 2;               // B's box: 32 KB
constexpr int CSTAGE_BYTES = CA_BYTES + CB_BYTES;
constexpr int CEPI_COLS = 64;                         // columns a consumer stages at a time
constexpr int CEPI_LD = CEPI_COLS * 2 + 16;           // bytes a staged row
constexpr int CEPI_BYTES = 64 * CEPI_LD;              // one consumer warpgroup's staging
constexpr int CONV_SMEM = 1024 + CSTAGES * CSTAGE_BYTES + 2 * CEPI_BYTES + 2 * CSTAGES * 8;
static_assert(CONV_SMEM <= 232448, "a block's shared memory on an H100");

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) d[r] = 0.f;
}

__global__ void __launch_bounds__(CTHREADS, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap tap0, const __grid_constant__ CUtensorMap tap1,
                  const __grid_constant__ CUtensorMap tap2, const __grid_constant__ CUtensorMap wmap,
                  bf16* __restrict__ out, int out_len, int N, int C, int k, int m_tiles, int n_tiles, int tiles,
                  int gelu) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem;
  const uint32_t sbase = wg_smem(smem_raw, smem);  // the ring, 1024-aligned (the swizzle's period)
  uint8_t* epi = smem + CSTAGES * CSTAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 2 * CEPI_BYTES);  // a stage has landed
  uint64_t* empty = full + CSTAGES;                                    // both consumers are done with it
  const int tid = threadIdx.x, wg = tid >> 7;
  const int kpt = C / CBK, nk = k * kpt;  // k-tiles a tap, and a tile
  if (tid == 0) {
    for (int s = 0; s < CSTAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival, with the stage's bytes
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // the producer: one thread issues every load
    regs_dec<40>();
    if (tid == 0) {
      tma_prefetch_map(&tap0);
      tma_prefetch_map(&tap1);
      if (k == 3) tma_prefetch_map(&tap2);
      tma_prefetch_map(&wmap);
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int nt = tile % n_tiles, mt = (tile / n_tiles) % m_tiles, b = tile / n_tiles / m_tiles;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);  // the first pass finds every stage free
          uint8_t* st = smem + stage * CSTAGE_BYTES;
          mbar_arrive_expect_tx(&full[stage], CSTAGE_BYTES);
          const int t = kt / kpt;
          tma_load_3d(st, t == 0 ? &tap0 : t == 1 ? &tap1 : &tap2, &full[stage], (kt % kpt) * CBK, mt * CBM, b);
          tma_load_2d(st + CA_BYTES, &wmap, &full[stage], kt * CBK, nt * CBN);
          if (++stage == CSTAGES) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64·cw … 64·cw + 63 of each tile
  regs_inc<232>();
  const int cw = wg - 1, ctid = tid & 127, warp = ctid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  uint8_t* stg = epi + cw * CEPI_BYTES;
  float acc[CBN / 2];
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int nt = tile % n_tiles, mt = (tile / n_tiles) % m_tiles, b = tile / n_tiles / m_tiles;
    zero(acc);
    int held = -1;  // the stage the group in flight reads
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&full[stage], phase);
      const uint32_t sa = sbase + stage * CSTAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CBK / 16; ++kk)  // k16 steps of 32 bytes inside the swizzle row
        wgmma_bf16(acc, wg_desc(sa + cw * 64 * 128 + kk * 32), wg_desc(sa + CA_BYTES + kk * 32));
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-tile's group has completed: its stage is free
      if (held >= 0 && ctid == 0) mbar_arrive(&empty[held]);
      held = stage;
      if (++stage == CSTAGES) stage = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    if (ctid == 0) mbar_arrive(&empty[held]);
    fence_regs(acc);

    // the epilogue: accumulator 4j + 2h + e holds row 16·warp + g + 8h of
    // the warpgroup's 64, column 8j + 2·tig + e of the tile
    const int row0 = mt * CBM + cw * 64;
    bf16* ob = out + (size_t)b * out_len * N;
#pragma unroll
    for (int q = 0; q < CBN / CEPI_COLS; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
#pragma unroll
        for (int jj = 0; jj < CEPI_COLS / 8; ++jj) {
          const int j = q * (CEPI_COLS / 8) + jj;
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (gelu) v0 = gelu_to_bf16(v0), v1 = gelu_to_bf16(v1);
          store2(reinterpret_cast<bf16*>(stg + r * CEPI_LD) + jj * 8 + 2 * tig, v0, v1);
        }
      }
      named_sync(1 + cw, 128);
#pragma unroll
      for (int it = 0; it < 64 * (CEPI_COLS / 8) / 128; ++it) {
        const int i = ctid + it * 128, r = i / (CEPI_COLS / 8), c = i % (CEPI_COLS / 8);
        const int row = row0 + r, col = nt * CBN + q * CEPI_COLS + c * 8;
        if (row < out_len && col < N)
          *reinterpret_cast<uint4*>(ob + (size_t)row * N + col) = *reinterpret_cast<const uint4*>(stg + r * CEPI_LD + c * 16);
      }
      named_sync(1 + cw, 128);  // the staging is read before the next quarter overwrites it
    }
  }
}

// cuTensorMapEncodeTiled, a driver call, through the runtime's entry point
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 tensor map in the 128-byte swizzle: dims and box innermost first,
// strides (bytes) of the outer dims; elements past the dims read as zeros
bool bf16_map(CUtensorMap* map, EncodeTiled encode, const void* base, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x [B, L, C], wt [C', k·C] (the weight [k, C, C'] transposed), out
// [B, (L − k)/2 + 1, C'], all contiguous bf16; k ∈ {2, 3}, C and C'
// multiples of 128, L ≥ k; gelu ≠ 0 for the A&S GELU; ctas: the persistent
// grid (one CTA an SM; fewer where there are fewer tiles).
extern "C" int msa_conv_stride2(const void* x, const void* wt, void* out, int B, int L, int C, int N, int k, int gelu,
                                int ctas, void* stream) {
  if ((k != 2 && k != 3) || C % 128 || N % 128 || L < k || B < 1 || ctas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int out_len = (L - k) / 2 + 1, K = k * C;
  auto xb = static_cast<const bf16*>(x);
  CUtensorMap maps[4];
  // tap t: [B, out_len, C] over x + t·C, rows 2C apart
  const cuuint64_t adims[3] = {(cuuint64_t)C, (cuuint64_t)out_len, (cuuint64_t)B};
  const cuuint64_t astrides[2] = {(cuuint64_t)C * 4, (cuuint64_t)L * C * 2};
  const cuuint32_t abox[3] = {CBK, CBM, 1};
  for (int t = 0; t < 3; ++t)
    if (!bf16_map(&maps[t], encode, xb + (size_t)(t < k ? t : 0) * C, 3, adims, astrides, abox))
      return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t wdims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t wstrides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t wbox[2] = {CBK, CBN};
  if (!bf16_map(&maps[3], encode, wt, 2, wdims, wstrides, wbox)) return static_cast<int>(cudaErrorInvalidValue);
  static unsigned attr_set = 0;  // one bit per device: shared memory above 48 KB is opted into once
  cudaError_t e = wg_smem_attr(conv_wgmma_kernel, CONV_SMEM, attr_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int m_tiles = (out_len + CBM - 1) / CBM, n_tiles = (N + CBN - 1) / CBN, tiles = B * m_tiles * n_tiles;
  conv_wgmma_kernel<<<ctas < tiles ? ctas : tiles, CTHREADS, CONV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<bf16*>(out), out_len, N, C, k, m_tiles, n_tiles, tiles, gelu);
  return static_cast<int>(cudaGetLastError());
}
