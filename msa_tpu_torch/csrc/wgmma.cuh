// The pieces the port's two wgmma GEMMs share: the int8 GEMM of rows 7 and
// 9 (gemm_s8.cuh) and the bf16 GEMM of rows 8 and 10 (gemm_bf16.cuh).
//
// Both read A [M, K] and W [N, K] K-major (PyTorch's Linear layout) from
// shared memory by descriptor, one warpgroup per 64 rows of the tile, with
// the accumulators in registers. A stage of the ring holds one k-tile of
// 128 bytes of K (128 int8 or 64 bf16 values) for the tile's BM rows of A
// and BN rows of W, written by cp.async in the 128-byte swizzle that the
// descriptors name (16-byte chunk c of row r at chunk c ^ (r % 8)); one
// wgmma step reads 32 bytes of K (k32 for int8, k16 for bf16), so the
// descriptor's start address moves 32 bytes along a swizzle row per step,
// and the same byte layout serves both types. Rows past M and chunks past
// K are zero-filled (src-size 0): any M, and K a multiple of 16 bytes.
//
// The TMA and mbarrier pieces at the end feed the same descriptors from a
// producer warp instead (row 11's convolution, conv_stride2.cu): a TMA
// load in the 128-byte swizzle writes a box of 64 bf16 columns exactly as
// load_k_tile does.
#pragma once

#include <cuda.h>  // CUtensorMap

#include "gemm.cuh"

namespace {

constexpr int WG_BK = 128;  // bytes of K a stage: one 128-byte swizzle row

// a tile of BM × BN through a ring of STAGES k-tiles (the int8 GEMM's
// depth by default: deeper rings, fewer CTAs an SM, ran slower there)
template <int BM, int BN, int STAGES_ = (BM == 64 ? 4 : 3)>
struct WgCfg {
  static constexpr int TILE_M = BM, TILE_N = BN;
  static constexpr int THREADS = 2 * BM;  // one warpgroup per 64 rows
  static constexpr int STAGE_BYTES = (BM + BN) * WG_BK;
  static constexpr int STAGES = STAGES_;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;       // + room to align to 1024 bytes
  static constexpr int NREG = BN / 2;                              // accumulators a thread
};

// wgmma's shared-memory matrix descriptor for a K-major tile of 128-byte
// rows in the 128-byte swizzle: start address, leading byte offset 16
// (unused in this layout), stride 1024 bytes between groups of 8 rows
__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) | (uint64_t{1024 >> 4} << 32) |
         (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }
// cp.async writes through the generic proxy, wgmma reads through the async one
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// keep the compiler from moving reads of the accumulators above the wait
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) asm volatile("" : "+r"(d[r])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) asm volatile("" : "+f"(d[r])::"memory");
}

__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// one k-tile (128 bytes of K from byte k0) of ROWS rows of a K-major
// matrix whose rows are row_bytes apart, from src (the tile's first row),
// into a stage: row r's 16-byte chunk c goes to chunk c ^ (r % 8); rows at
// or past `rows` and chunks at or past row_bytes are zero-filled
template <int ROWS, int NT>
__device__ __forceinline__ void load_k_tile(uint8_t* s, const uint8_t* src, int rows, int row_bytes, int k0, int tid) {
#pragma unroll
  for (int j = 0; j < ROWS * 8 / NT; ++j) {
    const int i = tid + j * NT, r = i >> 3, c = i & 7, kc = k0 + c * 16;
    const bool ok = r < rows && kc < row_bytes;
    cp_async16(s + r * WG_BK + ((c ^ (r & 7)) << 4), src + (ok ? (size_t)r * row_bytes + kc : 0), ok);
  }
}

// The k-loop of one CTA: k-tiles kt0 .. kt0 + nkt - 1 of the tile's rows
// of A (a: its first row, rows_a of them valid) and of W (w: its first
// row, BN valid) through the ring of Cfg::STAGES slots; for each k-tile,
// mma(shared address of the A slot, of the W slot) issues the wgmma steps
// between a fence and a commit. LAG groups stay in flight while the next
// k-tile is waited for (0: each group is waited for before the next
// barrier), so the ring runs STAGES − 1 − LAG k-tiles ahead: a slot is
// refilled only once every warpgroup's group that read it has completed.
// Every thread copies; a CTA barrier and cp.async groups guard the ring.
// W_FIRST (the int8 GEMM, which runs in the int8 chains under programmatic
// dependent launch): the first k-tile of W, constant for the call, is
// copied before pdl_wait, A's after it, in the same group. (All of the
// ring's first k-tiles of W before the wait put them in the first group,
// which the first wgmma then waited for: 3–7% on direct calls below M =
// 512 on an H100.)
template <typename Cfg, int LAG, bool W_FIRST = false, typename Mma>
__device__ __forceinline__ void wg_k_loop(uint8_t* smem, uint32_t sbase, const uint8_t* a, int rows_a,
                                          const uint8_t* w, int row_bytes, int kt0, int nkt, int tid, Mma mma) {
  constexpr int BM = Cfg::TILE_M, BN = Cfg::TILE_N, NT = Cfg::THREADS, STAGES = Cfg::STAGES;
  constexpr int AHEAD = STAGES - 1 - LAG;
  static_assert(AHEAD >= 1, "the ring needs a k-tile in flight");
  auto load_a = [&](int slot, int kt) {
    load_k_tile<BM, NT>(smem + slot * Cfg::STAGE_BYTES, a, rows_a, row_bytes, kt * WG_BK, tid);
  };
  auto load_w = [&](int slot, int kt) {
    load_k_tile<BN, NT>(smem + slot * Cfg::STAGE_BYTES + BM * WG_BK, w, BN, row_bytes, kt * WG_BK, tid);
  };
  auto load_stage = [&](int slot, int kt) {
    load_a(slot, kt);
    load_w(slot, kt);
  };
  if constexpr (W_FIRST) {
    if (nkt > 0) load_w(0, kt0);
    pdl_wait();
    if (nkt > 0) load_a(0, kt0);
  } else {
    if (nkt > 0) load_stage(0, kt0);
  }
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < AHEAD; ++s) {
    if (s < nkt) load_stage(s, kt0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < nkt; ++i) {
    cp_async_wait<AHEAD - 1>();  // this thread's copies of k-tile i have landed
    fence_proxy_async();
    __syncthreads();  // everyone's have, and every warpgroup's group i - 1 - LAG has completed
    if (i + AHEAD < nkt) load_stage((i + AHEAD) % STAGES, kt0 + i + AHEAD);
    cp_async_commit();
    const uint32_t sa = sbase + (i % STAGES) * Cfg::STAGE_BYTES;
    wgmma_fence();
    mma(sa, sa + BM * WG_BK);
    wgmma_commit();
    wgmma_wait<LAG>();
  }
  wgmma_wait<0>();
}

// the 1024-aligned start of a kernel's dynamic shared memory (the swizzle
// repeats every 8 rows of 128 bytes, so every stage starts 1024-aligned):
// its shared-window address, and the generic pointer to it
__device__ __forceinline__ uint32_t wg_smem(uint8_t* raw_ptr, uint8_t*& smem) {
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(raw_ptr));
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  smem = raw_ptr + pad;
  return raw + pad;
}

// a GEMM's plan as the planner packs it (msa_tpu_torch/ops/kernels/
// gemm_plan.py): bm | bn << 10 | splits << 20
struct WgPlan {
  int bm, bn, splits;
  explicit WgPlan(int code) : bm(code & 0x3ff), bn((code >> 10) & 0x3ff), splits(code >> 20) {}
};

// opt the kernel into its shared memory above 48 KB, once a device (one
// bit a device in `done`, a static of the calling launcher)
template <typename Kernel>
cudaError_t wg_smem_attr(Kernel kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (done >> dev & 1u)) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done |= 1u << dev;
  return e;
}

// --- TMA and mbarriers (sm_90) ---------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// this thread's arrival, and `bytes` more of transactions the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// until the phase of parity `parity` has completed. A wait that outlasts
// 2^34 cycles (about 9 s) traps: a lost arrival ends the launch with an
// error instead of holding the card.
__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}
// a box of the tensor map `map` (a __grid_constant__ kernel parameter) at
// element coordinates (c0, c1[, c2]), innermost first, into shared memory
// at dst, completing on bar; coordinates past the map's dims read zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// hand registers between warpgroups (every warp of the warpgroup runs it)
template <int N>
__device__ __forceinline__ void regs_dec() { asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N)); }
template <int N>
__device__ __forceinline__ void regs_inc() { asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N)); }
// a barrier of `threads` threads (a warpgroup) on hardware barrier `id` (1–15; 0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace
