// Row quantization for Hopper: per-row symmetric int8 of a [rows, cols]
// activation, x_i8 = clip(round_half_even(x / scale), ±127) with
// scale = max(max|x|, 1e-8) · f32(1/127), in f32 (the source's "/ 127.0"
// as XLA compiles it under jit, msa_tpu_torch/ops/quant.py says more).
//
// Replaces msa_tpu/ops/quant.py:quantize_rows, which the TPU W8A8 kernels
// run in XLA on their input (attention.py:776, ffn.py:160) and inside the
// kernel on the attention output (attention.py:677) and on the FFN hidden
// tile (ffn.py:126). Codes and scales are bit-equal to the plain version
// msa_tpu_torch/ops/quant.py:quantize_rows: amax is exact, the scale is
// one rounded product (__fmul_rn), x / scale is an IEEE division
// (__fdiv_rn; never x · 127/amax, which moves ties), and
// __float2int_rn rounds half to even as jnp.round does. Build without
// --use_fast_math.
//
// What bounds it on the card: bytes, read once: 2 or 4 per value in, one
// out, and a scale a row. One read that fills the card: a row gets cols / 8
// threads (96 at cols = 768, 128 at 1024, 384 at 3072; a power of two
// below 32 lanes for rows of 128 values or fewer), each holding its 8
// values in registers as loaded (one 16-byte load, two for f32); several
// rows share a block of about 256 threads, so that at 1024 rows of 768
// every SM holds some 23 warps. The row's amax is reduced across its
// lanes by shuffles and across its warps through shared memory, and the
// codes go out from the same registers as 8-byte stores. Where bf16 rows
// are more than the card holds at once (from about 2800 rows of 768), a
// thread holds 3 groups (48 bytes in flight; f32 has 32 with one): at
// 32768 rows of 768 on an H100, 3 groups took 0.0340 ms against 0.0396 at
// one, while f32 was fastest at one. A row has at most 1024 threads: past
// 8192 columns (3·8192 where a thread holds 3 groups; no path of the port
// quantizes rows wider than 3072) the groups beyond those held are read a
// second time to quantize. The kernel it replaced gave a
// row one warp that read it twice, a group of 8 a lane at a time (three
// loads in turn a pass at cols = 768): latency, not bytes, set its time
// on an H100, flat from 128 to 1024 rows of 768 bf16.
//
// In the int8 chains of rows 7 and 9 (attention.cu, ffn.cu) both forms
// run under programmatic dependent launch: each waits (pdl_wait) before it
// reads x, and lets the next kernel start (pdl_trigger) once its loads are
// issued. Launched without the attribute (the first kernel of a chain, a
// direct call) both pass at once.
//
// msa_quantize_rows_amax quantizes the FFN's f32 hidden tile, whose row
// amax the fc_in GEMM's epilogue has already reduced (gemm_s8.cuh, as f32
// bits in int32 [rows]): the same scale and codes, since the amax is the
// same exact max, but no reduction, so it is elementwise: one thread per
// 8 values, every SM busy, one read of the tile. (A warp a row, as above,
// took 0.017 ms on an H100 for the [1024, 3072] tile with the amax given
// or not: too few warps in flight to cover the loads.)
#include "gemm.cuh"

namespace {

constexpr int QBLOCK = 256;  // threads a block aims at: 256 / (threads a row) rows

// the threads the current device holds at once (its SMs times the threads
// an SM holds), read once a device
long long card_threads() {
  static long long held[16] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16) return 0;  // 0: one group a thread
  if (held[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
    held[dev] = static_cast<long long>(sms) * per_sm;
  }
  return held[dev];
}

// n threads rounded up to whole warps, at most cap
inline int warps_of(int n, int cap) {
  const int w = (n + 31) / 32 * 32;
  return w < cap ? w : cap;
}

// the row's scale from its amax: one rounded product by f32(1/127)
__device__ __forceinline__ float row_scale_of(float amax) { return __fmul_rn(fmaxf(amax, 1e-8f), 0x1.020408p-7f); }

// clip(round_half_even(v / s), ±127) of 8 values, stored as 8 bytes. A
// row whose amax is 0 (padding) stores its zeros without dividing: every
// code of it is 0 either way (±0 and NaN convert to 0), and the IEEE
// division takes its slow path on a zero dividend, which held such rows'
// threads long enough to set the kernel's time (on an H100 at bf16 [1024,
// 768] with every 7th row of its second half zero, 3.24 µs against 2.44
// without zero rows). The test is once a row, so other rows pay nothing
// (a test on each value cost them 6-8%). The amax form keeps its body and
// does not test: the FFN's hidden tile, GELU(x·W1 + b1), holds no rows of
// padding.
__device__ __forceinline__ void store_codes(int8_t* q, const float* v, float s, bool zero_row) {
  if (zero_row) {
    *reinterpret_cast<uint2*>(q) = make_uint2(0u, 0u);
    return;
  }
  __align__(8) int8_t out[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = __float2int_rn(__fdiv_rn(v[j], s));
    out[j] = static_cast<int8_t>(max(-127, min(127, k)));
  }
  *reinterpret_cast<uint2*>(q) = *reinterpret_cast<const uint2*>(out);
}

__device__ __forceinline__ float amax8(float amax, const float* v) {
#pragma unroll
  for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
  return amax;
}

// a group of 8 values as it was loaded (16 bytes of bf16, 32 of f32):
// held so, not as floats, it takes 4 registers in bf16
template <typename T>
struct Group;
template <>
struct Group<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { u = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void unpack(float* v) const {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
  }
};
template <>
struct Group<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void unpack(float* v) const {
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
};

// the row's amax from each thread's part: shuffles within an aligned
// tpr-lane segment of the warp (tpr < 32), or each warp's max and then the
// row's over its warps through red (more than one warp)
__device__ __forceinline__ float row_amax(float a, float* red, int tid, int r_in, int tpr) {
  if (tpr < 32) {
    for (int o = tpr >> 1; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    return a;
  }
  a = warp_max(a);
  if (tpr == 32) return a;
  if ((tid & 31) == 0) red[tid >> 5] = a;
  __syncthreads();
  const int w0 = r_in * (tpr >> 5), nw = tpr >> 5;
  a = red[w0];
  for (int w = 1; w < nw; ++w) a = fmaxf(a, red[w0 + w]);
  return a;
}

// rows of cols = 8·groups values; tpr threads a row (a power of two below
// 32, or whole warps), rpb rows a block of rpb·tpr threads, thread t of a
// row holding groups t + i·tpr, i < NG, in registers; groups past them
// (more than NG·1024) are read for the amax and read again to quantize
template <typename T, int NG>
__global__ void __launch_bounds__(1024)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale, int rows, int cols,
                     int tpr, int rpb) {
  __shared__ float red[32];  // each warp's amax (rows of more than one warp)
  const int tid = threadIdx.x, r_in = tid / tpr, t = tid - r_in * tpr, groups = cols >> 3;
  const int row = blockIdx.x * rpb + r_in;
  const bool live = row < rows;
  const T* xr = x + (size_t)row * cols;
  Group<T> v[NG];
  float amax = 0.f, f[8];
  pdl_wait();  // x may be the last kernel's output
#pragma unroll
  for (int i = 0; i < NG; ++i)
    if (live && t + i * tpr < groups) v[i].load(xr + 8 * (t + i * tpr));
  for (int g = t + NG * tpr; live && g < groups; g += tpr) {
    Group<T> w;
    w.load(xr + 8 * g);
    w.unpack(f);
    amax = amax8(amax, f);
  }
  pdl_trigger();  // the block's loads are issued
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    if (live && t + i * tpr < groups) {
      v[i].unpack(f);
      amax = amax8(amax, f);
    }
  }
  amax = row_amax(amax, red, tid, r_in, tpr);
  if (!live) return;
  const float s = row_scale_of(amax);
  const bool zero_row = amax == 0.f;
  if (t == 0) scale[row] = s;
  int8_t* qr = q + (size_t)row * cols;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int g = t + i * tpr;
    if (g < groups) {
      v[i].unpack(f);
      store_codes(qr + 8 * g, f, s, zero_row);
    }
  }
  for (int g = t + NG * tpr; g < groups; g += tpr) {
    Group<T> w;
    w.load(xr + 8 * g);
    w.unpack(f);
    store_codes(qr + 8 * g, f, s, zero_row);
  }
}

__global__ void __launch_bounds__(256)
quantize_rows_amax_kernel(const float* __restrict__ x, const int* __restrict__ amax_bits, int8_t* __restrict__ q,
                          float* __restrict__ scale, int rows, int cols) {
  const int chunks = cols / 8;
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  pdl_wait();  // x and its amax are fc_in's output
  if (i >= (size_t)rows * chunks) return;
  const int row = static_cast<int>(i / chunks), c = static_cast<int>(i % chunks) * 8;
  const float s = row_scale_of(__int_as_float(__ldg(amax_bits + row)));
  if (c == 0) scale[row] = s;
  Group<float> g;
  g.load(x + (size_t)row * cols + c);
  pdl_trigger();
  float v[8];
  g.unpack(v);
  store_codes(q + (size_t)row * cols + c, v, s, false);  // the hidden tile has no rows of padding
}

}  // namespace

// The row quantization of x [rows, cols] (f32, or bf16 when x_is_bf16)
// into q [rows, cols] int8 and scale [rows] f32, with the programmatic-
// serialization attribute where pdl (the int8 chains' second and later
// launches). cols % 8 == 0, x and q 16- and 8-byte aligned. Returns a
// cudaError_t.
int quantize_rows_launch(const void* x, int x_is_bf16, void* q, void* scale, int rows, int cols, cudaStream_t s,
                         bool pdl) {
  if (rows < 0 || cols < 8 || cols % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int groups = cols / 8;
  int tpr = 1, ng = 1;
  if (groups <= 16) {  // a segment of a warp: 1, 2, 4, 8 or 16 lanes
    while (tpr < groups) tpr <<= 1;
  } else {
    tpr = warps_of(groups, 1024);
    const long long held = card_threads();
    if (x_is_bf16 && held > 0 && (long long)rows * tpr > held) {  // more bf16 rows than the card holds at once
      ng = 3;
      tpr = warps_of((groups + 2) / 3, 1024);
    }
  }
  const int rpb = tpr <= QBLOCK ? QBLOCK / tpr : 1;
  const dim3 grid((rows + rpb - 1) / rpb), block(rpb * tpr);
  auto q8 = static_cast<int8_t*>(q);
  auto sc = static_cast<float*>(scale);
  cudaError_t e;
  if (x_is_bf16) {
    auto xb = static_cast<const __nv_bfloat16*>(x);
    e = ng == 1 ? launch_k(pdl, quantize_rows_kernel<__nv_bfloat16, 1>, grid, block, 0, s, xb, q8, sc, rows, cols, tpr, rpb)
                : launch_k(pdl, quantize_rows_kernel<__nv_bfloat16, 3>, grid, block, 0, s, xb, q8, sc, rows, cols, tpr, rpb);
  } else {
    e = launch_k(pdl, quantize_rows_kernel<float, 1>, grid, block, 0, s, static_cast<const float*>(x), q8, sc, rows,
                 cols, tpr, rpb);
  }
  return static_cast<int>(e);
}

// The elementwise form on f32 x with each row's amax given, as above.
int quantize_rows_amax_launch(const void* x, const void* amax, void* q, void* scale, int rows, int cols,
                              cudaStream_t s, bool pdl) {
  if (rows < 0 || cols < 8 || cols % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const dim3 grid(static_cast<unsigned>(((size_t)rows * (cols / 8) + 255) / 256));
  return static_cast<int>(launch_k(pdl, quantize_rows_amax_kernel, grid, dim3(256), 0, s, static_cast<const float*>(x),
                                   static_cast<const int*>(amax), static_cast<int8_t*>(q), static_cast<float*>(scale),
                                   rows, cols));
}

// x [rows, cols] f32, amax [rows] int32 (each row's max |x| as f32 bits),
// q [rows, cols] int8, scale [rows] f32; cols % 8 == 0.
extern "C" int msa_quantize_rows_amax(const void* x, const void* amax, void* q, void* scale, int rows, int cols,
                                      void* stream) {
  return quantize_rows_amax_launch(x, amax, q, scale, rows, cols, static_cast<cudaStream_t>(stream), false);
}

// x [rows, cols] (f32, or bf16 when x_is_bf16), q [rows, cols] int8,
// scale [rows] f32. cols % 8 == 0 and x, q 16- and 8-byte aligned (the
// wrapper checks).
extern "C" int msa_quantize_rows(const void* x, int x_is_bf16, void* q, void* scale, int rows, int cols,
                                 void* stream) {
  return quantize_rows_launch(x, x_is_bf16, q, scale, rows, cols, static_cast<cudaStream_t>(stream), false);
}
