// Blockwise int8 quantization for the F1 in-network transport, on Hopper.
//
// Three kernels, each the port of a Pallas TPU kernel of
// repro/kernels/quant.py.  Every rounding is explicit (__fmul_rn,
// __fdiv_rn, __fmaf_rn, __fsub_rn, rintf), so -fmad cannot change the
// bits: they are the bits XLA computes for the JAX package's jitted code,
// which contracts what its source says literally --
//   * the scale max|x| / 127 is max|x| * fl32(1/127);
//   * the fold acc = q0*s0; acc = acc + qi*si is fma(q0, s0, q1*s1), then
//     fma(qi, si, acc) for every further child;
//   * the error-feedback residual v - q*s (fp32) is fma(-q, s, v).
//
// quantize_kernel -- replaces quant.py:39 quantize (pallas_call at :52).
//   Rows of nb * qblock elements (f32, bf16 or f16, read as fp32; a row
//   stride, so a sliced view needs no copy) -> int8 of the same shape and
//   one fp32 scale per block, laid out contiguously.  Per block:
//   amax = max|x| with NaN kept (fmaxf would drop it; jnp.max keeps it),
//   scale = max(amax * fl32(1/127), 1e-30) with NaN kept,
//   q = clamp(rint(x / scale), -127, 127), a true IEEE division, ties to
//   even.  One warp per block, qblock / 32 elements a lane held in
//   registers, the max by shuffles.  Bound by memory: it reads n *
//   itemsize bytes and writes n + 4 n / qblock.
//
// dequantize_kernel -- replaces quant.py:159 dequantize (:171).
//   out = cast_rn(q * s) to f32, bf16 or f16.  With a minuend v of the
//   output type it returns the error-feedback residual instead: fp32
//   fma(-q, s, v); for bf16 and f16, v - cast(q * s) in fp32, rounded
//   once (the cast stands between the product and the difference, so XLA
//   does not contract it).  v may be the output itself: each thread reads
//   its elements before it writes them.  Each thread takes 16 elements,
//   four at a time, so that a warp's loads and stores are contiguous.
//   Bound by memory: n + 4 n / qblock bytes in, n * itemsize out
//   (and n * itemsize more in for v).
//
// dequant_accum_kernel -- replaces quant.py:126 dequant_accum_slots (:148)
//   and, as its reshape with one block a slot, quant.py:79 dequant_accum
//   (:99).  A (G, P, S, E) int8 stack with (G, P, S, E / qblock) fp32
//   scales -> (G, S, E) fp32: the P children fold in stack order,
//   q0*s0 for one child, else fma(q0, s0, q1*s1) and then fma(qi, si,
//   acc), P any fan-in in a runtime loop.  The wire order (the int8
//   wire protocol's reduce-scatter, jnp.sum of the dequantized stack,
//   which XLA contracts differently) is acc = q0*s0, then fma(qi, si,
//   acc) for i = 1 .. P-1.  Each (S, E) block is
//   contiguous, the G and P strides are free, so a stack gathered along a
//   rank axis, and the multi design's strided q[j::n_bufs], are views.
//   Each thread folds 16 contiguous elements, one 16-byte load a child,
//   inside one scale block because qblock % 16 == 0; the fp32 results
//   are staged in shared memory so that a warp's stores are contiguous.
//   Bound by memory: G P S E + 4 G P S E / qblock bytes in, 4 G S E out.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInt8Max = 127.0f;
// fl32(1/127) and fl32(1e-30), exactly as numpy and XLA round them
constexpr float kInvInt8Max = 1.0f / 127.0f;
constexpr float kScaleFloor = 1e-30f;

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float to(float v) { return v; }
  static __device__ __forceinline__ float from(float a) { return a; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from(float a) { return __float2bfloat16_rn(a); }
};
template <> struct Cvt<__half> {
  static __device__ __forceinline__ float to(__half v) { return __half2float(v); }
  static __device__ __forceinline__ __half from(float a) { return __float2half_rn(a); }
};

// max that keeps a NaN from either side, as jnp.max / jnp.maximum do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// N elements of T at p as fp32; VEC: 16-byte loads (p and N * sizeof(T)
// 16-byte aligned), else one element at a time.
template <typename T, int N, bool VEC>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float* out) {
  if constexpr (VEC) {
    constexpr int kPer = 16 / sizeof(T);
    static_assert(N % kPer == 0, "vector load needs whole 16-byte chunks");
#pragma unroll
    for (int k = 0; k < N; k += kPer) {
      alignas(16) T tmp[kPer];
      *reinterpret_cast<uint4*>(tmp) = __ldg(reinterpret_cast<const uint4*>(p + k));
#pragma unroll
      for (int j = 0; j < kPer; ++j) out[k + j] = Cvt<T>::to(tmp[j]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = Cvt<T>::to(p[k]);
  }
}

// N int8 values at p, N a power of two: stored in the widest naturally
// aligned word (the output is contiguous and the offset a multiple of N).
template <int N>
__device__ __forceinline__ void store_i8(int8_t* p, const int8_t* v) {
  if constexpr (N >= 16) {
#pragma unroll
    for (int k = 0; k < N; k += 16)
      *reinterpret_cast<uint4*>(p + k) = *reinterpret_cast<const uint4*>(v + k);
  } else if constexpr (N == 8) {
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(v);
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint32_t*>(p) = *reinterpret_cast<const uint32_t*>(v);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = v[k];
  }
}

// ---------------------------------------------------------------------------
// quantize
// ---------------------------------------------------------------------------

template <typename T, int VPL, bool VEC>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, long long nblocks,
                long long nb_per_row, long long row_stride) {
  constexpr int kQblock = 32 * VPL;
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (b >= nblocks) return;  // whole warps leave together
  const long long row = b / nb_per_row;
  const T* src = x + row * row_stride + (b - row * nb_per_row) * kQblock + lane * VPL;
  float v[VPL];
  load_f32<T, VPL, VEC>(src, v);
  float amax = fabsf(v[0]);
#pragma unroll
  for (int k = 1; k < VPL; ++k) amax = nan_max(amax, fabsf(v[k]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = nan_max(__fmul_rn(amax, kInvInt8Max), kScaleFloor);
  alignas(16) int8_t out[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const float r = rintf(__fdiv_rn(v[k], scale));
    out[k] = static_cast<int8_t>(__float2int_rn(fminf(fmaxf(r, -kInt8Max), kInt8Max)));
  }
  store_i8<VPL>(q + b * kQblock + lane * VPL, out);
  if (lane == 0) scales[b] = scale;
}

template <typename T, int VPL>
cudaError_t launch_quantize(const void* x, void* q, void* s, long long nblocks,
                            long long nb_per_row, long long row_stride,
                            cudaStream_t stream) {
  constexpr bool kCanVec = (VPL * sizeof(T)) % 16 == 0;
  const bool vec = kCanVec && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (row_stride * static_cast<long long>(sizeof(T))) % 16 == 0;
  const long long grid = (nblocks + kThreads / 32 - 1) / (kThreads / 32);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st = static_cast<float*>(s);
  if constexpr (kCanVec) {
    if (vec) {
      quantize_kernel<T, VPL, true><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
          xt, qt, st, nblocks, nb_per_row, row_stride);
      return cudaGetLastError();
    }
  }
  quantize_kernel<T, VPL, false><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      xt, qt, st, nblocks, nb_per_row, row_stride);
  return cudaGetLastError();
}

template <typename T>
cudaError_t quantize_t(const void* x, void* q, void* s, int qblock, long long nblocks,
                       long long nb_per_row, long long row_stride, cudaStream_t st) {
  switch (qblock) {
    case 32: return launch_quantize<T, 1>(x, q, s, nblocks, nb_per_row, row_stride, st);
    case 64: return launch_quantize<T, 2>(x, q, s, nblocks, nb_per_row, row_stride, st);
    case 128: return launch_quantize<T, 4>(x, q, s, nblocks, nb_per_row, row_stride, st);
    case 256: return launch_quantize<T, 8>(x, q, s, nblocks, nb_per_row, row_stride, st);
    case 512: return launch_quantize<T, 16>(x, q, s, nblocks, nb_per_row, row_stride, st);
    case 1024: return launch_quantize<T, 32>(x, q, s, nblocks, nb_per_row, row_stride, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// dequantize (and the fused error-feedback residual), dequant-accumulate
//
// Both give each thread kElems elements.  dequantize takes them in
// kElems / kVec rounds of kVec: in each round the block's chunks lie side
// by side, so every load and store of a warp covers one contiguous span
// (a 4-byte int8 load, a 16-byte fp32 store a thread).  The kVec
// elements of a chunk share one scale because qblock % 16 == 0.
// ---------------------------------------------------------------------------

constexpr int kElems = 16;  // elements a thread
constexpr int kVec = 4;     // elements a load or store
constexpr int kRounds = kElems / kVec;

template <bool VEC>
__device__ __forceinline__ void load_i8x4(const int8_t* __restrict__ p, float* out) {
  alignas(4) int8_t tmp[kVec];
  if constexpr (VEC) {
    *reinterpret_cast<uint32_t*>(tmp) = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) tmp[k] = p[k];
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) out[k] = static_cast<float>(tmp[k]);
}

// kVec elements of T at p; VEC: one aligned load or store of kVec * sizeof(T)
// bytes (16 for fp32, 8 for bf16 and f16).
template <typename T, bool VEC>
__device__ __forceinline__ void load_x4(const T* p, float* out) {
  alignas(16) T tmp[kVec];
  if constexpr (VEC && sizeof(T) == 4) {
    *reinterpret_cast<uint4*>(tmp) = *reinterpret_cast<const uint4*>(p);
  } else if constexpr (VEC) {
    *reinterpret_cast<uint2*>(tmp) = *reinterpret_cast<const uint2*>(p);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) tmp[k] = p[k];
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) out[k] = Cvt<T>::to(tmp[k]);
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_x4(T* p, const float* v) {
  alignas(16) T tmp[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) tmp[k] = Cvt<T>::from(v[k]);
  if constexpr (VEC && sizeof(T) == 4) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(tmp);
  } else if constexpr (VEC) {
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(tmp);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) p[k] = tmp[k];
  }
}

template <typename T, bool RESIDUAL>
__device__ __forceinline__ float dequant_elem(float qf, float s, float v) {
  if constexpr (!RESIDUAL) {
    return __fmul_rn(qf, s);
  } else if constexpr (sizeof(T) == 4) {
    return __fmaf_rn(-qf, s, v);
  } else {
    const float d = Cvt<T>::to(Cvt<T>::from(__fmul_rn(qf, s)));
    return __fsub_rn(v, d);
  }
}

template <typename T, bool RESIDUAL, bool VEC>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                  const T* v, T* out, long long n, int qblock) {
  const long long base = static_cast<long long>(blockIdx.x) * kThreads * kElems;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + (static_cast<long long>(r) * kThreads + threadIdx.x) * kVec;
    if (i >= n) break;
    float qv[kVec], vv[kVec], res[kVec];
    load_i8x4<VEC>(q + i, qv);
    // v is not read through the read-only path: it may be the output
    if constexpr (RESIDUAL) load_x4<T, VEC>(v + i, vv);
    const float s = __ldg(scales + i / qblock);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      res[k] = dequant_elem<T, RESIDUAL>(qv[k], s, RESIDUAL ? vv[k] : 0.0f);
    store_x4<T, VEC>(out + i, res);
  }
}

template <typename T>
cudaError_t dequantize_t(const void* q, const void* s, const void* v, void* out,
                         long long n, int qblock, cudaStream_t stream) {
  const bool vec = reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   (v == nullptr || reinterpret_cast<uintptr_t>(v) % 16 == 0);
  const long long per_block = static_cast<long long>(kThreads) * kElems;
  const long long grid = (n + per_block - 1) / per_block;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int8_t* qt = static_cast<const int8_t*>(q);
  const float* st = static_cast<const float*>(s);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  const unsigned g = static_cast<unsigned>(grid);
  if (v != nullptr) {
    if (vec) dequantize_kernel<T, true, true><<<g, kThreads, 0, stream>>>(qt, st, vt, ot, n, qblock);
    else dequantize_kernel<T, true, false><<<g, kThreads, 0, stream>>>(qt, st, vt, ot, n, qblock);
  } else {
    if (vec) dequantize_kernel<T, false, true><<<g, kThreads, 0, stream>>>(qt, st, vt, ot, n, qblock);
    else dequantize_kernel<T, false, false><<<g, kThreads, 0, stream>>>(qt, st, vt, ot, n, qblock);
  }
  return cudaGetLastError();
}

// One 16-byte load of int8 a child.
template <bool VEC>
__device__ __forceinline__ void load_i8x16(const int8_t* __restrict__ p, float* out) {
  alignas(16) int8_t tmp[kElems];
  if constexpr (VEC) {
    *reinterpret_cast<uint4*>(tmp) = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int k = 0; k < kElems; ++k) tmp[k] = p[k];
  }
#pragma unroll
  for (int k = 0; k < kElems; ++k) out[k] = static_cast<float>(tmp[k]);
}

// The fold.  Each thread owns 16 contiguous elements and reads them with
// one 16-byte load a child (a warp reads 512 contiguous bytes).  Its 64
// bytes of fp32 output go out through a per-warp stage in shared memory,
// so that each of the warp's four stores covers 512 contiguous bytes.
template <bool VEC, bool WIRE>
__global__ void __launch_bounds__(kThreads)
dequant_accum_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                     float* __restrict__ out, int p, long long g_count, long long len,
                     int qblock, long long q_stride_g, long long q_stride_p,
                     long long s_stride_g, long long s_stride_p) {
  __shared__ float4 stage[kThreads / 32][32 * kRounds];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long warp0 = (static_cast<long long>(blockIdx.x) * kThreads + warp * 32) * kElems;
  if (warp0 >= len) return;  // whole warps leave together
  const long long i0 = warp0 + lane * kElems;
  const bool active = i0 < len;  // len % 16 == 0: a thread is all in or out
  const long long si = i0 / qblock;
  for (long long g = blockIdx.y; g < g_count; g += gridDim.y) {
    float acc[kElems], qv[kElems];
    if (active) {
      const int8_t* qg = q + g * q_stride_g + i0;
      const float* sg = scales + g * s_stride_g + si;
      load_i8x16<VEC>(qg, acc);
      const float s0 = __ldg(sg);
      if (p == 1 || WIRE) {
#pragma unroll
        for (int k = 0; k < kElems; ++k) acc[k] = __fmul_rn(acc[k], s0);
        for (int c = 1; c < p; ++c) {
          load_i8x16<VEC>(qg + c * q_stride_p, qv);
          const float sc = __ldg(sg + c * s_stride_p);
#pragma unroll
          for (int k = 0; k < kElems; ++k) acc[k] = __fmaf_rn(qv[k], sc, acc[k]);
        }
      } else {
        load_i8x16<VEC>(qg + q_stride_p, qv);
        const float s1 = __ldg(sg + s_stride_p);
#pragma unroll
        for (int k = 0; k < kElems; ++k) acc[k] = __fmaf_rn(acc[k], s0, __fmul_rn(qv[k], s1));
        for (int c = 2; c < p; ++c) {
          load_i8x16<VEC>(qg + c * q_stride_p, qv);
          const float sc = __ldg(sg + c * s_stride_p);
#pragma unroll
          for (int k = 0; k < kElems; ++k) acc[k] = __fmaf_rn(qv[k], sc, acc[k]);
        }
      }
    }
    float* og = out + g * len;
    if constexpr (VEC) {
      // float4 m of the warp's span is element warp0 + 4 m
      if (active) {
#pragma unroll
        for (int r = 0; r < kRounds; ++r)
          stage[warp][lane * kRounds + r] =
              make_float4(acc[4 * r], acc[4 * r + 1], acc[4 * r + 2], acc[4 * r + 3]);
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const int m = r * 32 + lane;
        if (warp0 + 4LL * m < len)
          reinterpret_cast<float4*>(og + warp0)[m] = stage[warp][m];
      }
      __syncwarp();
    } else if (active) {
#pragma unroll
      for (int k = 0; k < kElems; ++k) og[i0 + k] = acc[k];
    }
  }
}

}  // namespace

// Every entry point returns the launch's cudaError_t (0 on success); the
// kernels do not synchronise and allocate nothing.  dtype: 0 float32,
// 1 bfloat16, 2 float16.  Strides are in elements.

// x: rows of nb_per_row * qblock elements, row_stride apart; q and scales
// contiguous, nblocks = rows * nb_per_row.  qblock: 32, 64, ..., 1024.
extern "C" int quantize(const void* x, void* q, void* scales, int dtype, int qblock,
                        long long nblocks, long long nb_per_row, long long row_stride,
                        void* stream) {
  if (nblocks < 1 || nb_per_row < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = quantize_t<float>(x, q, scales, qblock, nblocks, nb_per_row, row_stride, s); break;
    case 1: err = quantize_t<__nv_bfloat16>(x, q, scales, qblock, nblocks, nb_per_row, row_stride, s); break;
    case 2: err = quantize_t<__half>(x, q, scales, qblock, nblocks, nb_per_row, row_stride, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// q, scales, minuend and out contiguous, n elements; minuend may be null
// (plain dequantize) or equal to out (the residual in place).
// qblock % 16 == 0 and n % qblock == 0.
extern "C" int dequantize(const void* q, const void* scales, const void* minuend, void* out,
                          int dtype, int qblock, long long n, void* stream) {
  if (n < 1 || qblock < 16 || qblock % 16 || n % qblock)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = dequantize_t<float>(q, scales, minuend, out, n, qblock, s); break;
    case 1: err = dequantize_t<__nv_bfloat16>(q, scales, minuend, out, n, qblock, s); break;
    case 2: err = dequantize_t<__half>(q, scales, minuend, out, n, qblock, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// q (G, P, len) int8 and scales (G, P, len / qblock) fp32 with free G and
// P strides and contiguous rows; out (G, len) fp32 contiguous.
// qblock % 16 == 0 and len % qblock == 0.  wire_order: 0 the switch's
// contraction, 1 the wire protocol's.
extern "C" int dequant_accum_slots(const void* q, const void* scales, void* out, int p,
                                   long long g, long long len, int qblock,
                                   long long q_stride_g, long long q_stride_p,
                                   long long s_stride_g, long long s_stride_p, int wire_order,
                                   void* stream) {
  if (p < 1 || g < 1 || len < 1 || qblock < 16 || qblock % 16 || len % qblock)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   q_stride_g % 16 == 0 && q_stride_p % 16 == 0;
  const long long per_block = static_cast<long long>(kThreads) * kElems;
  const long long blocks = (len + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(g < 65535 ? g : 65535));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qt = static_cast<const int8_t*>(q);
  const float* st = static_cast<const float*>(scales);
  float* ot = static_cast<float*>(out);
  void (*kernel)(const int8_t*, const float*, float*, int, long long, long long, int, long long,
                 long long, long long, long long);
  if (vec) kernel = wire_order ? dequant_accum_kernel<true, true> : dequant_accum_kernel<true, false>;
  else kernel = wire_order ? dequant_accum_kernel<false, true> : dequant_accum_kernel<false, false>;
  kernel<<<grid, kThreads, 0, s>>>(qt, st, ot, p, g, len, qblock, q_stride_g, q_stride_p,
                                   s_stride_g, s_stride_p);
  return static_cast<int>(cudaGetLastError());
}
