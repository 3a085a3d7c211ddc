// Fixed-tree reduction of stacked partials on Hopper (paper §6.3).
//
// Replaces the Pallas TPU kernels repro/kernels/tree_reduce.py::
// tree_reduce_slots (pallas_call at :101) and ::tree_reduce (:56): the
// fold the reproducible (F3) switch runs on every level of the reduction
// tree.  Computes (G, P, L) -> (G, L): for each of G groups, the P child
// rows are combined in the aligned binary tree -- pairs (2i, 2i+1) first,
// then pairs of pairs, log2 P levels -- so the combine order is a pure
// function of the child index.  Floats (f32, bf16, f16) accumulate in
// fp32 and are cast back with round-to-nearest-even; int32 accumulates
// natively in unsigned arithmetic, so overflow wraps as in XLA.  The 2-D
// tree_reduce is the case G = 1 with the whole row as L.
//
// What bounds it: memory.  It reads each input element once and writes
// each output element once, (P + 1) * G * L * itemsize bytes, with P - 1
// adds per output element; at the H100's 3.35 TB/s that is the bound.
// Design: each thread owns VEC contiguous elements (16-byte loads and
// stores when every row is 16-byte aligned, scalar loads otherwise) and
// runs the whole tree in registers.  The tree is walked as a binary
// counter -- child c is added to the partial sums held for the set low
// bits of c -- which is exactly the aligned tree, operand order
// included, but holds log2 P partials per element instead of P.  P is a
// template parameter (1, 2, 4, ..., 64), so every loop unrolls.  Rows
// sit at x + g * stride_g + p * stride_p, so a stack gathered along a
// non-leading rank axis is folded in place, without a copy.  Only adds
// appear, so there is no multiply-add to contract; __fadd_rn makes the
// rounding explicit all the same.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct Acc;

template <> struct Acc<float> {
  using A = float;
  static __device__ __forceinline__ A load(float v) { return v; }
  static __device__ __forceinline__ float store(A a) { return a; }
  static __device__ __forceinline__ A add(A x, A y) { return __fadd_rn(x, y); }
};

template <> struct Acc<__nv_bfloat16> {
  using A = float;
  static __device__ __forceinline__ A load(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 store(A a) { return __float2bfloat16_rn(a); }
  static __device__ __forceinline__ A add(A x, A y) { return __fadd_rn(x, y); }
};

template <> struct Acc<__half> {
  using A = float;
  static __device__ __forceinline__ A load(__half v) { return __half2float(v); }
  static __device__ __forceinline__ __half store(A a) { return __float2half_rn(a); }
  static __device__ __forceinline__ A add(A x, A y) { return __fadd_rn(x, y); }
};

template <> struct Acc<int32_t> {
  using A = uint32_t;
  static __device__ __forceinline__ A load(int32_t v) { return static_cast<uint32_t>(v); }
  static __device__ __forceinline__ int32_t store(A a) { return static_cast<int32_t>(a); }
  static __device__ __forceinline__ A add(A x, A y) { return x + y; }
};

__host__ __device__ constexpr int log2i(int p) { return p <= 1 ? 0 : 1 + log2i(p / 2); }

constexpr int kThreads = 256;

// One thread: VEC elements starting at i0 of every row of group g.
// `full` is false only on the ragged tail of a row.
template <typename T, int P, int VEC, bool VECTOR>
__device__ __forceinline__ void fold_elems(const T* __restrict__ xg,
                                           T* __restrict__ og,
                                           long long i0, long long len,
                                           long long stride_p, bool full) {
  using A = typename Acc<T>::A;
  constexpr int LOG2P = log2i(P);
  A part[LOG2P > 0 ? LOG2P : 1][VEC];
  A v[VEC];
#pragma unroll
  for (int c = 0; c < P; ++c) {
    const T* row = xg + c * stride_p + i0;
    alignas(16) T tmp[VEC];
    if (VECTOR && full) {
      *reinterpret_cast<uint4*>(tmp) = __ldg(reinterpret_cast<const uint4*>(row));
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) tmp[k] = row[(i0 + k < len) ? k : 0];
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = Acc<T>::load(tmp[k]);
    // binary counter: combine with the partial of every set low bit
#pragma unroll
    for (int l = 0; l < LOG2P; ++l) {
      if ((c >> l) & 1) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = Acc<T>::add(part[l][k], v[k]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) part[l][k] = v[k];
        break;
      }
    }
  }
  alignas(16) T res[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) res[k] = Acc<T>::store(v[k]);
  if (VECTOR && full) {
    *reinterpret_cast<uint4*>(og + i0) = *reinterpret_cast<const uint4*>(res);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (i0 + k < len) og[i0 + k] = res[k];
  }
}

template <typename T, int P, int VEC, bool VECTOR>
__global__ void __launch_bounds__(kThreads)
tree_reduce_kernel(const T* __restrict__ x, T* __restrict__ out, long long g_count,
                   long long len, long long stride_g, long long stride_p) {
  const long long i0 = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  if (i0 >= len) return;
  const bool full = i0 + VEC <= len;
  for (long long g = blockIdx.y; g < g_count; g += gridDim.y) {
    fold_elems<T, P, VEC, VECTOR>(x + g * stride_g, out + g * len, i0, len, stride_p, full);
  }
}

template <typename T, int P>
cudaError_t launch_p(const void* x, void* out, long long g, long long len,
                     long long stride_g, long long stride_p, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const uintptr_t bx = reinterpret_cast<uintptr_t>(x);
  const uintptr_t bo = reinterpret_cast<uintptr_t>(out);
  const bool vector = bx % 16 == 0 && bo % 16 == 0 &&
                      (stride_g * (long long)sizeof(T)) % 16 == 0 &&
                      (stride_p * (long long)sizeof(T)) % 16 == 0 &&
                      (len * (long long)sizeof(T)) % 16 == 0;
  const int vec = vector ? VEC : 1;
  const long long per_block = static_cast<long long>(kThreads) * vec;
  const long long blocks = (len + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(g < 65535 ? g : 65535));
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vector) {
    tree_reduce_kernel<T, P, VEC, true><<<grid, kThreads, 0, stream>>>(xt, ot, g, len, stride_g, stride_p);
  } else {
    tree_reduce_kernel<T, P, 1, false><<<grid, kThreads, 0, stream>>>(xt, ot, g, len, stride_g, stride_p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* x, void* out, int p, long long g, long long len,
                     long long stride_g, long long stride_p, cudaStream_t s) {
  switch (p) {
    case 1: return launch_p<T, 1>(x, out, g, len, stride_g, stride_p, s);
    case 2: return launch_p<T, 2>(x, out, g, len, stride_g, stride_p, s);
    case 4: return launch_p<T, 4>(x, out, g, len, stride_g, stride_p, s);
    case 8: return launch_p<T, 8>(x, out, g, len, stride_g, stride_p, s);
    case 16: return launch_p<T, 16>(x, out, g, len, stride_g, stride_p, s);
    case 32: return launch_p<T, 32>(x, out, g, len, stride_g, stride_p, s);
    case 64: return launch_p<T, 64>(x, out, g, len, stride_g, stride_p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16, 3 int32.  Strides in elements.
// Returns the launch's cudaError_t (0 on success); the kernel does not
// synchronise and allocates nothing.
extern "C" int tree_reduce_slots(const void* x, void* out, int dtype, int p,
                                 long long g, long long len, long long stride_g,
                                 long long stride_p, void* stream) {
  if (g < 1 || len < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_t<float>(x, out, p, g, len, stride_g, stride_p, s); break;
    case 1: err = launch_t<__nv_bfloat16>(x, out, p, g, len, stride_g, stride_p, s); break;
    case 2: err = launch_t<__half>(x, out, p, g, len, stride_g, stride_p, s); break;
    case 3: err = launch_t<int32_t>(x, out, p, g, len, stride_g, stride_p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
