// Sparse accumulate and per-block top-k for the §7 sparse transport, on Hopper.
//
// Two functions, each the port of a Pallas TPU kernel.  Every float
// operation is an explicit IEEE one (__fadd_rn, __fmul_rn), so -fmad
// cannot change the bits: they are the plain versions' bits
// (kernels/ref.py), which are the JAX package's.
//
// sparse_accum_slots -- replaces sparse_accum.py:98 sparse_accum_slots
//   (pallas_call at :123) and, as its one-row reshape, sparse_accum.py:47
//   sparse_accum (:67).  (G, B, E) int32 bucket-local indices and values
//   (f32, bf16 or f16) -> (G, B, size) fp32: zeros plus every entry whose
//   index lies in [0, size), duplicates added.  The TPU kernel was a
//   one-hot product on the MXU that scanned every entry tile for every
//   output tile; here each entry is read once.  Two modes:
//   * sorted (the sparse path: topk_sparsify and merge_coordinate_lists
//     sort every list, and _densify maps the sentinel to -1, so a list is
//     ascending as unsigned integers with its -1 tail last).  One block
//     per (row, tile of kTile outputs).  Two warps find the tile's entry
//     range by a 33-way search over the row's list (one load a lane a
//     step); the block zeroes the tile in shared memory, the first entry
//     of each run of equal indices adds its run in list order,
//     0 + v0 + v1 + ..., and writes it; the tile is stored once.  No
//     atomics, no separate zero fill: the same bits on every run, equal to
//     the plain version's.
//   * unsorted (blockwise_sparsify's lists, whose -1 entries end each
//     block and whose ties break the order): a zero-fill kernel, then one
//     thread an entry adding with a compare-and-swap loop around an
//     IEEE __fadd_rn (the hardware's float atomicAdd flushes subnormals).
//     The order of duplicate adds is the hardware's: bitwise equal to the
//     plain version where no index appears more than twice (a + b is
//     commutative), within rounding of it otherwise.
//   Bound by memory: 4 + itemsize bytes an entry in, 4 an output out.
//
// topk_kernel -- replaces topk_compact.py:72 topk_compact (:95).  One warp
//   per block of 32 * VPL elements (512 on the path: 16 a lane, held in
//   registers).  The reference's bisection in its own arithmetic:
//   hi = max|x| + 1e-30 (NaN kept: fmaxf would drop it), 24 steps of
//   mid = 0.5 * (lo + hi) and a warp count of |x| >= mid.  Then the
//   elements strictly above lo in index order, then the ties at lo in
//   index order, k in all, positions from warp prefix sums (__popc of the
//   lane's bits, shuffles across lanes), each written directly.  A value
//   is what the reference's one-hot product gives: NaN when any other
//   element of the block is NaN or inf (inf * 0), else 0 + x (a selected
//   -0.0 is +0.0).  Slots past the admitted count (only NaN leaves any)
//   get 0 and -1.  Bound by memory: n * itemsize in,
//   nblocks * k * (itemsize + 4) out.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8192;  // outputs a block in sorted mode: 32 KB of shared fp32
constexpr unsigned kFull = 0xffffffffu;

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

// ---------------------------------------------------------------------------
// sparse_accum_slots
// ---------------------------------------------------------------------------

// First position p in list[0, e) with (unsigned) list[p] >= key, found by
// one warp: each step every lane probes one of 32 evenly spaced positions
// and a ballot narrows the range about 33-fold.  The list is ascending as
// unsigned integers, so the -1 tail lies above every key.
__device__ __forceinline__ long long warp_lower_bound(const int* __restrict__ list, long long e,
                                                      unsigned key, int lane) {
  long long lo = 0, hi = e;
  while (lo < hi) {
    const long long p = lo + ((hi - lo) * (lane + 1)) / 33;
    const bool less = static_cast<unsigned>(__ldg(list + p)) < key;
    const int c = __popc(__ballot_sync(kFull, less));
    const long long p_last = __shfl_sync(kFull, p, c > 0 ? c - 1 : 0);
    const long long p_next = __shfl_sync(kFull, p, c < 32 ? c : 31);
    if (c > 0) lo = p_last + 1;
    if (c < 32) hi = p_next;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
accum_sorted_kernel(const int* __restrict__ idx, const T* __restrict__ val,
                    float* __restrict__ out, long long e, long long size, long long b_count,
                    long long tiles, long long idx_sg, long long idx_sb, long long val_sg,
                    long long val_sb) {
  __shared__ float tile[kTile];
  __shared__ long long range[2];
  const long long row = blockIdx.x / tiles;
  const long long t = blockIdx.x - row * tiles;
  const long long g = row / b_count, b = row - g * b_count;
  const int* ri = idx + g * idx_sg + b * idx_sb;
  const T* rv = val + g * val_sg + b * val_sb;
  const long long z0 = t * kTile;
  const long long z1 = z0 + kTile < size ? z0 + kTile : size;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    const long long p = warp_lower_bound(ri, e, static_cast<unsigned>(warp ? z1 : z0), lane);
    if (lane == 0) range[warp] = p;
  }
  for (int i = threadIdx.x; i < kTile; i += kThreads) tile[i] = 0.0f;
  __syncthreads();
  const long long lo = range[0], hi = range[1];
  for (long long p = lo + threadIdx.x; p < hi; p += kThreads) {
    const int ix = __ldg(ri + p);
    if (p > lo && __ldg(ri + p - 1) == ix) continue;  // inside a run: its head adds it
    float acc = __fadd_rn(0.0f, Cvt<T>::to(rv[p]));
    for (long long q = p + 1; q < hi && __ldg(ri + q) == ix; ++q)
      acc = __fadd_rn(acc, Cvt<T>::to(rv[q]));
    tile[ix - z0] = acc;
  }
  __syncthreads();
  float* o = out + row * size + z0;
  const int n = static_cast<int>(z1 - z0);
  for (int i = threadIdx.x; i < n; i += kThreads) o[i] = tile[i];
}

__global__ void __launch_bounds__(kThreads)
zero_kernel(float* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride)
    out[i] = 0.0f;
}

// out[i] += v as one IEEE round-to-nearest addition, atomically
__device__ __forceinline__ void add_rn(float* addr, float v) {
  int* a = reinterpret_cast<int*>(addr);
  int old = *a, assumed;
  do {
    assumed = old;
    old = atomicCAS(a, assumed, __float_as_int(__fadd_rn(__int_as_float(assumed), v)));
  } while (old != assumed);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
accum_scatter_kernel(const int* __restrict__ idx, const T* __restrict__ val,
                     float* __restrict__ out, long long e, long long size, long long b_count,
                     long long total, long long idx_sg, long long idx_sb, long long val_sg,
                     long long val_sb) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long row = i / e, p = i - row * e;
  const long long g = row / b_count, b = row - g * b_count;
  const int ix = __ldg(idx + g * idx_sg + b * idx_sb + p);
  if (ix < 0 || ix >= size) return;
  add_rn(out + row * size + ix, Cvt<T>::to(val[g * val_sg + b * val_sb + p]));
}

template <typename T>
cudaError_t accum_t(const int* idx, const void* val, float* out, long long g, long long b,
                    long long e, long long size, long long idx_sg, long long idx_sb,
                    long long val_sg, long long val_sb, bool sorted, cudaStream_t s) {
  const T* v = static_cast<const T*>(val);
  const long long rows = g * b;
  if (sorted) {
    const long long tiles = (size + kTile - 1) / kTile;
    const long long grid = rows * tiles;
    if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    accum_sorted_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        idx, v, out, e, size, b, tiles, idx_sg, idx_sb, val_sg, val_sb);
    return cudaGetLastError();
  }
  const long long n = rows * size;
  long long zgrid = (n + kThreads - 1) / kThreads;
  if (zgrid > 132 * 64) zgrid = 132 * 64;  // grid-stride beyond a few waves
  zero_kernel<<<static_cast<unsigned>(zgrid), kThreads, 0, s>>>(out, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = rows * e;
  if (total == 0) return cudaSuccess;
  const long long grid = (total + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  accum_scatter_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      idx, v, out, e, size, b, total, idx_sg, idx_sb, val_sg, val_sb);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// topk_compact
// ---------------------------------------------------------------------------

// max that keeps a NaN from either side, as jnp.max does
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

// exclusive prefix sum of c over the warp's lanes; total in *all
__device__ __forceinline__ int warp_exclusive_scan(int c, int lane, int* all) {
  int inc = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += y;
  }
  *all = __shfl_sync(kFull, inc, 31);
  return inc - c;
}

template <typename T, int VPL, bool VEC>
__global__ void __launch_bounds__(kThreads)
topk_kernel(const T* __restrict__ x, T* __restrict__ vals, int* __restrict__ idxs,
            long long nblocks, int k, int n_iter) {
  static_assert(VPL <= 32, "a lane's selection bits live in one 32-bit mask");
  constexpr int kBlock = 32 * VPL;
  const int lane = threadIdx.x & 31;
  const long long blk = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (blk >= nblocks) return;  // whole warps leave together
  float v[VPL], a[VPL];
  load_f32<T, VPL, VEC>(x + blk * kBlock + lane * VPL, v);
  float amax = fabsf(v[0]);
  int bad = 0;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    a[j] = fabsf(v[j]);
    amax = nan_max(amax, a[j]);
    bad += isfinite(v[j]) ? 0 : 1;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(kFull, amax, off));
  const int bad_all = __reduce_add_sync(kFull, bad);

  float lo = 0.0f, hi = __fadd_rn(amax, 1e-30f);
  for (int it = 0; it < n_iter; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int c = 0;
#pragma unroll
    for (int j = 0; j < VPL; ++j) c += a[j] >= mid ? 1 : 0;
    if (static_cast<int>(__reduce_add_sync(kFull, c)) >= k) lo = mid; else hi = mid;
  }

  unsigned gt_bits = 0, eq_bits = 0;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    if (a[j] > lo) gt_bits |= 1u << j;
    else if (a[j] >= lo) eq_bits |= 1u << j;
  }
  int gt_all, eq_all;
  int r1 = warp_exclusive_scan(__popc(gt_bits), lane, &gt_all);
  int r2 = warp_exclusive_scan(__popc(eq_bits), lane, &eq_all);
  const int total1 = gt_all < k ? gt_all : k;
  const int room = k - total1;
  const int nsel = total1 + (eq_all < room ? eq_all : room);

  T* vo = vals + blk * k;
  int* io = idxs + blk * k;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    int pos = -1;
    if ((gt_bits >> j) & 1u) {
      if (r1 < k) pos = r1;
      ++r1;
    } else if ((eq_bits >> j) & 1u) {
      if (r2 < room) pos = total1 + r2;
      ++r2;
    }
    if (pos >= 0) {
      const bool others_bad = bad_all - (isfinite(v[j]) ? 0 : 1) > 0;
      const float out = others_bad ? __int_as_float(0x7fffffff) : __fadd_rn(0.0f, v[j]);
      vo[pos] = Cvt<T>::from(out);
      io[pos] = lane * VPL + j;
    }
  }
  for (int p = nsel + lane; p < k; p += 32) {
    vo[p] = Cvt<T>::from(0.0f);
    io[p] = -1;
  }
}

template <typename T, int VPL>
cudaError_t launch_topk(const void* x, void* vals, int* idxs, long long nblocks, int k,
                        int n_iter, cudaStream_t s) {
  constexpr bool kCanVec = (VPL * sizeof(T)) % 16 == 0;
  const bool vec = kCanVec && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long long grid = (nblocks + kThreads / 32 - 1) / (kThreads / 32);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const T* xt = static_cast<const T*>(x);
  T* vt = static_cast<T*>(vals);
  if constexpr (kCanVec) {
    if (vec) {
      topk_kernel<T, VPL, true><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
          xt, vt, idxs, nblocks, k, n_iter);
      return cudaGetLastError();
    }
  }
  topk_kernel<T, VPL, false><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      xt, vt, idxs, nblocks, k, n_iter);
  return cudaGetLastError();
}

template <typename T>
cudaError_t topk_t(const void* x, void* vals, int* idxs, int block, long long nblocks, int k,
                   int n_iter, cudaStream_t s) {
  switch (block) {
    case 32: return launch_topk<T, 1>(x, vals, idxs, nblocks, k, n_iter, s);
    case 64: return launch_topk<T, 2>(x, vals, idxs, nblocks, k, n_iter, s);
    case 128: return launch_topk<T, 4>(x, vals, idxs, nblocks, k, n_iter, s);
    case 256: return launch_topk<T, 8>(x, vals, idxs, nblocks, k, n_iter, s);
    case 512: return launch_topk<T, 16>(x, vals, idxs, nblocks, k, n_iter, s);
    case 1024: return launch_topk<T, 32>(x, vals, idxs, nblocks, k, n_iter, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Every entry point returns the launch's cudaError_t (0 on success); the
// kernels do not synchronise and allocate nothing.  dtype: 0 float32,
// 1 bfloat16, 2 float16.  Strides are in elements.

// idx (G, B, e) int32 and val (G, B, e) with free G and B strides and
// contiguous rows; out (G, B, size) fp32 contiguous.  sorted: every row is
// ascending as unsigned integers (see the head of this file).
extern "C" int sparse_accum_slots(const void* idx, const void* val, void* out, int dtype,
                                  long long g, long long b, long long e, long long size,
                                  long long idx_sg, long long idx_sb, long long val_sg,
                                  long long val_sb, int sorted, void* stream) {
  if (g < 1 || b < 1 || e < 0 || size < 1 || size > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* it = static_cast<const int*>(idx);
  float* ot = static_cast<float*>(out);
  cudaError_t err;
  switch (dtype) {
    case 0: err = accum_t<float>(it, val, ot, g, b, e, size, idx_sg, idx_sb, val_sg, val_sb, sorted, s); break;
    case 1: err = accum_t<__nv_bfloat16>(it, val, ot, g, b, e, size, idx_sg, idx_sb, val_sg, val_sb, sorted, s); break;
    case 2: err = accum_t<__half>(it, val, ot, g, b, e, size, idx_sg, idx_sb, val_sg, val_sb, sorted, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// x contiguous, nblocks * block elements; vals (nblocks, k) of x's dtype and
// idxs (nblocks, k) int32, both contiguous.  block: 32, 64, ..., 1024;
// 1 <= k <= block.
extern "C" int topk_compact(const void* x, void* vals, void* idxs, int dtype, int block,
                            long long nblocks, int k, int n_iter, void* stream) {
  if (nblocks < 1 || k < 1 || k > block || n_iter < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* it = static_cast<int*>(idxs);
  cudaError_t err;
  switch (dtype) {
    case 0: err = topk_t<float>(x, vals, it, block, nblocks, k, n_iter, s); break;
    case 1: err = topk_t<__nv_bfloat16>(x, vals, it, block, nblocks, k, n_iter, s); break;
    case 2: err = topk_t<__half>(x, vals, it, block, nblocks, k, n_iter, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
