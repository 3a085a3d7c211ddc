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
//   per block of 32 * VPL elements (512 on the path: 16 a lane, loaded 16
//   bytes at a time and held in registers).  The reference bisects for its
//   threshold: n_iter (24) steps of mid = 0.5 * (lo + hi) from lo = 0,
//   hi = max|x| + 1e-30 (NaN kept: fmaxf would drop it), each asking
//   whether count(|x| >= mid) >= k.  That holds exactly when v_k >= mid,
//   v_k the block's k-th largest magnitude: an order statistic, no
//   rounding enters.  So one pass over the block finds v_k, and the steps
//   run on the scalars lo, hi, mid with the reference's IEEE operations:
//   lo has its bits and no step reads an element.  A block holding a NaN
//   has hi = NaN, every test is false and lo stays 0, as in the reference.
//   For k = 1, v_1 is the max already taken for hi.  For k > 1 a radix
//   select finds it (warp_kth_largest): magnitudes order as their 31-bit
//   patterns; passes over 6-bit digits from the top count the candidates
//   by digit in per-lane byte counters in shared memory (no atomics:
//   normal data share their top digit, which would serialise a shared
//   histogram) until at most 32 are left, which a warp bitonic sort
//   orders.  Then the elements strictly above lo in index
//   order, then the ties at lo in index order, k in all, positions from
//   warp prefix sums; each selected element is read again (from cache) and
//   written directly.  A value is what the reference's one-hot product
//   gives: NaN when any other element of the block is NaN or inf
//   (inf * 0), else 0 + x (a selected -0.0 is +0.0).  Slots past the
//   admitted count (only NaN leaves any) get 0 and -1.  Bound by memory:
//   n * itemsize in, nblocks * k * (itemsize + 4) out.  On an H100 80GB
//   HBM3 at 700 W, 2^28 fp32 at k = 1 takes 0.349 ms against that bound's
//   0.322 (92 %; the counting bisection took 1.114).  At k = 8 and 64 the
//   select's instructions, about ten a key a pass, make it 0.70 and 0.91
//   ms (47 and 44 %): bound by instruction throughput there, off the
//   sparsifier's path.

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

constexpr int kTopkWarps = 4;    // input blocks a CTA, one a warp
constexpr int kDigits = 64;      // radix select: 6-bit digits

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

// The k-th largest (1 <= k <= 32 * VPL) of the warp's magnitudes |v|, as
// its 31-bit pattern: non-negative floats order as their bits (a NaN comes
// above +inf; a block holding one never uses the result).
// Radix select from the top, 6-bit digits (bits 25-30, 19-24, 13-18, 7-12,
// 1-6, then bit 0).  Each pass counts the candidates (keys that share the
// digits found so far) by their next digit, each lane in its own byte
// column of the table, row d for digit d (no atomics: normal data share
// their top digit, which would serialise a shared histogram).  Lane l sums
// rows l and l + 32 (the eight lanes of a 16-byte load phase hit all 32
// banks); the table is zeroed once, so a pass's count is the sum less the
// last pass's.  The warp finds the digit where the count from the top
// reaches k.  Once at most 32 candidates are left they are gathered, one a
// lane, sorted by a warp bitonic sort and the k-th of those left is read
// off.  table: the warp's kDigits * 32 bytes, zero.
template <int VPL>
__device__ unsigned warp_kth_largest(const float (&v)[VPL], int k, int lane,
                                     uint4* __restrict__ table) {
  unsigned u[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) u[j] = __float_as_uint(v[j]) & 0x7fffffffu;
  unsigned char* col = reinterpret_cast<unsigned char*>(table) + lane;
  unsigned prefix = 0, above = 0;  // the digits found so far, and their bits
  int want = k, count, seen[2] = {0, 0};  // this lane's rows' sums so far
#pragma unroll 1
  for (int shift = 25;; shift = shift > 6 ? shift - 6 : 0) {
    __syncwarp();
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      if ((u[j] & above) == prefix) ++col[((u[j] >> shift) % kDigits) * 32];
    __syncwarp();
    // this pass's counts of this lane's two digits: the rows only grow
    // (at most 6 * 32 a byte), so a count is the row's sum less its last
    int t[2];
    const int h = (lane >> 2) & 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint4* row = table + (lane + 32 * i) * 2;
      const uint4 a = row[h], b = row[h ^ 1];
      unsigned s = 0;
      s = __dp4a(a.x, 0x01010101u, s); s = __dp4a(a.y, 0x01010101u, s);
      s = __dp4a(a.z, 0x01010101u, s); s = __dp4a(a.w, 0x01010101u, s);
      s = __dp4a(b.x, 0x01010101u, s); s = __dp4a(b.y, 0x01010101u, s);
      s = __dp4a(b.z, 0x01010101u, s); s = __dp4a(b.w, 0x01010101u, s);
      t[i] = static_cast<int>(s) - seen[i];
      seen[i] = static_cast<int>(s);
    }
    // the half of the digits, then the digit, where the count from the
    // top reaches want
    const int upper = static_cast<int>(__reduce_add_sync(kFull, t[1]));
    const bool hi_half = want <= upper;
    const int mine = hi_half ? t[1] : t[0];
    int inc = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_down_sync(kFull, inc, off);
      if (lane + off < 32) inc += y;
    }
    const int higher = (hi_half ? 0 : upper) + inc - mine;  // keys above this lane's digit
    const int src = __ffs(__ballot_sync(kFull, higher < want && want <= higher + mine)) - 1;
    want -= __shfl_sync(kFull, higher, src);
    count = __shfl_sync(kFull, mine, src);
    prefix |= static_cast<unsigned>((hi_half ? 32 : 0) + src) << shift;
    above = 0xffffffffu << shift;
    if (count <= 32 || shift == 0) break;
  }
  if (count > 32) return prefix;  // past bit 0: the candidates all equal it
  // gather the candidates, one a lane, sort them (bitonic, descending) and
  // read off the want-th
  unsigned mask = 0;
#pragma unroll
  for (int j = 0; j < VPL; ++j) mask |= ((u[j] & above) == prefix ? 1u : 0u) << j;
  int total;
  int slot = warp_exclusive_scan(__popc(mask), lane, &total);
  unsigned* list = reinterpret_cast<unsigned*>(table);
  __syncwarp();  // every lane has read its rows
#pragma unroll
  for (int j = 0; j < VPL; ++j)
    if ((mask >> j) & 1u) list[slot++] = u[j];
  __syncwarp();
  unsigned c = lane < count ? list[lane] : 0u;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned o = __shfl_xor_sync(kFull, c, stride);
      const bool keep_max = ((lane & stride) == 0) == ((lane & size) == 0);
      c = keep_max ? max(c, o) : min(c, o);
    }
  }
  return __shfl_sync(kFull, c, want - 1);
}

template <typename T, int VPL, bool VEC, bool SELECT>
__global__ void __launch_bounds__(kTopkWarps * 32)
topk_kernel(const T* __restrict__ x, T* __restrict__ vals, int* __restrict__ idxs,
            long long nblocks, int k, int n_iter) {
  static_assert(VPL <= 32, "a lane's selection bits live in one 32-bit mask");
  constexpr int kBlock = 32 * VPL;
  __shared__ uint4 tables[SELECT ? kTopkWarps * kDigits * 2 : 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long blk = static_cast<long long>(blockIdx.x) * kTopkWarps + warp;
  if (blk >= nblocks) return;  // whole warps leave together
  const T* xb = x + blk * kBlock + lane * VPL;
  float v[VPL];
  load_f32<T, VPL, VEC>(xb, v);
  float amax = fabsf(v[0]);
  int bad = 0;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    amax = nan_max(amax, fabsf(v[j]));
    bad += isfinite(v[j]) ? 0 : 1;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(kFull, amax, off));
  const int bad_all = __reduce_add_sync(kFull, bad);

  // v_k, the k-th largest magnitude.  A block holding a NaN has hi = NaN:
  // every test below is false whatever v_k is, as the reference's counts
  // never reach k.
  float vk = amax;
  if constexpr (SELECT) {
    uint4* table = tables + warp * kDigits * 2;
#pragma unroll
    for (int i = lane; i < kDigits * 2; i += 32) table[i] = make_uint4(0u, 0u, 0u, 0u);
    vk = __uint_as_float(warp_kth_largest<VPL>(v, k, lane, table));
  }
  // the reference's bisection: count(|x| >= mid) >= k  <=>  v_k >= mid
  float lo = 0.0f, hi = __fadd_rn(amax, 1e-30f);
  for (int it = 0; it < n_iter; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    if (vk >= mid) lo = mid; else hi = mid;
  }

  unsigned gt_bits = 0, eq_bits = 0;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const float a = fabsf(v[j]);
    if (a > lo) gt_bits |= 1u << j;
    else if (a >= lo) eq_bits |= 1u << j;
  }
  int gt_all, eq_all;
  int r1 = warp_exclusive_scan(__popc(gt_bits), lane, &gt_all);
  int r2 = warp_exclusive_scan(__popc(eq_bits), lane, &eq_all);
  const int total1 = gt_all < k ? gt_all : k;
  const int room = k - total1;
  const int nsel = total1 + (eq_all < room ? eq_all : room);

  // each selected element read again (it is in cache) and written
  T* vo = vals + blk * k;
  int* io = idxs + blk * k;
  auto put = [&](int j, int pos) {
    const float xv = Cvt<T>::to(xb[j]);
    const bool others_bad = bad_all - (isfinite(xv) ? 0 : 1) > 0;
    vo[pos] = Cvt<T>::from(others_bad ? __int_as_float(0x7fffffff) : __fadd_rn(0.0f, xv));
    io[pos] = lane * VPL + j;
  };
  for (unsigned m = gt_bits; m != 0u && r1 < k; m &= m - 1u, ++r1) put(__ffs(m) - 1, r1);
  for (unsigned m = eq_bits; m != 0u && r2 < room; m &= m - 1u, ++r2) put(__ffs(m) - 1, total1 + r2);
  for (int p = nsel + lane; p < k; p += 32) {
    vo[p] = Cvt<T>::from(0.0f);
    io[p] = -1;
  }
}

template <typename T, int VPL, bool SELECT>
cudaError_t launch_topk_kernel(const T* x, T* vals, int* idxs, long long nblocks, int k,
                               int n_iter, cudaStream_t s) {
  constexpr bool kCanVec = (VPL * sizeof(T)) % 16 == 0;
  const long long grid = (nblocks + kTopkWarps - 1) / kTopkWarps;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 g(static_cast<unsigned>(grid)), b(kTopkWarps * 32);
  if constexpr (kCanVec) {
    if (reinterpret_cast<uintptr_t>(x) % 16 == 0) {
      topk_kernel<T, VPL, true, SELECT><<<g, b, 0, s>>>(x, vals, idxs, nblocks, k, n_iter);
      return cudaGetLastError();
    }
  }
  topk_kernel<T, VPL, false, SELECT><<<g, b, 0, s>>>(x, vals, idxs, nblocks, k, n_iter);
  return cudaGetLastError();
}

template <typename T, int VPL>
cudaError_t launch_topk(const void* x, void* vals, int* idxs, long long nblocks, int k,
                        int n_iter, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* vt = static_cast<T*>(vals);
  if (k == 1) return launch_topk_kernel<T, VPL, false>(xt, vt, idxs, nblocks, k, n_iter, s);
  return launch_topk_kernel<T, VPL, true>(xt, vt, idxs, nblocks, k, n_iter, s);
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
