// Flash attention forward on Hopper: online softmax, fp32 state.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn.py::
// flash_attention (pallas_call at :86).  Computes, for every batch row b,
// query head h and query position i,
//
//   s_j = cap · tanh((fl32(q_i) · scale) · k_j / cap)   (the tanh only if cap > 0)
//   s_j = -1e30 where the causal / sliding-window mask hides key j
//   o_i = Σ_j exp(s_j − m) v_j / max(Σ_j exp(s_j − m), 1e-30)
//
// in fp32, with the running max m, the running sum l and the output
// accumulator kept in registers, and writes o in the input dtype and the
// row's log-sum-exp m + log(l) in fp32 (the backward recomputes the
// probabilities from it).  Masked scores are −1e30, not −inf, exactly as
// the TPU kernel has them.  Layout: q is (B, Sq, H, hd) and k, v are
// (B, Sk, KV, hd) with H % KV == 0, any strides with a contiguous head
// dim; head h reads KV head h / (H / KV), so a GQA caller passes K and V
// once, not broadcast.  Ragged Sq and Sk tails are masked here, so no
// length has to be a multiple of a tile.
//
// What bounds it: operations.  A causal launch at the training path's
// shape (B·H = 8·32, S = 4096, hd = 64, bf16) does 2·hd·S²/2 multiply-adds
// twice (scores, then P·V) per head: 550 GFLOP, 0.56 ms at the tensor
// cores' 989 TFLOP/s; its bytes (q and the 4 KV heads' k, v read once,
// o and the log-sum-exp written once, 306 MB) take 0.09 ms at 3.35 TB/s.
// This first version runs on the CUDA cores in fp32 (67 TFLOP/s peak),
// which also keeps fp32 inputs exact to the reference's tolerance; tensor
// cores (wgmma, TMA-fed tiles) are the next step.  Design: one block of
// 128 threads per (batch·head, tile of 128 query rows), one query row a
// thread, its scaled q row and its output accumulator in registers.  K
// and V stream through shared memory in tiles of 64 keys, converted to
// fp32 once; every lane of a warp reads the same key (a broadcast, no
// bank conflicts) with 16-byte loads, and 16 keys at a time are scored
// into registers, so each thread runs 16 independent multiply-add
// chains.  Tiles that the causal mask or the window hides from every row
// of the block are skipped (exact: each skipped score would add
// exp(−1e30 − m) = 0 to a row that holds its own key).  Heavy (late)
// causal query tiles are scheduled first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QT = 128;   // query rows a block, one a thread
constexpr int KT = 64;    // keys a shared-memory tile
constexpr int SUB = 16;   // keys scored into registers at a time

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, H, KV, Sq, Sk;
  // element strides (batch, seq, head) of q, k, v, o
  long long qs[3], ks[3], vs[3], os[3];
  float scale, cap;
  int causal, window;
};

template <typename T, int HD>
__global__ void __launch_bounds__(QT) flash_fwd_kernel(Args a) {
  static_assert(HD % 4 == 0, "head dim must be a multiple of 4");
  __shared__ __align__(16) float ksm[KT][HD];
  __shared__ __align__(16) float vsm[KT][HD];

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QT;   // late tiles first
  const int row = q0 + threadIdx.x;
  const bool live = row < a.Sq;

  float qr[HD];
  {
    const T* qp = static_cast<const T*>(a.q) + b * a.qs[0] +
                  static_cast<long long>(live ? row : 0) * a.qs[1] + h * a.qs[2];
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = live ? to_f(qp[d]) * a.scale : 0.f;
  }
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  // the key range any row of this block can see
  const int qlast = min(q0 + QT, a.Sq) - 1;
  int kbeg = 0, kend = a.Sk;
  if (a.causal) {
    kend = min(a.Sk, qlast + 1);
    if (a.window > 0 && qlast < a.Sk) kbeg = max(0, q0 - a.window + 1) / KT * KT;
  }

  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + kvh * a.ks[2];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + kvh * a.vs[2];

  for (int t0 = kbeg; t0 < kend; t0 += KT) {
    __syncthreads();   // the previous tile is consumed
    for (int i = threadIdx.x; i < KT * HD; i += QT) {
      const int r = i / HD, c = i % HD;
      const int key = t0 + r;
      const bool in = key < kend;
      ksm[r][c] = in ? to_f(kb[static_cast<long long>(key) * a.ks[1] + c]) : 0.f;
      vsm[r][c] = in ? to_f(vb[static_cast<long long>(key) * a.vs[1] + c]) : 0.f;
    }
    __syncthreads();
    const int nk = min(KT, kend - t0);
    for (int j0 = 0; j0 < nk; j0 += SUB) {
      float s[SUB];
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) s[jj] = 0.f;
#pragma unroll
      for (int c = 0; c < HD / 4; ++c) {
        const float q0v = qr[4 * c], q1v = qr[4 * c + 1], q2v = qr[4 * c + 2],
                    q3v = qr[4 * c + 3];
#pragma unroll
        for (int jj = 0; jj < SUB; ++jj) {
          const float4 k4 = reinterpret_cast<const float4*>(&ksm[j0 + jj][0])[c];
          s[jj] = fmaf(q0v, k4.x, s[jj]);
          s[jj] = fmaf(q1v, k4.y, s[jj]);
          s[jj] = fmaf(q2v, k4.z, s[jj]);
          s[jj] = fmaf(q3v, k4.w, s[jj]);
        }
      }
      float mt = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const int key = t0 + j0 + jj;
        float x = s[jj];
        if (a.cap > 0.f) x = tanhf(x / a.cap) * a.cap;
        if (j0 + jj >= nk) {
          x = -INFINITY;   // past the block's key range: no such key
        } else if (a.causal && (key > row || (a.window > 0 && key <= row - a.window))) {
          x = -1e30f;
        }
        s[jj] = x;
        mt = fmaxf(mt, x);
      }
      // the sub-tile holds at least one key in range, so mn is finite
      const float mn = fmaxf(m, mt);
      const float alpha = expf(m - mn);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        s[jj] = expf(s[jj] - mn);
        ps += s[jj];
      }
      l = l * alpha + ps;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float p = s[jj];
#pragma unroll
        for (int c = 0; c < HD / 4; ++c) {
          const float4 v4 = reinterpret_cast<const float4*>(&vsm[j0 + jj][0])[c];
          acc[4 * c] = fmaf(p, v4.x, acc[4 * c]);
          acc[4 * c + 1] = fmaf(p, v4.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(p, v4.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(p, v4.w, acc[4 * c + 3]);
        }
      }
      m = mn;
    }
  }

  if (live) {
    const float den = fmaxf(l, 1e-30f);
    T* op = static_cast<T*>(a.o) + b * a.os[0] + static_cast<long long>(row) * a.os[1] +
            h * a.os[2];
#pragma unroll
    for (int d = 0; d < HD; ++d) op[d] = from_f<T>(acc[d] / den);
    a.lse[static_cast<long long>(bh) * a.Sq + row] = m + logf(l);
  }
}

template <typename T>
cudaError_t launch_t(const Args& a, int hd, cudaStream_t s) {
  const dim3 grid(a.B * a.H, (a.Sq + QT - 1) / QT);
  switch (hd) {
    case 16: flash_fwd_kernel<T, 16><<<grid, QT, 0, s>>>(a); break;
    case 32: flash_fwd_kernel<T, 32><<<grid, QT, 0, s>>>(a); break;
    case 64: flash_fwd_kernel<T, 64><<<grid, QT, 0, s>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, hd), k and v (B, Sk, KV, hd), o (B, Sq, H, hd) in dtype
// (0 = fp32, 1 = bf16); lse (B, H, Sq) fp32, contiguous.  strides holds
// the (batch, seq, head) element strides of q, k, v and o in that order.
// Returns the launch's cudaError_t (0 on success); launches nothing and
// returns cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                              void* lse, int dtype, int hd, int B, int H, int KV,
                              int Sq, int Sk, const long long* strides, float scale,
                              int causal, float cap, int window, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Sk < 1 || Sq > 65535 * QT)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.Sq = Sq;
  a.Sk = Sk;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.scale = scale;
  a.cap = cap;
  a.causal = causal;
  a.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_t<float>(a, hd, s); break;
    case 1: err = launch_t<__nv_bfloat16>(a, hd, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
