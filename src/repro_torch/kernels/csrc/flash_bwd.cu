// Flash attention backward on Hopper: dQ, dK and dV from the forward's
// saved log-sum-exp, accumulated in fp32 on the tensor cores.
//
// Replaces no TPU kernel: the Pallas kernel repro/kernels/flash_attn.py::
// flash_attention (pallas_call at :86) is forward-only, and the JAX
// package's train step differentiates repro/models/base.py::attend through
// XLA.  The port's training path runs the forward kernels of
// flash_attn.cu under an autograd Function (flash_attn.py::
// FlashAttention); this file is that Function's backward on the card, the
// same function as its plain version kernels/ref.py::flash_attention_bwd.
// For the forward defined at the top of flash_attn.cu, with s the capped
// score, p = exp(s − lse) the probability (0 where the causal mask or the
// window hides the key) and dO the output's gradient:
//
//   D_i  = Σ_d dO_id · O_id                       (the softmax's Σ_j p_ij dp_ij)
//   dp_ij = dO_i · v_j,  ds_ij = p_ij (dp_ij − D_i) (1 − tanh²) (the tanh only if cap > 0)
//   dV_j = Σ_i p_ij dO_i,  dK_j = scale Σ_i ds_ij q_i,  dQ_i = scale Σ_j ds_ij k_j
//
// with dK and dV of a KV head summed over the G = H / KV query heads of
// its group.  Both dtypes apply the scale to the fp32 product q · k (the
// fp32 forward scales q first; the two orders differ by fp32 rounding).
// Layout: q (B, Sq, H, hd), k (B, Sk, KV, hd), v (B, Sk, KV, vd), o and dO
// (B, Sq, H, vd), each with its own (batch, seq, head) element strides and
// a contiguous last dim; lse and D (B, H, Sq) fp32; dq, dk and dv are
// written contiguous in the inputs' dtype.  No length has to be a
// multiple of a tile.  Every row must see a key (the wrapper checks it).
//
// What bounds it: operations.  Five products per visible (query, key)
// pair — S = q·kᵀ, dP = dO·vᵀ, dV, dK, dQ — 2·(3·hd + 2·vd) flops, 2.5×
// the forward's at hd = vd: 1374.7 GFLOP at TinyLlama's causal (8, 4096,
// 32, 64) over 4 KV heads, 1.390 ms at 989 TFLOP/s; its bytes (q, k, v,
// o, dO read, dq, dk, dv written) 0.2 ms at 3.35 TB/s.
//
// Design: deterministic, without atomics (every dQ, dK and dV element is
// written once, so two launches give the same bits).  Three kernels on
// one stream, the first shared by both dtypes:
//
// * flash_bwd_dot_kernel: D, one warp a (batch, head, query row), fixed
//   shuffle order.
// * dK and dV: one block per (batch row, KV head, tile of keys), looping
//   over the group's G heads and, for each, over the query tiles that can
//   see the keys (from the causal diagonal up to key + window), heavy
//   (early) key tiles first.
// * dQ: one block per (batch row, head, tile of query rows), over the key
//   tiles its rows can see, heavy (late) row tiles first.  It recomputes
//   S and dP: 7 products a pair in all (a 1.945 ms floor at TinyLlama's
//   shape), the price of no atomics.
//
// bf16 (flash_bwd_dkdv_wgmma_kernel, flash_bwd_dq_wgmma_kernel; namespace
// wg): wgmma, fed by TMA.  A block is one producer warpgroup, whose
// registers go to the consumers (setmaxnreg 24 / 240), and two consumer
// warpgroups of 64 rows.  One producer thread loads the block's fixed
// tiles once (dK/dV: its K and V; dQ: its Q and dO) and keeps the
// streamed ones (dK/dV: Q and dO of QB rows; dQ: K and V of KB keys) in
// flight in a ring of up to 4 stages, each with a "full" and an "empty"
// mbarrier, 128-byte swizzled as 64-wide boxes (hd 16 and 32 are
// zero-filled to 64, the forward's layout); in the dK/dV kernel the
// producer's first warp also writes the rows' lse · log2 e and D beside
// each stage.  A consumer:
//
// * dK/dV: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ on its 64 keys by SS wgmma (both
//   operands K-major as they land), two commit groups, so that Pᵀ is
//   formed while dPᵀ runs (lse by query column from the stage); Pᵀ and
//   dSᵀ are rounded to bf16 once and are the register A operand of dV +=
//   Pᵀ·dO (issued before dS is formed) and dK += dSᵀ·Q, with dO and Q as
//   MN-major B tiles: P and dS never touch shared memory, and dK and dV
//   stay in registers, (HDP + VDP) / 2 fp32 values a thread.  At (192,
//   128) that is 160, so a stage holds 32 query rows there (64 above).
//   At hd 256 (256 values) the two consumers hold the same 64 keys
//   instead, each half of the queries' scores; both write bf16 Pᵀ and dSᵀ
//   into one swizzled shared buffer (two, taken by the tile's parity, so
//   that one barrier a tile suffices), and each accumulates half of the
//   64-wide chunks of dK and dV by SS wgmma (dO and Q transposed).
// * dQ: S = Q·Kᵀ and dP = dO·Vᵀ on its 64 rows by SS wgmma (P formed while
//   dP runs), dS in registers as the A operand of dQ += dS·K, K MN-major.
//
// The elementwise pass is compiled four times (cap or not, masked or not)
// and picked once a tile: a per-element branch on the cap or the mask
// made it ten times longer (PERF.md §6).  The rounding points are those
// of the mma.sync design this one replaced: bf16 P and dS (one bf16 each,
// not the forward's two halves: the gradients' bound is 2e-2 of each
// one's largest, and tests/test_torch_flash_bwd.py emulates these
// rounding points and the tiles' summation order on the CPU within half
// of it), D from the bf16 output; the products sum 16-deep steps in the
// same order, so that without a cap the gradients keep that design's
// bits.
//
// fp32 (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel): mma.sync m16n8k8 in
// TF32 from shared memory, eight warps, cp.async rings of two stages;
// each operand split into a TF32 big and small part and each product
// taken three times (small·big + big·small + big·big), the sums taken
// from 0 over two 8-wide chunks and then added in fp32, the arithmetic of
// flash_attn.cu's fp32 forward.  In the dK/dV kernel each warp computes
// its slice of Sᵀ and dPᵀ and writes Pᵀ and dSᵀ to shared memory, and
// after a barrier accumulates its slice of dV and dK; the dQ kernel keeps
// dS in registers as the product's A operand.
//
// Masks are applied per element (p = 0) only on a tile that crosses an
// edge, and tiles no row of the block sees are skipped; rows past Sq and
// keys past Sk are zero-filled and masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int STAGES = 2;  // cp.async ring depth of both fp32 kernels

using hopper::ex2;  // 2^x on the SFU (ftz: a probability below 2^-126 is 0)
using hopper::smem_u32;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// two adjacent values stored as T
__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// bf16(x0), bf16(x1) packed as an mma operand wants them (x0 low)
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// fp32's tensor-core route (mma.sync in TF32): a warp's fragments of A
// (16 × K, row-major in shared memory), of B for one 8-wide n-tile
// (stored n-major, "NK": row n holds B[·][n]; or k-major, "KN": row k
// holds B[k][·]) and the product into an fp32 m16n8 accumulator (thread
// (g = lane / 4, t = lane % 4) holds rows g and g + 8, columns 2t and
// 2t + 1).
// ---------------------------------------------------------------------------

template <typename T>
struct Mma;

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (flash_attn.cu's f32::tf32)
__device__ __forceinline__ uint32_t tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x = big + small, each a TF32 value
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
struct Mma<float> {
  static constexpr int K = 8;
  static constexpr int PAD = 4;  // rows of d + 4 floats: a fragment's reads fall on 32 banks
  // mma depths a sum takes on the tensor cores from 0 before it is added
  // to its fp32 total (a tensor core aligns addends to the largest and
  // truncates: flash_attn.cu's f32::CHUNKS)
  static constexpr int CH = 2;
  struct A {
    uint32_t big[4], small[4];
  };
  struct B {
    uint32_t big[2], small[2];
  };
  static __device__ __forceinline__ void set_a(A& a, float x0, float x1, float x2, float x3) {
    split(x0, a.big[0], a.small[0]);
    split(x1, a.big[1], a.small[1]);
    split(x2, a.big[2], a.small[2]);
    split(x3, a.big[3], a.small[3]);
  }
  static __device__ __forceinline__ void load_a(A& a, const float* p, int ld, int lane) {
    const int g = lane / 4, t = lane % 4;
    const float* r = p + g * ld + t;
    set_a(a, r[0], r[8 * ld], r[4], r[8 * ld + 4]);
  }
  static __device__ __forceinline__ void load_b_nk(B& b, const float* p, int ld, int lane) {
    const float* r = p + (lane / 4) * ld + lane % 4;
    split(r[0], b.big[0], b.small[0]);
    split(r[4], b.big[1], b.small[1]);
  }
  static __device__ __forceinline__ void load_b_kn(B& b, const float* p, int ld, int lane) {
    const float* r = p + (lane % 4) * ld + lane / 4;
    split(r[0], b.big[0], b.small[0]);
    split(r[4 * ld], b.big[1], b.small[1]);
  }
  // d += a · b in three TF32 products, the smallest first
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    mma_tf32(d, a.small, b.big[0], b.big[1]);
    mma_tf32(d, a.big, b.small[0], b.small[1]);
    mma_tf32(d, a.big, b.big[0], b.big[1]);
  }
  // the A fragment of keys 8·kk .. 8·kk + 7 from accumulator fragments c
  // (n-tile kk), its k-slot t taking key 2t and k-slot t + 4 key 2t + 1
  template <int N>
  static __device__ __forceinline__ void a_from_c(A& a, const float (&c)[N][4], int kk) {
    set_a(a, c[kk][0], c[kk][2], c[kk][1], c[kk][3]);
  }
  // the B fragment matching a_from_c: KN at p (k0, n0), k-slot t row 2t
  // and k-slot t + 4 row 2t + 1
  static __device__ __forceinline__ void load_b_kn_c(B& b, const float* p, int ld, int lane) {
    const float* r = p + 2 * (lane % 4) * ld + lane / 4;
    split(r[0], b.big[0], b.small[0]);
    split(r[ld], b.big[1], b.small[1]);
  }
};

// acc[n] += A (16 × KD at a, pitch lda) · B (KD × 8·NT at b, pitch ldb;
// NK or KN as KN says)
template <typename T, int KD, int NT, bool KN>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const T* a, int lda, const T* b,
                                          int ldb, int lane) {
  using M = Mma<T>;
  constexpr int STEPS = KD / M::K;
  constexpr int CH = STEPS < M::CH ? STEPS : M::CH;
  static_assert(KD % M::K == 0 && STEPS % CH == 0, "depth");
#pragma unroll 2
  for (int k0 = 0; k0 < STEPS; k0 += CH) {
    typename M::A af[CH];
#pragma unroll
    for (int u = 0; u < CH; ++u) M::load_a(af[u], a + (k0 + u) * M::K, lda, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        typename M::B bf;
        const int k = (k0 + u) * M::K;
        if constexpr (KN)
          M::load_b_kn(bf, b + k * ldb + 8 * n, ldb, lane);
        else
          M::load_b_nk(bf, b + 8 * n * ldb + k, ldb, lane);
        M::mma(c, af[u], bf);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[n][j] += c[j];
    }
  }
}

// acc[n] += C (16 × KD, the warp's accumulator fragments c, as the A
// operand) · B (KD × 8·NT, KN at b, pitch ldb)
template <typename T, int KD, int NT>
__device__ __forceinline__ void warp_gemm_c(float (&acc)[NT][4], const float (&cf)[KD / 8][4],
                                            const T* b, int ldb, int lane) {
  using M = Mma<T>;
  constexpr int STEPS = KD / M::K;
  constexpr int CH = STEPS < M::CH ? STEPS : M::CH;
  static_assert(KD % M::K == 0 && STEPS % CH == 0, "depth");
#pragma unroll
  for (int k0 = 0; k0 < STEPS; k0 += CH) {
    typename M::A af[CH];
#pragma unroll
    for (int u = 0; u < CH; ++u) M::a_from_c(af[u], cf, k0 + u);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        typename M::B bf;
        M::load_b_kn_c(bf, b + (k0 + u) * M::K * ldb + 8 * n, ldb, lane);
        M::mma(c, af[u], bf);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[n][j] += c[j];
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, Sq)
  float* dd;         // (B, H, Sq): D, written by the first kernel
  void* dq;          // (B, Sq, H, hd)
  void* dk;          // (B, Sk, KV, hd)
  void* dv;          // (B, Sk, KV, vd)
  int B, H, KV, Sq, Sk, vd;
  // element strides (batch, seq, head) of q, k, v, o, dO
  long long qs[3], ks[3], vs[3], os[3], ds[3];
  float scale, cap;
  int causal, window;
};

// Whether key j is visible to query row i (both in range).
__device__ __forceinline__ bool visible(const Args& a, int i, int j) {
  return j < a.Sk && i < a.Sq &&
         (!a.causal || (j <= i && (a.window == 0 || j > i - a.window)));
}

// Whether every key jmin..jmax is visible to every row imin..imax: the
// warp's tile skips the per-element mask.
__device__ __forceinline__ bool all_visible(const Args& a, int imin, int imax, int jmin,
                                            int jmax) {
  return jmax < a.Sk && imax < a.Sq &&
         (!a.causal || (jmax <= imin && (a.window == 0 || jmin > imax - a.window)));
}

// p and ds of one score x (the fp32 product q · k), its row's lse · log2 e
// and D, and dp: the cap's tanh, the mask, the softmax's backward.  The
// exponent is the bf16 forward's: x · (scale · log2 e) uncapped.
__device__ __forceinline__ void prob(const Args& a, bool vis, float x, float lse2, float d, float& p,
                                     float& dsv) {
  if (a.cap > 0.f) {
    const float th = tanhf(x * a.scale / a.cap);
    p = vis ? ex2(th * a.cap * LOG2E - lse2) : 0.f;
    dsv = p * (dsv - d) * (1.f - th * th);
  } else {
    p = vis ? ex2(x * (a.scale * LOG2E) - lse2) : 0.f;
    dsv = p * (dsv - d);
  }
}

// ---------------------------------------------------------------------------
// D = Σ_d dO · O, one warp a (b, h, i) row, rows in (B, H, Sq) order.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_dot_kernel(const __grid_constant__ Args a) {
  const long long r = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= static_cast<long long>(a.B) * a.H * a.Sq) return;
  const int i = static_cast<int>(r % a.Sq);
  const int h = static_cast<int>((r / a.Sq) % a.H);
  const int b = static_cast<int>(r / (static_cast<long long>(a.Sq) * a.H));
  const T* o = static_cast<const T*>(a.o) + b * a.os[0] + i * a.os[1] + h * a.os[2];
  const T* d = static_cast<const T*>(a.dout) + b * a.ds[0] + i * a.ds[1] + h * a.ds[2];
  float acc = 0.f;
  for (int c = lane; c < a.vd; c += 32) acc += to_f(o[c]) * to_f(d[c]);
#pragma unroll
  for (int sh = 16; sh >= 1; sh /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, sh);
  if (lane == 0) a.dd[r] = acc;
}

// ---------------------------------------------------------------------------
// dK and dV: one block a (b, KV head, KT keys).
// ---------------------------------------------------------------------------

template <typename T, int HD, int VD>
struct KvShape {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int WARPS = 8, THREADS = 32 * WARPS;
  // keys a block: 64 (32 keys at hd >= 192 took gemma2-2b's backward 16.2
  // ms on an H100 against 13.8 at 64, and deepseek's 20.6 against 16.1:
  // tools/flash_bwd_ab.py); 32 for fp32 at hd 256, whose 64 would not fit
  static constexpr int KT = F32 && HD == 256 ? 32 : 64;
  static constexpr int RG = KT / 16, CG = WARPS / RG;    // warps: key rows × column slices
  static constexpr int QB = F32 && HD >= 128 ? 32 : 64;  // query rows a tile
  static constexpr int PAD = Mma<T>::PAD;
  static constexpr int HP = HD + PAD, VP = VD + PAD, QP = QB + PAD;
  static constexpr int QW = QB / CG, DKW = HD / CG, DVW = VD / CG;  // a warp's columns
  static constexpr int STAGE = QB * (HP + VP);                      // Q, then dO
  static constexpr int ELEMS = KT * (HP + VP) + STAGES * STAGE + 2 * KT * QP;
  static constexpr int SMEM = static_cast<int>(sizeof(T)) * ELEMS + 4 * STAGES * 2 * QB;
  static_assert(QW % 8 == 0 && DKW % 8 == 0 && DVW % 8 == 0, "column slices");
  static_assert(SMEM <= 232448, "shared memory");
};

template <typename T, int HD, int VD>
__global__ void __launch_bounds__(256, HD <= 64 ? 2 : 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ Args a) {
  using S = KvShape<T, HD, VD>;
  constexpr int KT = S::KT, QB = S::QB, HP = S::HP, VP = S::VP, QP = S::QP;
  constexpr int EPC = 16 / sizeof(T);  // elements a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  T* ksm = reinterpret_cast<T*>(smem);  // [KT][HP]
  T* vsm = ksm + KT * HP;               // [KT][VP]
  T* ring = vsm + KT * VP;              // [STAGES]: Q [QB][HP], dO [QB][VP]
  T* psm = ring + STAGES * S::STAGE;    // Pᵀ [KT][QP]
  T* dssm = psm + KT * QP;              // dSᵀ [KT][QP]
  float* stats = reinterpret_cast<float*>(dssm + KT * QP);  // [STAGES]: lse [QB], D [QB]

  const int b = blockIdx.x / a.KV, kvh = blockIdx.x % a.KV;
  const int G = a.H / a.KV;
  const int k0 = blockIdx.y * KT;  // early (heavy, under a causal mask) tiles first
  // the query rows that see a key of the block
  int qbeg = 0, qend = a.Sq;
  if (a.causal) {
    qbeg = min(k0, a.Sq);
    if (a.window > 0) qend = min(a.Sq, k0 + KT - 1 + a.window);
  }
  const int nq = qend > qbeg ? (qend - qbeg + QB - 1) / QB : 0;
  const int ntiles = G * nq;

  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + kvh * a.ks[2];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + kvh * a.vs[2];
  constexpr int KC = HD / EPC, RC = (HD + VD) / EPC;
  for (int c = threadIdx.x; c < KT * RC; c += S::THREADS) {
    const int j = c / RC, w = c % RC, key = k0 + j;
    const bool in = key < a.Sk;
    const T* src = w < KC ? kb + key * a.ks[1] + EPC * w : vb + key * a.vs[1] + EPC * (w - KC);
    T* dst = w < KC ? ksm + j * HP + EPC * w : vsm + j * VP + EPC * (w - KC);
    cp_async16(dst, in ? src : kb, in ? 16 : 0);
  }
  // tile `it` (head kvh·G + it / nq, rows qbeg + (it % nq)·QB …) into its stage
  auto load_tile = [&](int it) {
    const int h = kvh * G + it / nq, q0 = qbeg + (it % nq) * QB;
    T* qst = ring + (it % STAGES) * S::STAGE;
    T* dst_o = qst + QB * HP;
    const T* qb = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[2];
    const T* db = static_cast<const T*>(a.dout) + b * a.ds[0] + h * a.ds[2];
    for (int c = threadIdx.x; c < QB * RC; c += S::THREADS) {
      const int j = c / RC, w = c % RC, row = q0 + j;
      const bool in = row < a.Sq;
      const T* src = w < KC ? qb + row * a.qs[1] + EPC * w : db + row * a.ds[1] + EPC * (w - KC);
      T* dst = w < KC ? qst + j * HP + EPC * w : dst_o + j * VP + EPC * (w - KC);
      cp_async16(dst, in ? src : qb, in ? 16 : 0);
    }
    float* st = stats + (it % STAGES) * 2 * QB;
    const long long lrow = (static_cast<long long>(b) * a.H + h) * a.Sq;
    for (int i = threadIdx.x; i < 2 * QB; i += S::THREADS) {
      const int row = q0 + i % QB;
      const bool in = row < a.Sq;
      const float* src = (i < QB ? a.lse : a.dd) + lrow + row;
      cp_async4(st + i, in ? src : a.lse, in ? 4 : 0);
    }
  };
  if (ntiles > 0) load_tile(0);
  cp_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp % S::RG, cg = warp / S::RG;
  float dk[S::DKW / 8][4], dv[S::DVW / 8][4];
#pragma unroll
  for (int n = 0; n < S::DKW / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[n][j] = 0.f;
#pragma unroll
  for (int n = 0; n < S::DVW / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dv[n][j] = 0.f;

#pragma unroll 1
  for (int it = 0; it < ntiles; ++it) {
    cp_wait<0>();     // tile it has landed (this thread's copies)
    __syncthreads();  // everyone's (K and V too), and tile it - 1 is consumed
    if (it + 1 < ntiles) load_tile(it + 1);
    cp_commit();
    const T* qst = ring + (it % STAGES) * S::STAGE;
    const T* dost = qst + QB * HP;
    const float* st = stats + (it % STAGES) * 2 * QB;
    const int q0 = qbeg + (it % nq) * QB;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ on keys rg·16 …, queries cg·QW …
    float s[S::QW / 8][4], dp[S::QW / 8][4];
#pragma unroll
    for (int n = 0; n < S::QW / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = dp[n][j] = 0.f;
    warp_gemm<T, HD, S::QW / 8, false>(s, ksm + rg * 16 * HP, HP, qst + cg * S::QW * HP, HP, lane);
    warp_gemm<T, VD, S::QW / 8, false>(dp, vsm + rg * 16 * VP, VP, dost + cg * S::QW * VP, VP,
                                       lane);
    const int qw0 = q0 + cg * S::QW, kw0 = k0 + rg * 16;
    const bool whole = all_visible(a, qw0, qw0 + S::QW - 1, kw0, kw0 + 15);
#pragma unroll
    for (int n = 0; n < S::QW / 8; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int kl = rg * 16 + g + 8 * hf, ql = cg * S::QW + 8 * n + 2 * t;
        float p[2], dsv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dsv[e] = dp[n][2 * hf + e];
          prob(a, whole || visible(a, q0 + ql + e, k0 + kl), s[n][2 * hf + e],
               st[ql + e] * LOG2E, st[QB + ql + e], p[e], dsv[e]);
        }
        store2(psm + kl * QP + ql, p[0], p[1]);
        store2(dssm + kl * QP + ql, dsv[0], dsv[1]);
      }
    __syncthreads();
    // dV += Pᵀ·dO and dK += dSᵀ·Q on keys rg·16 …, columns cg·DVW … / cg·DKW …
    warp_gemm<T, QB, S::DVW / 8, true>(dv, psm + rg * 16 * QP, QP, dost + cg * S::DVW, VP, lane);
    warp_gemm<T, QB, S::DKW / 8, true>(dk, dssm + rg * 16 * QP, QP, qst + cg * S::DKW, HP, lane);
  }
  cp_wait<0>();

  // dK = scale · Σ dSᵀ·Q and dV, once, rows past Sk clipped
  T* dkb = static_cast<T*>(a.dk) + (static_cast<long long>(b) * a.Sk * a.KV + kvh) * HD;
  T* dvb = static_cast<T*>(a.dv) + (static_cast<long long>(b) * a.Sk * a.KV + kvh) * VD;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = k0 + rg * 16 + g + 8 * hf;
    if (key >= a.Sk) continue;
    const long long krow = static_cast<long long>(key) * a.KV;
#pragma unroll
    for (int n = 0; n < S::DKW / 8; ++n)
      store2(dkb + krow * HD + cg * S::DKW + 8 * n + 2 * t, a.scale * dk[n][2 * hf],
             a.scale * dk[n][2 * hf + 1]);
#pragma unroll
    for (int n = 0; n < S::DVW / 8; ++n)
      store2(dvb + krow * VD + cg * S::DVW + 8 * n + 2 * t, dv[n][2 * hf], dv[n][2 * hf + 1]);
  }
}

// ---------------------------------------------------------------------------
// dQ: one block a (b, head, QT query rows), a warp 16 rows.
// ---------------------------------------------------------------------------

template <typename T, int HD, int VD>
struct QShape {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int WARPS = F32 && HD >= 192 ? 4 : 8;
  static constexpr int THREADS = 32 * WARPS, QT = 16 * WARPS;
  // keys a tile (fp32 at (192, 128) spilled at 32)
  static constexpr int KB = HD <= 64 ? 64 : HD <= 128 || (!F32 && HD <= 192) ? 32 : 16;
  // bf16 up to hd 64: two blocks an SM within 128 registers (at one, 196
  // registers and 8.5 ms at TinyLlama's shape on an H100, at two 5.3 ms:
  // tools/flash_bwd_ab.py); fp32 spills there, and is slower
  static constexpr int MIN_BLOCKS = !F32 && HD <= 64 ? 2 : 1;
  static constexpr int PAD = Mma<T>::PAD;
  static constexpr int HP = HD + PAD, VP = VD + PAD;
  static constexpr int TILE = KB * (HP + VP);  // K, then V
  static constexpr int SMEM = static_cast<int>(sizeof(T)) * (QT * (HP + VP) + STAGES * TILE);
  static_assert(SMEM <= 232448, "shared memory");
};

template <typename T, int HD, int VD>
__global__ void __launch_bounds__(QShape<T, HD, VD>::THREADS, QShape<T, HD, VD>::MIN_BLOCKS)
    flash_bwd_dq_kernel(const __grid_constant__ Args a) {
  using S = QShape<T, HD, VD>;
  constexpr int KB = S::KB, QT = S::QT, HP = S::HP, VP = S::VP;
  constexpr int EPC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* qsm = reinterpret_cast<T*>(smem);  // [QT][HP]
  T* dosm = qsm + QT * HP;              // [QT][VP]
  T* ring = dosm + QT * VP;             // [STAGES]: K [KB][HP], V [KB][VP]

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QT;  // late (heavy) tiles first
  // the keys a row of the block sees
  const int qlast = min(q0 + QT, a.Sq) - 1;
  int kbeg = 0, kend = a.Sk;
  if (a.causal) {
    kend = min(a.Sk, qlast + 1);
    if (a.window > 0) kbeg = max(0, q0 - a.window + 1);
  }
  const int ntiles = kend > kbeg ? (kend - kbeg + KB - 1) / KB : 0;

  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + kvh * a.ks[2];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + kvh * a.vs[2];
  constexpr int KC = HD / EPC, RC = (HD + VD) / EPC;
  auto load_tile = [&](int it) {
    T* kst = ring + (it % STAGES) * S::TILE;
    T* vst = kst + KB * HP;
    const int key0 = kbeg + it * KB;
    for (int c = threadIdx.x; c < KB * RC; c += S::THREADS) {
      const int j = c / RC, w = c % RC, key = key0 + j;
      const bool in = key < kend;
      const T* src = w < KC ? kb + key * a.ks[1] + EPC * w : vb + key * a.vs[1] + EPC * (w - KC);
      T* dst = w < KC ? kst + j * HP + EPC * w : vst + j * VP + EPC * (w - KC);
      cp_async16(dst, in ? src : kb, in ? 16 : 0);
    }
  };
  {
    const T* qb = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[2];
    const T* db = static_cast<const T*>(a.dout) + b * a.ds[0] + h * a.ds[2];
    for (int c = threadIdx.x; c < QT * RC; c += S::THREADS) {
      const int j = c / RC, w = c % RC, row = q0 + j;
      const bool in = row < a.Sq;
      const T* src = w < KC ? qb + row * a.qs[1] + EPC * w : db + row * a.ds[1] + EPC * (w - KC);
      T* dst = w < KC ? qsm + j * HP + EPC * w : dosm + j * VP + EPC * (w - KC);
      cp_async16(dst, in ? src : qb, in ? 16 : 0);
    }
  }
  if (ntiles > 0) load_tile(0);
  cp_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;
  const long long lrow = (static_cast<long long>(b) * a.H + h) * a.Sq;
  const float lse0 = row0 < a.Sq ? a.lse[lrow + row0] * LOG2E : 0.f;
  const float lse1 = row1 < a.Sq ? a.lse[lrow + row1] * LOG2E : 0.f;
  const float d0 = row0 < a.Sq ? a.dd[lrow + row0] : 0.f;
  const float d1 = row1 < a.Sq ? a.dd[lrow + row1] : 0.f;
  const bool live = q0 + 16 * warp < a.Sq;
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;

#pragma unroll 1
  for (int it = 0; it < ntiles; ++it) {
    cp_wait<0>();
    __syncthreads();
    if (it + 1 < ntiles) load_tile(it + 1);
    cp_commit();
    if (!live) continue;  // a warp past the last row
    const T* kt = ring + (it % STAGES) * S::TILE;
    const T* vt = kt + KB * HP;
    const int t0 = kbeg + it * KB;
    float s[KB / 8][4], dsf[KB / 8][4];
#pragma unroll
    for (int n = 0; n < KB / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = dsf[n][j] = 0.f;
    warp_gemm<T, HD, KB / 8, false>(s, qsm + 16 * warp * HP, HP, kt, HP, lane);
    warp_gemm<T, VD, KB / 8, false>(dsf, dosm + 16 * warp * VP, VP, vt, VP, lane);
    const int rw0 = q0 + 16 * warp;
    const bool whole = all_visible(a, rw0, rw0 + 15, t0, t0 + KB - 1);
#pragma unroll
    for (int n = 0; n < KB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + 8 * n + 2 * t + (e & 1), row = e & 2 ? row1 : row0;
        float p;
        prob(a, whole || visible(a, row, key), s[n][e], e & 2 ? lse1 : lse0, e & 2 ? d1 : d0, p,
             dsf[n][e]);
      }
    // dQ += dS·K, the dS fragment as the A operand
    warp_gemm_c<T, KB, HD / 8>(acc, dsf, kt, HP, lane);
  }
  cp_wait<0>();
  if (!live) return;
  T* qo = static_cast<T*>(a.dq) + h * HD;
  const long long rs = static_cast<long long>(a.H) * HD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (row0 < a.Sq)
      store2(qo + (static_cast<long long>(b) * a.Sq + row0) * rs + c, a.scale * acc[n][0],
             a.scale * acc[n][1]);
    if (row1 < a.Sq)
      store2(qo + (static_cast<long long>(b) * a.Sq + row1) * rs + c, a.scale * acc[n][2],
             a.scale * acc[n][3]);
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA, one producer warpgroup and two consumers.
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int CONSUMERS = 2;                    // warpgroups of 64 rows
constexpr int THREADS = 128 * (CONSUMERS + 1);  // and one producer warpgroup
constexpr int QT = 64 * CONSUMERS;              // query rows a dQ block
constexpr int SMEM_MAX = 232448;                // a block's dynamic shared memory

// Stages of a TMA ring that fit beside `fixed` bytes of tiles, each stage
// `per` bytes with its two mbarriers: up to 4, so that three loads are in
// flight while one stage is used.
constexpr int ring_depth(int fixed, int per) {
  return (SMEM_MAX - 1024 - 8 - fixed) / per < 4 ? (SMEM_MAX - 1024 - 8 - fixed) / per : 4;
}

template <int HD, int VD>
struct Dims {
  static constexpr int HDP = HD < 64 ? 64 : HD;  // padded to one 64-wide box
  static constexpr int VDP = VD < 64 ? 64 : VD;
  static constexpr int HC = HDP / 64, VC = VDP / 64;  // boxes a row
  static_assert(HD % 16 == 0 && VD % 16 == 0, "dims are multiples of 16");
};

// The dK/dV kernel's tiles.  Narrow: each consumer holds 64 keys' dK and
// dV, (HDP + VDP) / 2 fp32 values a thread, beside its scores (of 32
// query rows a stage at (192, 128), whose dK and dV take 160); wide (hd
// 256: 256 values) they would not fit, so both consumers hold the same 64
// keys, each half of the queries' scores and half of the 64-wide output
// chunks.  (192, 128) in the wide form took deepseek's launch 7.48 ms on
// an H100, narrow 5.41 (tools/flash_bwd_ab.py).
template <int HD, int VD>
struct KvTile : Dims<HD, VD> {
  using D = Dims<HD, VD>;
  static constexpr bool WIDE = D::HDP + D::VDP > 320;
  static constexpr int KT = WIDE ? 64 : 64 * CONSUMERS;  // keys a block
  static constexpr int QB = D::HDP + D::VDP > 256 && !WIDE ? 32 : 64;  // query rows a stage
  static constexpr int NQ = WIDE ? QB / CONSUMERS : QB;  // a consumer's score columns
  // the 64-wide chunks of dK (first) and dV a consumer accumulates: all of
  // them, or (wide) every other one
  static constexpr int NA = WIDE ? (D::HC + D::VC + 1) / 2 : D::HC + D::VC;
  static constexpr int K_BYTES = KT * D::HDP * 2, V_BYTES = KT * D::VDP * 2;
  static constexpr int Q_BYTES = QB * D::HDP * 2, O_BYTES = QB * D::VDP * 2;
  static constexpr int STAGE = Q_BYTES + O_BYTES;  // Q, then dO
  static constexpr int STATS = 2 * QB * 4;         // lse · log2 e, then D, a stage
  static constexpr int P_BYTES = 64 * QB * 2;      // one bf16 Pᵀ or dSᵀ (wide)
  static constexpr int FIXED = K_BYTES + V_BYTES + (WIDE ? 4 * P_BYTES : 0);
  static constexpr int RING = ring_depth(FIXED, STAGE + STATS + 16);
  // tiles 1024-byte aligned (the swizzle's period), then the stats and
  // the mbarriers
  static constexpr int SMEM = 1024 + FIXED + RING * (STAGE + STATS) + 8 * (1 + 2 * RING);
  static_assert(RING >= 2 && SMEM <= SMEM_MAX, "shared memory");
  static_assert(!WIDE || QB == 64, "the P buffer's rows are one 128-byte swizzle row");
};

// The dQ kernel's tiles: KB keys a stage, so that a consumer's scores, dP
// and dQ (KB / 2 + KB / 2 + HDP / 2 fp32 values a thread) fit.
template <int HD, int VD>
struct QTile : Dims<HD, VD> {
  using D = Dims<HD, VD>;
  static constexpr int KB = D::HDP == 64 && D::VDP == 64 ? 128 : D::HDP == 256 ? 32 : 64;
  static constexpr int Q_BYTES = QT * D::HDP * 2, O_BYTES = QT * D::VDP * 2;
  static constexpr int K_BYTES = KB * D::HDP * 2, V_BYTES = KB * D::VDP * 2;
  static constexpr int STAGE = K_BYTES + V_BYTES;  // K, then V
  static constexpr int RING = ring_depth(Q_BYTES + O_BYTES, STAGE + 16);
  static constexpr int SMEM = 1024 + Q_BYTES + O_BYTES + RING * STAGE + 8 * (1 + 2 * RING);
  static_assert(RING >= 2 && SMEM <= SMEM_MAX, "shared memory");
};

// Whether no key kmin..kmax is visible to any row imin..imax: a
// consumer's tile it skips.
__device__ __forceinline__ bool none_visible(const Args& a, int imin, int imax, int kmin,
                                             int kmax) {
  return kmin >= a.Sk || imin >= a.Sq ||
         (a.causal && (kmin > imax || (a.window > 0 && kmax <= imin - a.window)));
}

// scale · log2 e, scale / cap and cap · log2 e, for prob_dt
struct Consts {
  float sl, sc, cl;
};

// p of one score x (the fp32 product q · k) and its row's lse · log2 e,
// as prob() computes it, the mask left to the caller; CAP: the cap's
// tanh first, and dt = 1 − tanh² (dS = p · dt · (dp − D)).
template <bool CAP>
__device__ __forceinline__ float prob_dt(float x, float lse2, const Consts& c, float& dt) {
  if constexpr (CAP) {
    const float th = tanhf(x * c.sc);
    dt = 1.f - th * th;
    return ex2(th * c.cl - lse2);
  } else {
    dt = 1.f;
    return ex2(x * c.sl - lse2);
  }
}

template <bool B>
using Flag = std::integral_constant<bool, B>;

// f(capped, masked) with both as compile-time flags, so that a tile's
// elementwise pass holds no per-element branch on the cap or the mask
template <typename F>
__device__ __forceinline__ void by_case(bool cap, bool whole, F&& f) {
  if (cap) {
    if (whole)
      f(Flag<true>{}, Flag<false>{});
    else
      f(Flag<true>{}, Flag<true>{});
  } else {
    if (whole)
      f(Flag<false>{}, Flag<false>{});
    else
      f(Flag<false>{}, Flag<true>{});
  }
}

__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CONSUMERS) : "memory");
}

// dK and dV: one block a (b, KV head, KT keys).
template <int HD, int VD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const __grid_constant__ Args a) {
  using S = KvTile<HD, VD>;
  constexpr int KT = S::KT, QB = S::QB, NQ = S::NQ, HC = S::HC, VC = S::VC, RING = S::RING;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sk = base;                      // K  [HC][KT][64]
  const uint32_t sv = sk + S::K_BYTES;           // V  [VC][KT][64]
  const uint32_t sp = sv + S::V_BYTES;           // wide: [2]: Pᵀ, dSᵀ [64][QB]
  const uint32_t ring = base + S::FIXED;         // [RING]: Q [HC][QB][64], dO [VC][QB][64]
  const uint32_t sst = ring + RING * S::STAGE;   // [RING]: lse · log2 e [QB], D [QB]
  float* stats = reinterpret_cast<float*>(smem_raw + (sst - raw));
  const uint32_t kvbar = sst + RING * S::STATS;  // K and V loaded
  const uint32_t full = kvbar + 8;               // [RING] a stage loaded
  const uint32_t empty = full + 8 * RING;        // [RING] a stage released

  const int b = blockIdx.x / a.KV, kvh = blockIdx.x % a.KV;
  const int G = a.H / a.KV;
  const int k0 = blockIdx.y * KT;  // early (heavy, under a causal mask) tiles first
  // the query rows that see a key of the block
  int qbeg = 0, qend = a.Sq;
  if (a.causal) {
    qbeg = min(k0, a.Sq);
    if (a.window > 0) qend = min(a.Sq, k0 + KT - 1 + a.window);
  }
  const int nq = qend > qbeg ? (qend - qbeg + QB - 1) / QB : 0;
  const int ntiles = G * nq;  // 0: no row sees the keys, dK = dV = 0

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < RING; ++s) {
      mbar_init(full + 8 * s, 1 + 32);         // the TMA's bytes and the stats' 32 lanes
      mbar_init(empty + 8 * s, 4 * CONSUMERS);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {  // the producer warpgroup: its first warp loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 4 * CONSUMERS && ntiles > 0) {
      if (lane == 0) {
        mbar_expect_tx(kvbar, S::K_BYTES + S::V_BYTES);
#pragma unroll 1
        for (int c = 0; c < HC; ++c) tma_load(sk + c * KT * 128, &tk, kvbar, 64 * c, kvh, k0, b, 0);
#pragma unroll 1
        for (int c = 0; c < VC; ++c) tma_load(sv + c * KT * 128, &tv, kvbar, 64 * c, kvh, k0, b, 0);
      }
#pragma unroll 1
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % RING;
        const int h = kvh * G + it / nq, q0 = qbeg + (it % nq) * QB;
        if (it >= RING) mbar_wait(empty + 8 * st, (it / RING + 1) & 1);  // the previous round's
        if (lane == 0) {
          const uint32_t qs = ring + st * S::STAGE;
          mbar_expect_tx(full + 8 * st, S::STAGE);
#pragma unroll 1
          for (int c = 0; c < HC; ++c)
            tma_load(qs + c * QB * 128, &tq, full + 8 * st, 64 * c, h, q0, b, 0);
#pragma unroll 1
          for (int c = 0; c < VC; ++c)
            tma_load(qs + S::Q_BYTES + c * QB * 128, &tdo, full + 8 * st, 64 * c, h, q0, b, 0);
        }
        float* sts = stats + st * 2 * QB;
        const long long lrow = (static_cast<long long>(b) * a.H + h) * a.Sq;
        for (int i = lane; i < 2 * QB; i += 32) {
          const int row = q0 + i % QB;
          sts[i] = row >= a.Sq ? 0.f : i < QB ? a.lse[lrow + row] * LOG2E : a.dd[lrow + row];
        }
        mbar_arrive(full + 8 * st);
      }
    }
    return;
  }
  // 128 · 24 + 256 · 240 registers: within the block's 384 · 168
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // a consumer warpgroup: keys kc0 .. kc0 + 63 (its fragment rows key0
  // and key1 = key0 + 8), query columns qc .. qc + NQ - 1 of a stage
  const int wgi = warp / 4;
  const int kc0 = S::WIDE ? k0 : k0 + 64 * wgi;
  const int key0 = kc0 + 16 * (warp % 4) + lane / 4, key1 = key0 + 8;
  const int col = 2 * (lane % 4);
  const int qc = S::WIDE ? NQ * wgi : 0;
  const uint32_t ka = sk + (kc0 - k0) * 128, va = sv + (kc0 - k0) * 128;

  float acc[S::NA][32];
#pragma unroll
  for (int n = 0; n < S::NA; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
  const Consts cs{a.scale * LOG2E, a.cap > 0.f ? a.scale / a.cap : 0.f, a.cap * LOG2E};
  auto release = [&](int st) {
    if (lane == 0) mbar_arrive(empty + 8 * st);
  };

  if (ntiles > 0) mbar_wait(kvbar, 0);
#pragma unroll 1
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % RING;
    const int q0 = qbeg + (it % nq) * QB;
    const uint32_t qs = ring + st * S::STAGE, os = qs + S::Q_BYTES;
    const float* sts = stats + st * 2 * QB;
    mbar_wait(full + 8 * st, (it / RING) & 1);
    // wide: the tile is skipped by both consumers or by neither
    if (none_visible(a, q0, q0 + QB - 1, kc0, kc0 + 63)) {
      if constexpr (S::WIDE) bar_consumers();  // one barrier a tile: the P buffers' turns hold
      release(st);
      continue;
    }
    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ on the consumer's keys and columns, two
    // groups: P is formed while dPᵀ runs
    float s[NQ / 2], dp[NQ / 2];
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      const uint32_t off = (kc % 4) * 32;  // 16 values along the swizzled row
      wgmma_ss<NQ>(s, desc(ka + (kc / 4) * KT * 128 + off, 16, 1024),
                   desc(qs + (kc / 4) * QB * 128 + qc * 128 + off, 16, 1024), kc > 0);
    }
    wg_commit();
#pragma unroll
    for (int kc = 0; kc < VD / 16; ++kc) {
      const uint32_t off = (kc % 4) * 32;
      wgmma_ss<NQ>(dp, desc(va + (kc / 4) * KT * 128 + off, 16, 1024),
                   desc(os + (kc / 4) * QB * 128 + qc * 128 + off, 16, 1024), kc > 0);
    }
    wg_commit();
    wg_wait<1>();  // Sᵀ
    pin(s);

    // Pᵀ in bf16 (narrow: values 8·kk .. 8·kk + 7 of the fragment, columns
    // 16·kk .. 16·kk + 15, as wgmma's register A operand; wide: into the
    // shared buffer), and p · dt in place of Sᵀ; lse by query column
    uint32_t pa[S::WIDE ? 1 : NQ / 16][4], da[S::WIDE ? 1 : NQ / 16][4];
    const uint32_t pb = sp + (it & 1) * 2 * S::P_BYTES;  // wide: Pᵀ, then dSᵀ
    uint8_t* pg = smem_raw + (pb - raw);
    by_case(a.cap > 0.f, all_visible(a, q0 + qc, q0 + qc + NQ - 1, kc0, kc0 + 63),
            [&](auto capped, auto masked) {
              constexpr bool CAP = decltype(capped)::value, MASKED = decltype(masked)::value;
#pragma unroll
              for (int i = 0; i < NQ / 2; i += 2) {
                const int ql = qc + 8 * (i / 4) + col;  // columns ql, ql + 1
                const int key = i & 2 ? key1 : key0;
                const float2 l2 = *reinterpret_cast<const float2*>(sts + ql);
                float dt0, dt1;
                float p0 = prob_dt<CAP>(s[i], l2.x, cs, dt0);
                float p1 = prob_dt<CAP>(s[i + 1], l2.y, cs, dt1);
                if constexpr (MASKED) {
                  if (!visible(a, q0 + ql, key)) p0 = 0.f;
                  if (!visible(a, q0 + ql + 1, key)) p1 = 0.f;
                }
                const uint32_t pp = pack_bf16(p0, p1);
                if constexpr (S::WIDE) {
                  const int r = key - kc0;  // the buffer's row, 128-byte swizzled
                  *reinterpret_cast<uint32_t*>(pg + r * 128 + ((((ql * 2) >> 4) ^ (r & 7)) << 4) +
                                               ((ql * 2) & 15)) = pp;
                } else {
                  pa[i / 8][(i % 8) / 2] = pp;
                }
                s[i] = CAP ? p0 * dt0 : p0;
                s[i + 1] = CAP ? p1 * dt1 : p1;
              }
            });
    if constexpr (!S::WIDE) {
      // dV += Pᵀ·dO, Pᵀ the register A operand, dO MN-major as it landed
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < QB / 16; ++kk)
#pragma unroll
        for (int c = 0; c < VC; ++c)
          wgmma_rs_n64(acc[HC + c], pa[kk], desc(os + c * QB * 128 + kk * 16 * 128, QB * 128, 1024),
                       1);
      wg_commit();
      wg_wait<1>();  // dPᵀ
    } else {
      wg_wait<0>();
    }
    pin(dp);
    // dSᵀ = p · dt · (dPᵀ − D), D by query column
#pragma unroll
    for (int i = 0; i < NQ / 2; i += 2) {
      const int ql = qc + 8 * (i / 4) + col;
      const float2 d2 = *reinterpret_cast<const float2*>(sts + QB + ql);
      const uint32_t pp = pack_bf16(s[i] * (dp[i] - d2.x), s[i + 1] * (dp[i + 1] - d2.y));
      if constexpr (S::WIDE) {
        const int r = (i & 2 ? key1 : key0) - kc0;
        *reinterpret_cast<uint32_t*>(pg + S::P_BYTES + r * 128 +
                                     ((((ql * 2) >> 4) ^ (r & 7)) << 4) + ((ql * 2) & 15)) = pp;
      } else {
        da[i / 8][(i % 8) / 2] = pp;
      }
    }
    if constexpr (!S::WIDE) {
      // dK += dSᵀ·Q, Q MN-major
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < QB / 16; ++kk)
#pragma unroll
        for (int c = 0; c < HC; ++c)
          wgmma_rs_n64(acc[c], da[kk], desc(qs + c * QB * 128 + kk * 16 * 128, QB * 128, 1024), 1);
      wg_commit();
      wg_wait<0>();
      pin(pa);
      pin(da);
    } else {
      // both consumers' halves of Pᵀ and dSᵀ are in the buffer (of two, by
      // the tile's parity); then each consumer's chunks of dK += dSᵀ·Q and
      // dV += Pᵀ·dO, both operands in shared memory.  Chunk wgi + 2n; a
      // consumer with one chunk fewer repeats its last (never stored), so
      // that no wgmma sits on a divergent path
      fence_async_shared();
      bar_consumers();
      wg_fence();
#pragma unroll
      for (int n = 0; n < S::NA; ++n) {
        const int j = min(wgi + 2 * n, HC + VC - 1);  // dK's chunks first, then dV's
        const uint32_t A = j < HC ? pb + S::P_BYTES : pb;
        const uint32_t Bm = j < HC ? qs + j * QB * 128 : os + (j - HC) * QB * 128;
#pragma unroll
        for (int kk = 0; kk < QB / 16; ++kk)
          wgmma_ss_n64_tb(acc[n], desc(A + kk * 32, 16, 1024),
                          desc(Bm + kk * 16 * 128, QB * 128, 1024), 1);
      }
      wg_commit();
      wg_wait<0>();
    }
#pragma unroll
    for (int n = 0; n < S::NA; ++n) pin(acc[n]);
    release(st);
  }

  // dK = scale · Σ dSᵀ·Q and dV, once, rows past Sk and columns past the
  // head dim clipped
  bf16* dkb = static_cast<bf16*>(a.dk) + (static_cast<long long>(b) * a.Sk * a.KV + kvh) * HD;
  bf16* dvb = static_cast<bf16*>(a.dv) + (static_cast<long long>(b) * a.Sk * a.KV + kvh) * VD;
#pragma unroll
  for (int n = 0; n < S::NA; ++n) {
    const int j = S::WIDE ? wgi + 2 * n : n;
    if (j >= HC + VC) continue;
    const bool is_k = j < HC;
    const int dim = is_k ? HD : VD, c0 = 64 * (is_k ? j : j - HC);
    const float f = is_k ? a.scale : 1.f;
    bf16* out = is_k ? dkb : dvb;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const int d = c0 + 8 * (i / 4) + col;
      if (d >= dim) continue;
      if (key0 < a.Sk)
        store2(out + static_cast<long long>(key0) * a.KV * dim + d, f * acc[n][i],
               f * acc[n][i + 1]);
      if (key1 < a.Sk)
        store2(out + static_cast<long long>(key1) * a.KV * dim + d, f * acc[n][i + 2],
               f * acc[n][i + 3]);
    }
  }
}

// dQ: one block a (b, head, QT query rows), a consumer 64 rows.
template <int HD, int VD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ Args a) {
  using S = QTile<HD, VD>;
  constexpr int KB = S::KB, HC = S::HC, VC = S::VC, RING = S::RING;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;                      // Q  [HC][QT][64]
  const uint32_t so = sq + S::Q_BYTES;           // dO [VC][QT][64]
  const uint32_t ring = so + S::O_BYTES;         // [RING]: K [HC][KB][64], V [VC][KB][64]
  const uint32_t qbar = ring + RING * S::STAGE;  // Q and dO loaded
  const uint32_t full = qbar + 8;                // [RING] a stage loaded
  const uint32_t empty = full + 8 * RING;        // [RING] a stage released

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QT;  // late (heavy) tiles first
  // the keys a row of the block sees
  const int qlast = min(q0 + QT, a.Sq) - 1;
  int kbeg = 0, kend = a.Sk;
  if (a.causal) {
    kend = min(a.Sk, qlast + 1);
    if (a.window > 0) kbeg = max(0, q0 - a.window + 1);
  }
  const int ntiles = kend > kbeg ? (kend - kbeg + KB - 1) / KB : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < RING; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {  // the producer warpgroup: one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 4 * CONSUMERS && lane == 0 && ntiles > 0) {
      mbar_expect_tx(qbar, S::Q_BYTES + S::O_BYTES);
#pragma unroll 1
      for (int c = 0; c < HC; ++c) tma_load(sq + c * QT * 128, &tq, qbar, 64 * c, h, q0, b, 0);
#pragma unroll 1
      for (int c = 0; c < VC; ++c) tma_load(so + c * QT * 128, &tdo, qbar, 64 * c, h, q0, b, 0);
#pragma unroll 1
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % RING;
        const int t0 = kbeg + it * KB;
        const uint32_t ks = ring + st * S::STAGE;
        if (it >= RING) mbar_wait(empty + 8 * st, (it / RING + 1) & 1);
        mbar_expect_tx(full + 8 * st, S::STAGE);
#pragma unroll 1
        for (int c = 0; c < HC; ++c)
          tma_load(ks + c * KB * 128, &tk, full + 8 * st, 64 * c, kvh, t0, b, 0);
#pragma unroll 1
        for (int c = 0; c < VC; ++c)
          tma_load(ks + S::K_BYTES + c * KB * 128, &tv, full + 8 * st, 64 * c, kvh, t0, b, 0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // a consumer warpgroup: rows rlo .. rlo + 63, the thread's row0 and
  // row1 = row0 + 8
  const int wgi = warp / 4;
  const int rlo = q0 + 64 * wgi;
  const int row0 = rlo + 16 * (warp % 4) + lane / 4, row1 = row0 + 8;
  const int col = 2 * (lane % 4);
  const long long lrow = (static_cast<long long>(b) * a.H + h) * a.Sq;
  const float lse0 = row0 < a.Sq ? a.lse[lrow + row0] * LOG2E : 0.f;
  const float lse1 = row1 < a.Sq ? a.lse[lrow + row1] * LOG2E : 0.f;
  const float d0 = row0 < a.Sq ? a.dd[lrow + row0] : 0.f;
  const float d1 = row1 < a.Sq ? a.dd[lrow + row1] : 0.f;
  const uint32_t qa = sq + 64 * wgi * 128, oa = so + 64 * wgi * 128;

  float dq[HC][32];
#pragma unroll
  for (int c = 0; c < HC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[c][i] = 0.f;
  const Consts cs{a.scale * LOG2E, a.cap > 0.f ? a.scale / a.cap : 0.f, a.cap * LOG2E};
  auto release = [&](int st) {
    if (lane == 0) mbar_arrive(empty + 8 * st);
  };

  if (ntiles > 0) mbar_wait(qbar, 0);
#pragma unroll 1
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % RING;
    const int t0 = kbeg + it * KB;
    const uint32_t ks = ring + st * S::STAGE, vs = ks + S::K_BYTES;
    mbar_wait(full + 8 * st, (it / RING) & 1);
    if (none_visible(a, rlo, rlo + 63, t0, t0 + KB - 1)) {
      release(st);
      continue;
    }
    // S = Q·Kᵀ and dP = dO·Vᵀ, two groups: P is formed while dP runs
    float s[KB / 2], dp[KB / 2];
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      const uint32_t off = (kc % 4) * 32;
      wgmma_ss<KB>(s, desc(qa + (kc / 4) * QT * 128 + off, 16, 1024),
                   desc(ks + (kc / 4) * KB * 128 + off, 16, 1024), kc > 0);
    }
    wg_commit();
#pragma unroll
    for (int kc = 0; kc < VD / 16; ++kc) {
      const uint32_t off = (kc % 4) * 32;
      wgmma_ss<KB>(dp, desc(oa + (kc / 4) * QT * 128 + off, 16, 1024),
                   desc(vs + (kc / 4) * KB * 128 + off, 16, 1024), kc > 0);
    }
    wg_commit();
    wg_wait<1>();  // S
    pin(s);
    // p · dt in place of S
    by_case(a.cap > 0.f, all_visible(a, rlo, rlo + 63, t0, t0 + KB - 1),
            [&](auto capped, auto masked) {
              constexpr bool CAP = decltype(capped)::value, MASKED = decltype(masked)::value;
#pragma unroll
              for (int i = 0; i < KB / 2; ++i) {
                float dt;
                float p = prob_dt<CAP>(s[i], i & 2 ? lse1 : lse0, cs, dt);
                if constexpr (MASKED) {
                  if (!visible(a, i & 2 ? row1 : row0, t0 + 8 * (i / 4) + col + (i & 1))) p = 0.f;
                }
                s[i] = CAP ? p * dt : p;
              }
            });
    wg_wait<0>();  // dP
    pin(dp);
    // dS = p · dt · (dP − D) as wgmma's register A operand (values 8·kk ..
    // 8·kk + 7 of the fragment are keys 16·kk .. 16·kk + 15), then dQ +=
    // dS·K, K MN-major as it landed
    uint32_t da[KB / 16][4];
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        const float d = i & 2 ? d1 : d0;
        da[kk][r] = pack_bf16(s[i] * (dp[i] - d), s[i + 1] * (dp[i + 1] - d));
      }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk)
#pragma unroll
      for (int c = 0; c < HC; ++c)
        wgmma_rs_n64(dq[c], da[kk], desc(ks + c * KB * 128 + kk * 16 * 128, KB * 128, 1024), 1);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < HC; ++c) pin(dq[c]);
    pin(da);
    release(st);
  }

  bf16* qo = static_cast<bf16*>(a.dq) + h * HD;
  const long long rs = static_cast<long long>(a.H) * HD;
#pragma unroll
  for (int c = 0; c < HC; ++c)
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const int d = 64 * c + 8 * (i / 4) + col;
      if (d >= HD) continue;
      if (row0 < a.Sq)
        store2(qo + (static_cast<long long>(b) * a.Sq + row0) * rs + d, a.scale * dq[c][i],
               a.scale * dq[c][i + 1]);
      if (row1 < a.Sq)
        store2(qo + (static_cast<long long>(b) * a.Sq + row1) * rs + d, a.scale * dq[c][i + 2],
               a.scale * dq[c][i + 3]);
    }
}

// A (B, S, heads, dim) bf16 tensor's TMA map, read in boxes of 64 × rows:
// st its (batch, seq, head) element strides, 0 where the dim is 1 (taken
// as if packed there: TMA checks every stride, and never steps it).
bool tma_map(CUtensorMap* m, const void* ptr, int B, int S, int heads, int dim, const long long* st,
         int rows) {
  long long full[4];  // (outer, batch, seq, head)
  long long inner = dim;
  const int n[3] = {B, S, heads};
  for (int d = 2; d >= 0; --d) {
    full[1 + d] = n[d] > 1 ? st[d] : inner;
    inner = full[1 + d] * n[d];
  }
  full[0] = inner;
  return make_map(m, ptr, 1, B, S, heads, dim, full, rows);
}

template <int HD, int VD>
cudaError_t launch(const Args& a, cudaStream_t s) {
  using KS = KvTile<HD, VD>;
  using QS = QTile<HD, VD>;
  CUtensorMap kq, kk, kv, kdo, mq, mk, mv, mdo;
  if (!tma_map(&kq, a.q, a.B, a.Sq, a.H, HD, a.qs, KS::QB) ||
      !tma_map(&kk, a.k, a.B, a.Sk, a.KV, HD, a.ks, KS::KT) ||
      !tma_map(&kv, a.v, a.B, a.Sk, a.KV, VD, a.vs, KS::KT) ||
      !tma_map(&kdo, a.dout, a.B, a.Sq, a.H, VD, a.ds, KS::QB) ||
      !tma_map(&mq, a.q, a.B, a.Sq, a.H, HD, a.qs, QT) ||
      !tma_map(&mk, a.k, a.B, a.Sk, a.KV, HD, a.ks, QS::KB) ||
      !tma_map(&mv, a.v, a.B, a.Sk, a.KV, VD, a.vs, QS::KB) ||
      !tma_map(&mdo, a.dout, a.B, a.Sq, a.H, VD, a.ds, QT))
    return cudaErrorInvalidValue;
  const auto kvk = flash_bwd_dkdv_wgmma_kernel<HD, VD>;
  cudaError_t e = cudaFuncSetAttribute(kvk, cudaFuncAttributeMaxDynamicSharedMemorySize, KS::SMEM);
  if (e != cudaSuccess) return e;
  kvk<<<dim3(a.B * a.KV, (a.Sk + KS::KT - 1) / KS::KT), THREADS, KS::SMEM, s>>>(kq, kk, kv, kdo,
                                                                               a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const auto dqk = flash_bwd_dq_wgmma_kernel<HD, VD>;
  e = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, QS::SMEM);
  if (e != cudaSuccess) return e;
  dqk<<<dim3(a.B * a.H, (a.Sq + QT - 1) / QT), THREADS, QS::SMEM, s>>>(mq, mk, mv, mdo, a);
  return cudaGetLastError();
}

}  // namespace wg

// D, then dK and dV, then dQ, on one stream: bf16 on wgmma, fp32 in
// three TF32 products.
template <typename T, int HD, int VD>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const long long rows = static_cast<long long>(a.B) * a.H * a.Sq;
  flash_bwd_dot_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if constexpr (std::is_same<T, bf16>::value) {
    return wg::launch<HD, VD>(a, s);
  } else {
    using KS = KvShape<T, HD, VD>;
    const auto kv = flash_bwd_dkdv_kernel<T, HD, VD>;
    e = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize, KS::SMEM);
    if (e != cudaSuccess) return e;
    kv<<<dim3(a.B * a.KV, (a.Sk + KS::KT - 1) / KS::KT), KS::THREADS, KS::SMEM, s>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;

    using QS = QShape<T, HD, VD>;
    const auto dq = flash_bwd_dq_kernel<T, HD, VD>;
    e = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, QS::SMEM);
    if (e != cudaSuccess) return e;
    dq<<<dim3(a.B * a.H, (a.Sq + QS::QT - 1) / QS::QT), QS::THREADS, QS::SMEM, s>>>(a);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch_dims(const Args& a, int hd, int vd, cudaStream_t s) {
  if (hd == vd) {
    switch (hd) {
      case 16: return launch<T, 16, 16>(a, s);
      case 32: return launch<T, 32, 32>(a, s);
      case 64: return launch<T, 64, 64>(a, s);
      case 128: return launch<T, 128, 128>(a, s);
      case 256: return launch<T, 256, 256>(a, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (hd == 192 && vd == 128) return launch<T, 192, 128>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// The backward of flash_attn_fwd's training launch (q_offset 0, kv_len Sk,
// no shards): q (B, Sq, H, hd), k (B, Sk, KV, hd), v (B, Sk, KV, vd), o and
// dout (B, Sq, H, vd), all of dtype (0 = fp32, 1 = bf16) at the (hd, vd)
// pairs (16, 16), (32, 32), (64, 64), (128, 128), (256, 256) and (192,
// 128); strides holds the (batch, seq, head) element strides of q, k, v,
// o and dout in that order, every base 16-byte aligned and every stride a
// multiple of 16 bytes, the last dim contiguous.  lse (B, H, Sq) fp32 is
// the forward's; dd (B, H, Sq) fp32 is scratch; dq (B, Sq, H, hd), dk (B,
// Sk, KV, hd) and dv (B, Sk, KV, vd) are written contiguous in dtype.
// Every query row must see a key.  Launches three kernels on stream and
// returns the first failing launch's cudaError_t (0 on success); launches
// nothing and returns cudaErrorInvalidValue for what it does not take.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* dd, void* dq, void* dk,
                              void* dv, int dtype, int hd, int vd, int B, int H, int KV, int Sq,
                              int Sk, const long long* strides, float scale, int causal,
                              float cap, int window, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Sk < 1 || window < 0 ||
      Sq > 65535 * 64 || Sk > 65535 * 32 || static_cast<long long>(B) * H > 2147483647LL ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per16 = dtype == 1 ? 8 : 4;
  for (int i = 0; i < 15; ++i)
    if (strides[i] % per16) return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {q, k, v, o, dout})
    if (reinterpret_cast<uintptr_t>(p) % 16) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.dd = static_cast<float*>(dd);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.Sq = Sq;
  a.Sk = Sk;
  a.vd = vd;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
    a.ds[i] = strides[12 + i];
  }
  a.scale = scale;
  a.cap = cap;
  a.causal = causal;
  a.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 1 ? launch_dims<bf16>(a, hd, vd, s)
                                     : launch_dims<float>(a, hd, vd, s));
}
