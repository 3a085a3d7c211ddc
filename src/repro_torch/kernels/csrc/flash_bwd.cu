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
// * flash_bwd_dot_kernel: D, bound by bytes (O and dO read once, D
//   written: 0.0814 ms at TinyLlama's bf16 launch).  A warp a row with
//   lane-strided 2-byte loads (two elements a lane at vd 64) and a
//   5-step shuffle tree reached 29 % of that bound.  This kernel gives
//   a row vd · size / 16 lanes (8 at bf16 vd 64, at most 32), each
//   loading its 16-byte chunks of O and dO, neighbouring lanes on
//   neighbouring addresses, so a warp takes several rows; each lane group
//   has DOT_ROWS rows' loads in flight before it sums any, and sums its
//   chunks in order, then the lanes by a fixed butterfly (the same bits
//   every launch).  flash_attn.py::attention_dot launches it alone;
//   tools/flash_bwd_ab.py --ab OLD NEW times it kernel by kernel.
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
// of the warp-level mma design this one replaced: bf16 P and dS (one
// bf16 each, not the forward's two halves: the gradients' bound is 2e-2
// of each one's largest, and tests/test_torch_flash_bwd.py emulates these
// rounding points and the tiles' summation order on the CPU within half
// of it), D from the bf16 output; the products sum 16-deep steps in the
// same order, so that without a cap the gradients keep that design's
// bits.
//
// fp32 (flash_bwd_dkdv_tf32_kernel, flash_bwd_dq_tf32_kernel; namespace
// tf): the same block, producer and rings on wgmma in TF32
// (m64nNk8.f32.tf32.tf32), each operand split into a TF32 big and small
// part (cvt.rna) and each product taken three times, small·big +
// big·small + big·big: what bounds it is three times the flops at TF32's
// 495 TFLOP/s.  TF32 wgmma reads both shared-memory operands K-major
// only (no transpose bit for 32-bit types), and TMA cannot transpose, so
// the producer's warps 1-3 split each tile once as it lands: the big part
// in place, the small part beside it and, for a tile that is also a
// product's B operand along its rows (dK/dV: Q and dO, for dK += dSᵀ·Q
// and dV += Pᵀ·dO; dQ: K, for dQ += dS·K), both parts transposed into
// planes of 128-byte rows, the rows in each 8 permuted (slot()) as the
// accumulator's columns become the register A operand; then it arrives
// on the stage's "ready" mbarrier, which the consumers wait on.  A
// consumer splits P and dS in registers.  dK/dV: 64 keys a block, both
// consumers on them, taking alternate stages of 32 query rows (at hd
// 128 halves of every stage of 16), their dK and dV added (consumer 0's
// plus 1's) through shared memory at the end; dQ: two consumers of 64
// rows (one at hd 128), 32 keys a stage (16 at hd 128).  S and dP sum in
// place over the head dim; dV, dK and dQ sum from 0 over a tile (a
// consumer's 32 query rows, 8 at hd 128; a stage's 32 keys, 16 at hd
// 128) and are then added in fp32: a tensor core aligns its addends to
// the largest and truncates, so a sum kept in place over a whole
// sequence would lose about an ulp of the total at every k-step, all one
// way (flash_attn.cu's fp32 forward saw 5e-5 on the log-sum-exp from
// in-place sums at hd 256).  Held in place over the head dim, S and dP
// stay within 1.4e-5 of the plain backward.
//
// At (256, 256) and (192, 128) (Wide; dkdv_wide, dq_wide) the split K and
// V of 64 keys (256 and 160 KB) leave no room for a stage, and the
// transposed planes are a stage's largest part.  So a block keeps its
// stationary tiles as they land (dK/dV: K and V of 64 keys, 128 and 80
// KB; dQ: Q and dO of 64 rows) and splits their k-step fragments in
// registers as the register A operand (a_raw), the streamed tile split
// once by the producer's warps as the B operand: Sᵀ = K·Qᵀ and dPᵀ =
// V·dOᵀ (dQ: S = Q·Kᵀ, dP = dO·Vᵀ) over stages of 16 query rows (dQ:
// keys).  The products along a stage's rows swap their operands, so that
// nothing is transposed: dVᵀ = dOᵀ·P and dKᵀ = Qᵀ·dS (dQ: dQᵀ = Kᵀ·dSᵀ),
// the A operand read from the stage's split tile by columns (a_t), B the
// consumer's P or dS written split into a 64-row buffer of 128-byte rows
// (a stage's 16 big parts, then its 16 small ones).  The two consumers
// take the roles: dK/dV's consumer 0 forms Sᵀ and P, hands p · dt to
// consumer 1 through shared memory (two buffers by parity, mbarriers full
// and empty) and sums dVᵀ; consumer 1 forms dPᵀ and dS and sums dKᵀ; dQ's
// consumer 0 forms S and P, consumer 1 dP and dS, which both read from a
// buffer (two by parity) to sum half of dQᵀ's 64-row tiles each.  A stage
// is announced twice (its first tile split, then its second), so that
// consumer 0 starts its scores before the split ends.  S and dP sum from
// 0 over each 128 of the head dim, the chunks then added in fp32; dV, dK
// and dQ sum from 0 over a stage (16 rows or keys) and are then added in
// fp32.  Shared memory: a ring of one stage at (256, 256) (64 KB), three
// at (192, 128).  What holds it back (the dQ kernel's clock64 phases,
// tools/flash_bwd_phases.py): the scores' 16-wide TF32 wgmmas, 27–52
// cycles each where the tensor cores' rate gives 7.7, and at (256, 256)
// the one stage's load and split between tiles.
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
using hopper::ex2;  // 2^x on the SFU (ftz: a probability below 2^-126 is 0)
using hopper::smem_u32;

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

// ---------------------------------------------------------------------------
// D = Σ_d dO · O: a row's 16-byte chunks of O and dO over L lanes, rows
// in (B, H, Sq) order (the note at the top of this file).
// ---------------------------------------------------------------------------

constexpr int DOT_THREADS = 256;
constexpr int DOT_ROWS = 4;  // rows a lane group has in flight

// The 8 bf16 or 4 fp32 values of a 16-byte chunk, x · y summed in order.
__device__ __forceinline__ float dot16(uint4 x, uint4 y, bf16) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
  }
  return acc;
}
__device__ __forceinline__ float dot16(uint4 x, uint4 y, float) {
  float acc = __uint_as_float(x.x) * __uint_as_float(y.x);
  acc = fmaf(__uint_as_float(x.y), __uint_as_float(y.y), acc);
  acc = fmaf(__uint_as_float(x.z), __uint_as_float(y.z), acc);
  return fmaf(__uint_as_float(x.w), __uint_as_float(y.w), acc);
}

template <typename T, int VD>
__global__ void __launch_bounds__(DOT_THREADS) flash_bwd_dot_kernel(const __grid_constant__ Args a) {
  constexpr int CH = VD * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks a row
  constexpr int L = CH < 32 ? CH : 32;                         // lanes a row
  constexpr int E = CH / L;                                    // chunks a lane
  constexpr int GROUPS = DOT_THREADS / L;                      // rows a block at once
  const long long rows = static_cast<long long>(a.B) * a.H * a.Sq;
  const int grp = threadIdx.x / L, lane = threadIdx.x % L;
  const long long r0 = static_cast<long long>(blockIdx.x) * GROUPS * DOT_ROWS + grp;
  // every load of the thread's rows issued before any is used
  uint4 xo[DOT_ROWS][E], xd[DOT_ROWS][E];
#pragma unroll
  for (int j = 0; j < DOT_ROWS; ++j) {
    const long long r = r0 + static_cast<long long>(j) * GROUPS;
    const bool in = r < rows;
    const int i = in ? static_cast<int>(r % a.Sq) : 0;
    const int h = in ? static_cast<int>((r / a.Sq) % a.H) : 0;
    const int b = in ? static_cast<int>(r / (static_cast<long long>(a.Sq) * a.H)) : 0;
    const uint4* o = reinterpret_cast<const uint4*>(static_cast<const T*>(a.o) + b * a.os[0] +
                                                    i * a.os[1] + h * a.os[2]);
    const uint4* d = reinterpret_cast<const uint4*>(static_cast<const T*>(a.dout) + b * a.ds[0] +
                                                    i * a.ds[1] + h * a.ds[2]);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      xo[j][e] = in ? __ldg(o + lane + L * e) : make_uint4(0u, 0u, 0u, 0u);
      xd[j][e] = in ? __ldg(d + lane + L * e) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // each lane's chunks in order, then the L lanes by a fixed butterfly:
  // the same bits every launch
#pragma unroll
  for (int j = 0; j < DOT_ROWS; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc += dot16(xo[j][e], xd[j][e], T());
#pragma unroll
    for (int sh = L / 2; sh >= 1; sh /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, sh);
    const long long r = r0 + static_cast<long long>(j) * GROUPS;
    if (lane == 0 && r < rows) a.dd[r] = acc;
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

// p of one score x (the fp32 product q · k) and its row's lse · log2 e:
// 2^(x · scale · log2 e − lse · log2 e), the exponent the bf16 forward's,
// the mask left to the caller; CAP: the cap's tanh first, p = 2^(tanh(x ·
// scale / cap) · cap · log2 e − lse · log2 e), and dt = 1 − tanh² (dS =
// p · dt · (dp − D)).
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

// ---------------------------------------------------------------------------
// fp32: 3xTF32 on wgmma, fed by TMA; each tile split once in shared memory.
// ---------------------------------------------------------------------------

namespace tf {

using namespace hopper;
using wg::by_case;
using wg::Consts;
using wg::none_visible;
using wg::prob_dt;
using wg::ring_depth;

constexpr int SPLITTERS = 96;  // the producer's warps 1-3 split what lands
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// D (64 × N, fp32) (+)= A · B in TF32: A and B fp32 in shared memory, both
// K-major (the only TF32 layout), or A in registers (m64k8: thread (g, t)
// of warp w holds rows 16w + g and + 8, k-slots t and t + 4).
__device__ __forceinline__ void wgmma_tf32_ss_n8(float (&d)[4], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3},"
      " %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_ss_n16(float (&d)[8], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (N == 32) {
    wgmma_tf32_ss_n32(d, da, db, accumulate);
  } else if constexpr (N == 16) {
    wgmma_tf32_ss_n16(d, da, db, accumulate);
  } else {
    static_assert(N == 8, "score tiles of 8 to 32 columns");
    wgmma_tf32_ss_n8(d, da, db, accumulate);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  if constexpr (N == 64) {
    wgmma_tf32_rs_n64(d, a, db, accumulate);
  } else if constexpr (N == 32) {
    wgmma_tf32_rs_n32(d, a, db, accumulate);
  } else {
    static_assert(N == 16, "output chunks of 16 to 64 columns");
    wgmma_tf32_rs_n16(d, a, db, accumulate);
  }
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (the file's tf32())
__device__ __forceinline__ float rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// Byte offset of column c (< 32) of row r in a tile of 128-byte rows,
// 128-byte swizzled (the TMA's layout, from a 1024-aligned base).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2));
}

// The k-slot of row r in a transposed plane: in each 8, row 2u at slot u
// and row 2u + 1 at slot u + 4, the order in which an accumulator's
// columns become the register A operand (a_from_c's permutation).
__device__ __forceinline__ int slot(int r) {
  return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
}

// The register A operand of one k-step from four accumulator values of
// the thread (c[e], e = 0 .. 3: columns 2t, 2t + 1 of row g, then of row
// g + 8) split into TF32 big and small parts: k-slot t takes column 2t,
// k-slot t + 4 column 2t + 1 (slot()'s order).
__device__ __forceinline__ void a_split(uint32_t (&big)[4], uint32_t (&small)[4],
                                        const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float b = rna(x[e]);
    big[e] = __float_as_uint(b);
    small[e] = __float_as_uint(rna(x[e] - b));
  }
}

// a where FIRST, else b (one name for either of two arrays)
template <bool FIRST, typename A, typename B>
__device__ __forceinline__ auto& pick(A& a, B& b) {
  if constexpr (FIRST)
    return a;
  else
    return b;
}

// Splits rows 0 .. R - 1 of a landed K-major tile of W real columns
// (boxes of 32 columns, R · 128 bytes apart, at `raw`): each value x
// becomes big = tf32(x) in place and small = tf32(x − big) at the same
// offset from `sm`; with tb, also big and small transposed into the
// planes tb and ts (row d holds column d, its k-slots the tile's rows in
// slot() order).  Thread i of n; consecutive threads take consecutive
// rows, so that both the 16-byte accesses and the transposed stores fall
// on distinct banks.
template <bool TRANSPOSE>
__device__ __forceinline__ void split_tile(uint8_t* raw, uint8_t* sm, uint8_t* tb, uint8_t* ts,
                                           int R, int W, int i, int n) {
  for (int w = i; w < R * (W / 4); w += n) {
    const int r = w % R, c4 = w / R;
    const uint32_t off = (c4 / 8) * R * 128 + swz(r, (c4 % 8) * 4);
    const float4 x = *reinterpret_cast<const float4*>(raw + off);
    const float4 big = make_float4(rna(x.x), rna(x.y), rna(x.z), rna(x.w));
    const float4 small =
        make_float4(rna(x.x - big.x), rna(x.y - big.y), rna(x.z - big.z), rna(x.w - big.w));
    *reinterpret_cast<float4*>(raw + off) = big;
    *reinterpret_cast<float4*>(sm + off) = small;
    if constexpr (TRANSPOSE) {
      const int p = slot(r), d = 4 * c4;
      *reinterpret_cast<float*>(tb + swz(d, p)) = big.x;
      *reinterpret_cast<float*>(tb + swz(d + 1, p)) = big.y;
      *reinterpret_cast<float*>(tb + swz(d + 2, p)) = big.z;
      *reinterpret_cast<float*>(tb + swz(d + 3, p)) = big.w;
      *reinterpret_cast<float*>(ts + swz(d, p)) = small.x;
      *reinterpret_cast<float*>(ts + swz(d + 1, p)) = small.y;
      *reinterpret_cast<float*>(ts + swz(d + 2, p)) = small.z;
      *reinterpret_cast<float*>(ts + swz(d + 3, p)) = small.w;
    }
  }
}

// The splitters' hand-off: their stores made visible to wgmma (the async
// proxy), then one arrival each.
__device__ __forceinline__ void split_done(uint32_t bar) {
  fence_async_shared();
  mbar_arrive(bar);
}

template <int HD, int VD>
struct Dims {
  static constexpr int HDP = HD < 32 ? 32 : HD;  // padded to one 32-wide box
  static constexpr int VDP = VD < 32 ? 32 : VD;
  static constexpr int HC = HDP / 32, VC = VDP / 32;  // boxes a row
  // the products' output chunks: 64 columns, or the whole dim below 64
  static constexpr int NK = HD < 64 ? HD : 64, NV = VD < 64 ? VD : 64;
  static constexpr int HN = HD / NK, VN = VD / NV;
  static_assert(HD % 16 == 0 && VD % 16 == 0, "dims are multiples of 16");
};

// The dK/dV kernel's tiles: 64 keys a block, both consumers on them,
// taking alternate stages of QB query rows whole (ALT), or at hd 128,
// whose ring holds one stage (a consumer must not wait two phases of an
// mbarrier ahead), each half of every stage; dK and dV of the block's
// keys are summed over the two consumers at the end.  K and V split once
// (big in place, small beside); a stage holds Q and dO as they land (big
// in place after the split), their small parts, and both transposed (big
// and small planes of 128-byte rows: at most 32 query rows).  Alternate
// stages give each score wgmma 32 columns for the A tile it reads, not
// 16: TinyLlama's fp32 launch on an H100 16.7 → 14.8 ms
// (tools/flash_bwd_ab.py).
template <int HD, int VD>
struct KvTile : Dims<HD, VD> {
  using D = Dims<HD, VD>;
  static constexpr int KT = 64;
  static constexpr int QB = D::HDP + D::VDP <= 128 ? 32 : 16;  // query rows a stage
  static constexpr int K_BYTES = KT * D::HDP * 4, V_BYTES = KT * D::VDP * 4;
  static constexpr int Q_BYTES = QB * D::HDP * 4, O_BYTES = QB * D::VDP * 4;
  static constexpr int QT_BYTES = HD * 128, OT_BYTES = VD * 128;
  // Q, small Q, dO, small dO, then Qᵀ big and small, dOᵀ big and small
  static constexpr int STAGE = 2 * (Q_BYTES + O_BYTES + QT_BYTES + OT_BYTES);
  static constexpr int STATS = 2 * QB * 4;  // lse · log2 e, then D
  static constexpr int FIXED = 2 * (K_BYTES + V_BYTES);
  static constexpr int RING = ring_depth(FIXED, STAGE + STATS + 24);
  static constexpr int SMEM = 1024 + FIXED + RING * (STAGE + STATS) + 8 * (2 + 3 * RING);
  static constexpr bool ALT = RING % wg::CONSUMERS == 0;
  static constexpr int NQ = ALT ? QB : QB / 2;  // a consumer's rows a stage
  // separate fresh sums for dV and dK a tile, or one shared (registers)
  static constexpr bool ONE_TMP = HD + VD > 128 || (ALT && HD + VD == 128);
  static_assert(RING >= 1 && SMEM <= wg::SMEM_MAX, "shared memory");
  static_assert(64 * (HD + VD) * 4 <= FIXED, "the halves' exchange fits where K and V were");
};

// The dQ kernel's tiles: CQ consumers of 64 rows (one at hd 128, whose Q
// and dO take 128 KB), KB keys a stage: K as it lands (big in place),
// its small part, both transposed, V and its small part.
template <int HD, int VD>
struct QTile : Dims<HD, VD> {
  using D = Dims<HD, VD>;
  static constexpr int CQ = HD + VD <= 128 ? 2 : 1;
  static constexpr int QT = 64 * CQ, THREADS = 128 * (CQ + 1);
  static constexpr int KB = HD + VD <= 128 ? 32 : 16;  // keys a stage
  static constexpr int Q_BYTES = QT * D::HDP * 4, O_BYTES = QT * D::VDP * 4;
  static constexpr int K_BYTES = KB * D::HDP * 4, V_BYTES = KB * D::VDP * 4;
  static constexpr int KT_BYTES = HD * 128;
  // K, small K, V, small V, Kᵀ big and small
  static constexpr int STAGE = 2 * (K_BYTES + V_BYTES + KT_BYTES);
  static constexpr int FIXED = 2 * (Q_BYTES + O_BYTES);
  static constexpr int RING = ring_depth(FIXED, STAGE + 24);
  static constexpr int SMEM = 1024 + FIXED + RING * STAGE + 8 * (2 + 3 * RING);
  static_assert(RING >= 1 && SMEM <= wg::SMEM_MAX, "shared memory");
};

// dK and dV at a narrow pair: one block a (b, KV head, 64 keys).
template <int HD, int VD>
__device__ __forceinline__ void dkdv_narrow(const CUtensorMap& tq, const CUtensorMap& tk,
                                            const CUtensorMap& tv, const CUtensorMap& tdo,
                                            const Args& a) {
  using S = KvTile<HD, VD>;
  constexpr int KT = S::KT, QB = S::QB, NQ = S::NQ, RING = S::RING;
  constexpr int HC = S::HC, VC = S::VC, NK = S::NK, NV = S::NV, HN = S::HN, VN = S::VN;
  constexpr int CONSUMERS = wg::CONSUMERS;
  // byte offsets from the 1024-aligned base: K, small K, V, small V, then
  // the ring; in a stage Q, small Q, dO, small dO, Qᵀ big and small, dOᵀ
  // big and small
  constexpr uint32_t KR = 0, KS = KR + S::K_BYTES, VR = KS + S::K_BYTES, VS = VR + S::V_BYTES;
  constexpr uint32_t QR = 0, QS = QR + S::Q_BYTES, OR = QS + S::Q_BYTES, OS = OR + S::O_BYTES;
  constexpr uint32_t QTB = OS + S::O_BYTES, QTS = QTB + S::QT_BYTES, OTB = QTS + S::QT_BYTES,
                     OTS = OTB + S::OT_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gb = smem_raw + (base - raw);                // base, as a generic pointer
  const uint32_t ring = base + S::FIXED;                // [RING] stages
  const uint32_t sst = ring + RING * S::STAGE;          // [RING]: lse · log2 e [QB], D [QB]
  float* stats = reinterpret_cast<float*>(smem_raw + (sst - raw));
  const uint32_t kvbar = sst + RING * S::STATS;         // K and V landed
  const uint32_t kvready = kvbar + 8;                   // K and V split
  const uint32_t full = kvready + 8;                    // [RING] a stage landed
  const uint32_t ready = full + 8 * RING;               // [RING] split, its stats written
  const uint32_t empty = ready + 8 * RING;              // [RING] released

  const int b = blockIdx.x / a.KV, kvh = blockIdx.x % a.KV;
  const int G = a.H / a.KV;
  const int k0 = blockIdx.y * KT;  // early (heavy, under a causal mask) tiles first
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
    mbar_init(kvready, SPLITTERS);
    for (int s = 0; s < RING; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(ready + 8 * s, SPLITTERS + 32);  // and the stats' 32 lanes
      mbar_init(empty + 8 * s, 4 * (S::ALT ? 1 : CONSUMERS));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (ntiles == 0) return;
    if (warp == 4 * CONSUMERS) {  // loads, and writes each stage's stats
      if (lane == 0) {
        mbar_expect_tx(kvbar, S::K_BYTES + S::V_BYTES);
#pragma unroll 1
        for (int c = 0; c < HC; ++c) tma_load(base + KR + c * KT * 128, &tk, kvbar, 32 * c, kvh, k0, b, 0);
#pragma unroll 1
        for (int c = 0; c < VC; ++c) tma_load(base + VR + c * KT * 128, &tv, kvbar, 32 * c, kvh, k0, b, 0);
      }
#pragma unroll 1
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % RING;
        const int h = kvh * G + it / nq, q0 = qbeg + (it % nq) * QB;
        if (it >= RING) mbar_wait(empty + 8 * st, (it / RING + 1) & 1);  // the previous round's
        if (lane == 0) {
          const uint32_t sb = ring + st * S::STAGE;
          mbar_expect_tx(full + 8 * st, S::Q_BYTES + S::O_BYTES);
#pragma unroll 1
          for (int c = 0; c < HC; ++c) tma_load(sb + QR + c * QB * 128, &tq, full + 8 * st, 32 * c, h, q0, b, 0);
#pragma unroll 1
          for (int c = 0; c < VC; ++c)
            tma_load(sb + OR + c * QB * 128, &tdo, full + 8 * st, 32 * c, h, q0, b, 0);
        }
        float* sts = stats + st * 2 * QB;
        const long long lrow = (static_cast<long long>(b) * a.H + h) * a.Sq;
        for (int i = lane; i < 2 * QB; i += 32) {
          const int row = q0 + i % QB;
          sts[i] = row >= a.Sq ? 0.f : i < QB ? a.lse[lrow + row] * LOG2E : a.dd[lrow + row];
        }
        mbar_arrive(ready + 8 * st);
      }
    } else {  // warps 1-3 split what lands: K and V once, then each stage
      const int i = threadIdx.x - 128 * CONSUMERS - 32;
      mbar_wait(kvbar, 0);
      split_tile<false>(gb + KR, gb + KS, nullptr, nullptr, KT, HD, i, SPLITTERS);
      split_tile<false>(gb + VR, gb + VS, nullptr, nullptr, KT, VD, i, SPLITTERS);
      split_done(kvready);
#pragma unroll 1
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % RING;
        mbar_wait(full + 8 * st, (it / RING) & 1);
        uint8_t* sg = gb + S::FIXED + st * S::STAGE;
        split_tile<true>(sg + QR, sg + QS, sg + QTB, sg + QTS, QB, HD, i, SPLITTERS);
        split_tile<true>(sg + OR, sg + OS, sg + OTB, sg + OTS, QB, VD, i, SPLITTERS);
        split_done(ready + 8 * st);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");

  // a consumer warpgroup: the block's 64 keys (its fragment rows key0 and
  // key1 = key0 + 8), query rows c0 .. c0 + NQ − 1 of a stage
  const int wgi = warp / 4;
  const int c0 = S::ALT ? 0 : wgi * NQ;
  const int key0 = k0 + 16 * (warp % 4) + lane / 4, key1 = key0 + 8;
  const int col = 2 * (lane % 4);
  float dk[HN][NK / 2], dv[VN][NV / 2];
#pragma unroll
  for (int c = 0; c < HN; ++c)
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) dk[c][i] = 0.f;
#pragma unroll
  for (int c = 0; c < VN; ++c)
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) dv[c][i] = 0.f;
  const Consts cs{a.scale * LOG2E, a.cap > 0.f ? a.scale / a.cap : 0.f, a.cap * LOG2E};
  auto release = [&](int st) {
    if (lane == 0) mbar_arrive(empty + 8 * st);
  };

  if (ntiles > 0) mbar_wait(kvready, 0);
#pragma unroll 1
  for (int it = S::ALT ? wgi : 0; it < ntiles; it += S::ALT ? CONSUMERS : 1) {
    const int st = it % RING;
    const int q0 = qbeg + (it % nq) * QB, r0 = q0 + c0;  // the consumer's rows r0 …
    const uint32_t sb = ring + st * S::STAGE;
    const float* sts = stats + st * 2 * QB;
    mbar_wait(ready + 8 * st, (it / RING) & 1);
    if (none_visible(a, r0, r0 + NQ - 1, k0, k0 + KT - 1)) {
      release(st);
      continue;
    }
    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ in three TF32 products a k-step (small·big,
    // big·small, big·big), two groups: P is formed while dPᵀ runs
    float s[NQ / 2], dp[NQ / 2];
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < HD / 8; ++kc) {
      const uint32_t ko = (kc / 4) * KT * 128 + (kc % 4) * 32;
      const uint32_t qo = (kc / 4) * QB * 128 + c0 * 128 + (kc % 4) * 32;
      wgmma_ss<NQ>(s, desc(base + KS + ko, 16, 1024), desc(sb + QR + qo, 16, 1024), kc > 0);
      wgmma_ss<NQ>(s, desc(base + KR + ko, 16, 1024), desc(sb + QS + qo, 16, 1024), 1);
      wgmma_ss<NQ>(s, desc(base + KR + ko, 16, 1024), desc(sb + QR + qo, 16, 1024), 1);
    }
    wg_commit();
#pragma unroll
    for (int kc = 0; kc < VD / 8; ++kc) {
      const uint32_t ko = (kc / 4) * KT * 128 + (kc % 4) * 32;
      const uint32_t oo = (kc / 4) * QB * 128 + c0 * 128 + (kc % 4) * 32;
      wgmma_ss<NQ>(dp, desc(base + VS + ko, 16, 1024), desc(sb + OR + oo, 16, 1024), kc > 0);
      wgmma_ss<NQ>(dp, desc(base + VR + ko, 16, 1024), desc(sb + OS + oo, 16, 1024), 1);
      wgmma_ss<NQ>(dp, desc(base + VR + ko, 16, 1024), desc(sb + OR + oo, 16, 1024), 1);
    }
    wg_commit();
    wg_wait<1>();  // Sᵀ
    pin(s);

    // Pᵀ split as the register A operand (k-step j: the consumer's query
    // columns 8j …), and p · dt in place of Sᵀ; lse by query column
    uint32_t pb[NQ / 8][4], ps[NQ / 8][4];
    by_case(a.cap > 0.f, all_visible(a, r0, r0 + NQ - 1, k0, k0 + KT - 1),
            [&](auto capped, auto masked) {
              constexpr bool CAP = decltype(capped)::value, MASKED = decltype(masked)::value;
#pragma unroll
              for (int j = 0; j < NQ / 8; ++j) {
                float pv[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int ql = c0 + 8 * j + col + (e & 1);  // the stage's row
                  float dt;
                  float p = prob_dt<CAP>(s[4 * j + e], sts[ql], cs, dt);
                  if constexpr (MASKED) {
                    if (!visible(a, q0 + ql, e & 2 ? key1 : key0)) p = 0.f;
                  }
                  pv[e] = p;
                  s[4 * j + e] = CAP ? p * dt : p;
                }
                a_split(pb[j], ps[j], pv);
              }
            });
    // dV += Pᵀ·dO, summed from 0 over the tile and added in fp32; dOᵀ's
    // planes hold the stage's rows in slot() order
    float dvt[VN][NV / 2];
    wg_fence();
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
      for (int c = 0; c < VN; ++c) {
        const uint32_t bo = c * NV * 128 + (c0 / 8 + j) * 32;
        wgmma_rs<NV>(dvt[c], ps[j], desc(sb + OTB + bo, 16, 1024), j > 0);
        wgmma_rs<NV>(dvt[c], pb[j], desc(sb + OTS + bo, 16, 1024), 1);
        wgmma_rs<NV>(dvt[c], pb[j], desc(sb + OTB + bo, 16, 1024), 1);
      }
    wg_commit();
    wg_wait<1>();  // dPᵀ
    pin(dp);
    // dSᵀ = p · dt · (dPᵀ − D), D by query column, split likewise
    uint32_t db[NQ / 8][4], dsm[NQ / 8][4];
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = s[4 * j + e] * (dp[4 * j + e] - sts[QB + c0 + 8 * j + col + (e & 1)]);
      a_split(db[j], dsm[j], v);
    }
    // dK += dSᵀ·Q likewise (hd 128: into dV's fresh sum once it is added)
    float dkt_own[S::ONE_TMP ? 1 : HN][S::ONE_TMP ? 1 : NK / 2];
    auto& dkt = pick<S::ONE_TMP>(dvt, dkt_own);
    if constexpr (S::ONE_TMP) {
      static_assert(HN == VN && NK == NV, "one fresh sum for dK and dV");
      wg_wait<0>();
#pragma unroll
      for (int c = 0; c < VN; ++c) {
        pin(dvt[c]);
#pragma unroll
        for (int i = 0; i < NV / 2; ++i) dv[c][i] += dvt[c][i];
      }
    }
    wg_fence();
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
      for (int c = 0; c < HN; ++c) {
        const uint32_t bo = c * NK * 128 + (c0 / 8 + j) * 32;
        wgmma_rs<NK>(dkt[c], dsm[j], desc(sb + QTB + bo, 16, 1024), j > 0);
        wgmma_rs<NK>(dkt[c], db[j], desc(sb + QTS + bo, 16, 1024), 1);
        wgmma_rs<NK>(dkt[c], db[j], desc(sb + QTB + bo, 16, 1024), 1);
      }
    wg_commit();
    wg_wait<0>();
    pin(pb);
    pin(ps);
    pin(db);
    pin(dsm);
#pragma unroll
    for (int c = 0; c < HN; ++c) {
      pin(dkt[c]);
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) dk[c][i] += dkt[c][i];
    }
    if constexpr (!S::ONE_TMP) {
#pragma unroll
      for (int c = 0; c < VN; ++c) {
        pin(dvt[c]);
#pragma unroll
        for (int i = 0; i < NV / 2; ++i) dv[c][i] += dvt[c][i];
      }
    }
    release(st);
  }

  // The halves summed, consumer 0's plus consumer 1's: consumer 1 hands
  // over its dK and stores dV, consumer 0 hands over its dV and stores
  // dK, through the space K and V took (every wgmma read of it is done).
  // dK = scale · Σ dSᵀ·Q; rows past Sk clipped.
  wg::bar_consumers();
  float* xk = reinterpret_cast<float*>(gb);  // [HD / 2][128]: consumer 1's dK
  float* xv = xk + (HD / 2) * 128;           // [VD / 2][128]: consumer 0's dV
  const int tid = threadIdx.x % 128;
  if (wgi == 1) {
#pragma unroll
    for (int c = 0; c < HN; ++c)
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) xk[(c * NK / 2 + i) * 128 + tid] = dk[c][i];
  } else {
#pragma unroll
    for (int c = 0; c < VN; ++c)
#pragma unroll
      for (int i = 0; i < NV / 2; ++i) xv[(c * NV / 2 + i) * 128 + tid] = dv[c][i];
  }
  wg::bar_consumers();
  const long long row0 = (static_cast<long long>(b) * a.Sk + key0) * a.KV + kvh;
  const long long row1 = row0 + 8LL * a.KV;
  if (wgi == 0) {
    float* out = static_cast<float*>(a.dk);
#pragma unroll
    for (int c = 0; c < HN; ++c)
#pragma unroll
      for (int i = 0; i < NK / 2; i += 4) {
        const int d = c * NK + 8 * (i / 4) + col;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = a.scale * (dk[c][i + e] + xk[(c * NK / 2 + i + e) * 128 + tid]);
        if (key0 < a.Sk) store2(out + row0 * HD + d, v[0], v[1]);
        if (key1 < a.Sk) store2(out + row1 * HD + d, v[2], v[3]);
      }
  } else {
    float* out = static_cast<float*>(a.dv);
#pragma unroll
    for (int c = 0; c < VN; ++c)
#pragma unroll
      for (int i = 0; i < NV / 2; i += 4) {
        const int d = c * NV + 8 * (i / 4) + col;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = xv[(c * NV / 2 + i + e) * 128 + tid] + dv[c][i + e];
        if (key0 < a.Sk) store2(out + row0 * VD + d, v[0], v[1]);
        if (key1 < a.Sk) store2(out + row1 * VD + d, v[2], v[3]);
      }
  }
}

// dQ at a narrow pair: one block a (b, head, QT query rows), a consumer 64
// rows.
template <int HD, int VD>
__device__ __forceinline__ void dq_narrow(const CUtensorMap& tq, const CUtensorMap& tk,
                                          const CUtensorMap& tv, const CUtensorMap& tdo,
                                          const Args& a) {
  using S = QTile<HD, VD>;
  constexpr int KB = S::KB, QT = S::QT, CQ = S::CQ, RING = S::RING;
  constexpr int HC = S::HC, VC = S::VC, NK = S::NK, HN = S::HN;
  // Q, small Q, dO, small dO, then the ring; in a stage K, small K, V,
  // small V, Kᵀ big and small
  constexpr uint32_t QR = 0, QS = QR + S::Q_BYTES, OR = QS + S::Q_BYTES, OS = OR + S::O_BYTES;
  constexpr uint32_t KR = 0, KS = KR + S::K_BYTES, VR = KS + S::K_BYTES, VS = VR + S::V_BYTES;
  constexpr uint32_t KTB = VS + S::V_BYTES, KTS = KTB + S::KT_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gb = smem_raw + (base - raw);
  const uint32_t ring = base + S::FIXED;
  const uint32_t qbar = ring + RING * S::STAGE;  // Q and dO landed
  const uint32_t qready = qbar + 8;              // Q and dO split
  const uint32_t full = qready + 8;              // [RING] a stage landed
  const uint32_t ready = full + 8 * RING;        // [RING] split
  const uint32_t empty = ready + 8 * RING;       // [RING] released

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QT;  // late (heavy) tiles first
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
    mbar_init(qready, SPLITTERS);
    for (int s = 0; s < RING; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(ready + 8 * s, SPLITTERS);
      mbar_init(empty + 8 * s, 4 * CQ);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * CQ) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (ntiles == 0) return;
    if (warp == 4 * CQ) {  // one thread loads
      if (lane == 0) {
        mbar_expect_tx(qbar, S::Q_BYTES + S::O_BYTES);
#pragma unroll 1
        for (int c = 0; c < HC; ++c) tma_load(base + QR + c * QT * 128, &tq, qbar, 32 * c, h, q0, b, 0);
#pragma unroll 1
        for (int c = 0; c < VC; ++c) tma_load(base + OR + c * QT * 128, &tdo, qbar, 32 * c, h, q0, b, 0);
#pragma unroll 1
        for (int it = 0; it < ntiles; ++it) {
          const int st = it % RING;
          const int t0 = kbeg + it * KB;
          const uint32_t sb = ring + st * S::STAGE;
          if (it >= RING) mbar_wait(empty + 8 * st, (it / RING + 1) & 1);
          mbar_expect_tx(full + 8 * st, S::K_BYTES + S::V_BYTES);
#pragma unroll 1
          for (int c = 0; c < HC; ++c) tma_load(sb + KR + c * KB * 128, &tk, full + 8 * st, 32 * c, kvh, t0, b, 0);
#pragma unroll 1
          for (int c = 0; c < VC; ++c) tma_load(sb + VR + c * KB * 128, &tv, full + 8 * st, 32 * c, kvh, t0, b, 0);
        }
      }
    } else {  // warps 1-3 split what lands: Q and dO once, then each stage
      const int i = threadIdx.x - 128 * CQ - 32;
      mbar_wait(qbar, 0);
      split_tile<false>(gb + QR, gb + QS, nullptr, nullptr, QT, HD, i, SPLITTERS);
      split_tile<false>(gb + OR, gb + OS, nullptr, nullptr, QT, VD, i, SPLITTERS);
      split_done(qready);
#pragma unroll 1
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % RING;
        mbar_wait(full + 8 * st, (it / RING) & 1);
        uint8_t* sg = gb + S::FIXED + st * S::STAGE;
        split_tile<true>(sg + KR, sg + KS, sg + KTB, sg + KTS, KB, HD, i, SPLITTERS);
        split_tile<false>(sg + VR, sg + VS, nullptr, nullptr, KB, VD, i, SPLITTERS);
        split_done(ready + 8 * st);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");

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

  float dq[HN][NK / 2];
#pragma unroll
  for (int c = 0; c < HN; ++c)
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) dq[c][i] = 0.f;
  const Consts cs{a.scale * LOG2E, a.cap > 0.f ? a.scale / a.cap : 0.f, a.cap * LOG2E};
  auto release = [&](int st) {
    if (lane == 0) mbar_arrive(empty + 8 * st);
  };

  if (ntiles > 0) mbar_wait(qready, 0);
#pragma unroll 1
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % RING;
    const int t0 = kbeg + it * KB;
    const uint32_t sb = ring + st * S::STAGE;
    mbar_wait(ready + 8 * st, (it / RING) & 1);
    if (none_visible(a, rlo, rlo + 63, t0, t0 + KB - 1)) {
      release(st);
      continue;
    }
    // S = Q·Kᵀ and dP = dO·Vᵀ in three TF32 products a k-step, two groups
    float s[KB / 2], dp[KB / 2];
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < HD / 8; ++kc) {
      const uint32_t qo = (kc / 4) * QT * 128 + wgi * 64 * 128 + (kc % 4) * 32;
      const uint32_t ko = (kc / 4) * KB * 128 + (kc % 4) * 32;
      wgmma_ss<KB>(s, desc(base + QS + qo, 16, 1024), desc(sb + KR + ko, 16, 1024), kc > 0);
      wgmma_ss<KB>(s, desc(base + QR + qo, 16, 1024), desc(sb + KS + ko, 16, 1024), 1);
      wgmma_ss<KB>(s, desc(base + QR + qo, 16, 1024), desc(sb + KR + ko, 16, 1024), 1);
    }
    wg_commit();
#pragma unroll
    for (int kc = 0; kc < VD / 8; ++kc) {
      const uint32_t oo = (kc / 4) * QT * 128 + wgi * 64 * 128 + (kc % 4) * 32;
      const uint32_t vo = (kc / 4) * KB * 128 + (kc % 4) * 32;
      wgmma_ss<KB>(dp, desc(base + OS + oo, 16, 1024), desc(sb + VR + vo, 16, 1024), kc > 0);
      wgmma_ss<KB>(dp, desc(base + OR + oo, 16, 1024), desc(sb + VS + vo, 16, 1024), 1);
      wgmma_ss<KB>(dp, desc(base + OR + oo, 16, 1024), desc(sb + VR + vo, 16, 1024), 1);
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
    // dS = p · dt · (dP − D) split as the register A operand (k-step j:
    // keys 8j …), then dQ += dS·K from Kᵀ's planes (keys in slot() order),
    // summed from 0 over the tile and added in fp32
    uint32_t db[KB / 8][4], dsm[KB / 8][4];
#pragma unroll
    for (int j = 0; j < KB / 8; ++j) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = s[4 * j + e] * (dp[4 * j + e] - (e & 2 ? d1 : d0));
      a_split(db[j], dsm[j], v);
    }
    float dqt[HN][NK / 2];
    wg_fence();
#pragma unroll
    for (int j = 0; j < KB / 8; ++j)
#pragma unroll
      for (int c = 0; c < HN; ++c) {
        const uint32_t bo = c * NK * 128 + j * 32;
        wgmma_rs<NK>(dqt[c], dsm[j], desc(sb + KTB + bo, 16, 1024), j > 0);
        wgmma_rs<NK>(dqt[c], db[j], desc(sb + KTS + bo, 16, 1024), 1);
        wgmma_rs<NK>(dqt[c], db[j], desc(sb + KTB + bo, 16, 1024), 1);
      }
    wg_commit();
    wg_wait<0>();
    pin(db);
    pin(dsm);
#pragma unroll
    for (int c = 0; c < HN; ++c) {
      pin(dqt[c]);
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) dq[c][i] += dqt[c][i];
    }
    release(st);
  }

  float* qo = static_cast<float*>(a.dq) + h * HD;
  const long long rs = static_cast<long long>(a.H) * HD;
#pragma unroll
  for (int c = 0; c < HN; ++c)
#pragma unroll
    for (int i = 0; i < NK / 2; i += 4) {
      const int d = c * NK + 8 * (i / 4) + col;
      if (row0 < a.Sq)
        store2(qo + (static_cast<long long>(b) * a.Sq + row0) * rs + d, a.scale * dq[c][i],
               a.scale * dq[c][i + 1]);
      if (row1 < a.Sq)
        store2(qo + (static_cast<long long>(b) * a.Sq + row1) * rs + d, a.scale * dq[c][i + 2],
               a.scale * dq[c][i + 3]);
    }
}

// ---------------------------------------------------------------------------
// fp32 at the wide pairs, (256, 256) and (192, 128): the stationary tiles
// as they land, split in registers; no transposed planes.
// ---------------------------------------------------------------------------

// The wide kernels' tiles, the same in both: 64 stationary rows a block
// (dK/dV: keys, K and V as they land; dQ: query rows, Q and dO), QB
// streamed rows a stage (dK/dV: query rows, Q and dO; dQ: keys, K and V),
// each split once into its big part (in place) and small part (beside
// it).  Buffers outside the ring: two 64-row, 128-byte-row tiles (dK/dV:
// Pᵀ and dSᵀ; dQ: dS by the use's parity), a row holding a stage's QB
// columns' big parts and then their small parts, and p · dt twice (by
// parity), fp32 in the consumers' fragment order.
template <int HD, int VD>
struct Wide : Dims<HD, VD> {
  using D = Dims<HD, VD>;
  static constexpr int KT = 64;  // stationary rows a block
  static constexpr int QB = 16;  // streamed rows a stage: 2 · QB columns fill a 128-byte row
  static constexpr int CH = 16;  // k-steps (128 of the head dim) S and dP sum in place
  static constexpr int HN = HD / 64, VN = VD / 64;  // 64-row tiles of dKᵀ / dQᵀ and of dVᵀ
  static constexpr int FIXED = KT * (D::HDP + D::VDP) * 4;
  static constexpr int STAGE = 2 * QB * (D::HDP + D::VDP) * 4;
  static constexpr int STATS = 2 * QB * 4;  // dK/dV: lse · log2 e, then D
  static constexpr int BUF = KT * 128, PDT = KT * QB * 4;
  static constexpr int BUFS = 2 * BUF + 2 * PDT;
  static constexpr int BARS = 8 * 9;  // the fixed tiles', p · dt's and the dS buffers' mbarriers
  static constexpr int RING = ring_depth(FIXED + BUFS + BARS, STAGE + STATS + 32);
  static constexpr int SMEM = 1024 + FIXED + BUFS + RING * (STAGE + STATS + 32) + BARS;
  // offsets from the 1024-aligned base
  static constexpr uint32_t RING_OFF = FIXED, BUF_OFF = FIXED + RING * STAGE,
                            PDT_OFF = BUF_OFF + 2 * BUF, ST_OFF = PDT_OFF + 2 * PDT,
                            BAR_OFF = ST_OFF + RING * STATS;
  // in a stage: the first tile (Q or K) big and small, then the second (dO or V)
  static constexpr uint32_t AB = 0, AS = QB * D::HC * 128, BB = 2 * AS, BS = BB + QB * D::VC * 128;
  static_assert(HD % 64 == 0 && VD % 64 == 0 && 2 * QB * 4 == 128, "tiles");
  static_assert(RING >= 1 && SMEM <= wg::SMEM_MAX, "shared memory");
};

__device__ __forceinline__ float ld_f(const uint8_t* p) { return *reinterpret_cast<const float*>(p); }
__device__ __forceinline__ uint32_t ld_u(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ void st_f(uint8_t* p, float x) { *reinterpret_cast<float*>(p) = x; }

// A named barrier of one consumer warpgroup's 128 threads.
__device__ __forceinline__ void bar_wg(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// The register A operand of k-step kc (columns 8kc …) of rows r and r + 8
// of a tile as it landed (R rows a 32-column box, at p), split into TF32
// big and small parts: k-slot t takes column 8kc + t, k-slot t + 4
// column 8kc + t + 4.
template <int R>
__device__ __forceinline__ void a_raw(uint32_t (&big)[4], uint32_t (&small)[4], const uint8_t* p,
                                      int r, int kc, int t) {
  const uint8_t* box = p + (kc / 4) * R * 128;
  const int c = (kc % 4) * 8 + t;
  const float x[4] = {ld_f(box + swz(r, c)), ld_f(box + swz(r + 8, c)), ld_f(box + swz(r, c + 4)),
                      ld_f(box + swz(r + 8, c + 4))};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float b = rna(x[e]);
    big[e] = __float_as_uint(b);
    small[e] = __float_as_uint(rna(x[e] - b));
  }
}

// The register A operand of k-step j of Xᵀ, X a stage's tile of R rows
// (32-column boxes of R rows) split into big (at xb) and small (at xs):
// rows d and d + 8 of Xᵀ (columns of X), k-slots t and t + 4 the rows 8j +
// t and 8j + t + 4 of X.
template <int R>
__device__ __forceinline__ void a_t(uint32_t (&big)[4], uint32_t (&small)[4], const uint8_t* xb,
                                    const uint8_t* xs, int d, int j, int t) {
  const int r0 = 8 * j + t, r1 = r0 + 4, d1 = d + 8;
  const uint32_t o[4] = {(d / 32) * R * 128 + swz(r0, d % 32), (d1 / 32) * R * 128 + swz(r0, d1 % 32),
                         (d / 32) * R * 128 + swz(r1, d % 32), (d1 / 32) * R * 128 + swz(r1, d1 % 32)};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    big[e] = ld_u(xb + o[e]);
    small[e] = ld_u(xs + o[e]);
  }
}

// acc (64 × N) = A·Bᵀ over KS k-steps in three TF32 products a k-step
// (small·big, big·small, big·big): A rows r, r + 8 of a tile as it landed
// (R rows a box, at `at`), split in registers (a_raw); B a stage's tile
// of N rows, big at bb and small at bs.  Summed in place from 0 over
// each CH k-steps (a chunk of the head dim), the chunks then added in
// fp32.  NB k-steps' fragments are in flight, each held until its wgmma
// is done.
template <int N, int KS, int R, int CH>
__device__ __forceinline__ void scores(float (&acc)[N / 2], const uint8_t* at, int r, int t,
                                       uint32_t bb, uint32_t bs) {
  constexpr int NCH = (KS + CH - 1) / CH, NB = 4;
  float part[NCH][N / 2];
  uint32_t fb[NB][4], fs[NB][4];
#pragma unroll
  for (int kc = 0; kc < KS; ++kc) {
    const int u = kc % NB;
    if (kc >= NB) {
      wg_wait<NB - 1>();  // k-step kc − NB is done with fb[u] and fs[u]
      pin(fb);
      pin(fs);
    }
    a_raw<R>(fb[u], fs[u], at, r, kc, t);
    wg_fence();
    const uint32_t off = (kc / 4) * N * 128 + (kc % 4) * 32;
    wgmma_rs<N>(part[kc / CH], fs[u], desc(bb + off, 16, 1024), kc % CH > 0);
    wgmma_rs<N>(part[kc / CH], fb[u], desc(bs + off, 16, 1024), 1);
    wgmma_rs<N>(part[kc / CH], fb[u], desc(bb + off, 16, 1024), 1);
    wg_commit();
  }
  wg_wait<0>();
  pin(fb);
  pin(fs);
#pragma unroll
  for (int c = 0; c < NCH; ++c) pin(part[c]);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    acc[i] = part[0][i];
#pragma unroll
    for (int c = 1; c < NCH; ++c) acc[i] += part[c][i];
  }
}

// acc[c] (64 × 64), c < COUNT, += Xᵀ·Y for the 64-row tiles C0 + c of Xᵀ
// (X's columns 64·(C0 + c) …), each summed from 0 over a stage's R rows
// in three TF32 products a k-step and then added in fp32, one tile at a
// time: X a stage's tile (big at xb, small at xs, R rows), Y the 64-row
// buffer at y (its row n holds Y's column n: R big parts, then R small
// parts).
template <int COUNT, int C0, int R, int NT>
__device__ __forceinline__ void tiles_t(float (&acc)[NT][32], const uint8_t* xb, const uint8_t* xs,
                                        int w, int g, int t, uint32_t y) {
  static_assert(COUNT <= NT, "tiles");
#pragma unroll
  for (int c = 0; c < COUNT; ++c) {
    uint32_t fb[R / 8][4], fs[R / 8][4];
#pragma unroll
    for (int j = 0; j < R / 8; ++j) a_t<R>(fb[j], fs[j], xb, xs, 64 * (C0 + c) + 16 * w + g, j, t);
    float tmp[32];
    wg_fence();
#pragma unroll
    for (int j = 0; j < R / 8; ++j) {
      wgmma_rs<64>(tmp, fs[j], desc(y + j * 32, 16, 1024), j > 0);
      wgmma_rs<64>(tmp, fb[j], desc(y + R * 4 + j * 32, 16, 1024), 1);
      wgmma_rs<64>(tmp, fb[j], desc(y + j * 32, 16, 1024), 1);
    }
    wg_commit();
    wg_wait<0>();
    pin(tmp);
    pin(fb);
    pin(fs);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] += tmp[i];
  }
}

// x's big part at column c and its small part at column R + c of row r
// of a 64-row, 128-byte-row buffer (the B operand tiles_t reads)
template <int R>
__device__ __forceinline__ void put_split(uint8_t* buf, int r, int c, float x) {
  const float b = rna(x);
  st_f(buf + swz(r, c), b);
  st_f(buf + swz(r, R + c), rna(x - b));
}

// dK and dV at a wide pair: one block a (b, KV head, 64 keys).  Consumer
// 0 forms Sᵀ = K·Qᵀ and P, hands p · dt to consumer 1 and sums dVᵀ +=
// dOᵀ·P; consumer 1 forms dPᵀ = V·dOᵀ and dS and sums dKᵀ += Qᵀ·dS.
template <int HD, int VD>
__device__ __forceinline__ void dkdv_wide(const CUtensorMap& tq, const CUtensorMap& tk,
                                          const CUtensorMap& tv, const CUtensorMap& tdo,
                                          const Args& a) {
  using S = Wide<HD, VD>;
  constexpr int KT = S::KT, QB = S::QB, RING = S::RING, HC = S::HC, VC = S::VC;
  constexpr uint32_t KR = 0, VR = KT * HC * 128;  // K and V as they land
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gb = smem_raw + (base - raw);
  const uint32_t ring = base + S::RING_OFF;
  const uint32_t pbuf = base + S::BUF_OFF, dsbuf = pbuf + S::BUF;  // Pᵀ, dSᵀ
  float* pdt = reinterpret_cast<float*>(gb + S::PDT_OFF);         // [2][QB / 2][128]
  float* stats = reinterpret_cast<float*>(gb + S::ST_OFF);        // [RING][2 · QB]
  const uint32_t kvbar = base + S::BAR_OFF;  // K and V landed
  const uint32_t pfull = kvbar + 8;          // [2] p · dt written
  const uint32_t pempty = pfull + 16;        // [2] p · dt read
  const uint32_t full = kvbar + S::BARS;     // [RING] a stage landed
  const uint32_t ready = full + 8 * RING;    // [RING] Q split, the stats written
  const uint32_t ready2 = ready + 8 * RING;  // [RING] dO split
  const uint32_t empty = ready2 + 8 * RING;  // [RING] released

  const int b = blockIdx.x / a.KV, kvh = blockIdx.x % a.KV;
  const int G = a.H / a.KV;
  const int k0 = blockIdx.y * KT;  // early (heavy, under a causal mask) tiles first
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
    for (int s = 0; s < 2; ++s) {
      mbar_init(pfull + 8 * s, 128);
      mbar_init(pempty + 8 * s, 128);
    }
    for (int s = 0; s < RING; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(ready + 8 * s, SPLITTERS + 32);  // and the stats' 32 lanes
      mbar_init(ready2 + 8 * s, SPLITTERS);
      mbar_init(empty + 8 * s, 4 * wg::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * wg::CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (ntiles == 0) return;
    if (warp == 4 * wg::CONSUMERS) {  // loads, and writes each stage's stats
      if (lane == 0) {
        mbar_expect_tx(kvbar, S::FIXED);
#pragma unroll 1
        for (int c = 0; c < HC; ++c) tma_load(base + KR + c * KT * 128, &tk, kvbar, 32 * c, kvh, k0, b, 0);
#pragma unroll 1
        for (int c = 0; c < VC; ++c) tma_load(base + VR + c * KT * 128, &tv, kvbar, 32 * c, kvh, k0, b, 0);
      }
#pragma unroll 1
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % RING;
        const int h = kvh * G + it / nq, q0 = qbeg + (it % nq) * QB;
        if (it >= RING) mbar_wait(empty + 8 * st, (it / RING + 1) & 1);  // the previous round's
        if (lane == 0) {
          const uint32_t sb = ring + st * S::STAGE;
          mbar_expect_tx(full + 8 * st, S::STAGE / 2);
#pragma unroll 1
          for (int c = 0; c < HC; ++c)
            tma_load(sb + S::AB + c * QB * 128, &tq, full + 8 * st, 32 * c, h, q0, b, 0);
#pragma unroll 1
          for (int c = 0; c < VC; ++c)
            tma_load(sb + S::BB + c * QB * 128, &tdo, full + 8 * st, 32 * c, h, q0, b, 0);
        }
        float* sts = stats + st * 2 * QB;
        const long long lrow = (static_cast<long long>(b) * a.H + h) * a.Sq;
        for (int i = lane; i < 2 * QB; i += 32) {
          const int row = q0 + i % QB;
          sts[i] = row >= a.Sq ? 0.f : i < QB ? a.lse[lrow + row] * LOG2E : a.dd[lrow + row];
        }
        mbar_arrive(ready + 8 * st);
      }
    } else {  // warps 1-3 split each stage as it lands
      const int i = threadIdx.x - 128 * wg::CONSUMERS - 32;
#pragma unroll 1
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % RING;
        mbar_wait(full + 8 * st, (it / RING) & 1);
        uint8_t* sg = gb + S::RING_OFF + st * S::STAGE;
        split_tile<false>(sg + S::AB, sg + S::AS, nullptr, nullptr, QB, HD, i, SPLITTERS);
        split_done(ready + 8 * st);
        split_tile<false>(sg + S::BB, sg + S::BS, nullptr, nullptr, QB, VD, i, SPLITTERS);
        split_done(ready2 + 8 * st);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");

  // a consumer warpgroup: fragment rows (keys) kl and kl + 8, stage
  // columns (query rows) 8j + 2t + (i & 1) of its value i
  const int wgi = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4, tid = threadIdx.x % 128;
  const int kl = 16 * w + g;
  constexpr int NT = S::VN > S::HN ? S::VN : S::HN;
  const int nt = wgi == 0 ? S::VN : S::HN;  // consumer 0: dVᵀ, 1: dKᵀ
  float acc[NT][32];
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  const Consts cs{a.scale * LOG2E, a.cap > 0.f ? a.scale / a.cap : 0.f, a.cap * LOG2E};
  auto release = [&](int st) {
    if (lane == 0) mbar_arrive(empty + 8 * st);
  };

  if (ntiles > 0) mbar_wait(kvbar, 0);
  int n = 0;  // tiles taken (both consumers take the same)
#pragma unroll 1
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % RING;
    const int q0 = qbeg + (it % nq) * QB;
    const uint32_t sb = ring + st * S::STAGE;
    const uint8_t* sg = gb + S::RING_OFF + st * S::STAGE;
    const float* sts = stats + st * 2 * QB;
    // consumer 0 starts on Q and the stats, consumer 1 waits for dO too
    mbar_wait(ready + 8 * st, (it / RING) & 1);
    if (wgi == 1) mbar_wait(ready2 + 8 * st, (it / RING) & 1);
    if (none_visible(a, q0, q0 + QB - 1, k0, k0 + KT - 1)) {
      mbar_wait(ready2 + 8 * st, (it / RING) & 1);  // the stage is split before it is released
      release(st);
      continue;
    }
    float* pq = pdt + (n & 1) * (QB / 2) * 128;
    if (wgi == 0) {
      float s[QB / 2];
      scores<QB, HD / 8, KT, S::CH>(s, gb + KR, kl, t, sb + S::AB, sb + S::AS);
      // P, and p · dt for consumer 1; lse by query column
      float pv[QB / 2];
      by_case(a.cap > 0.f, all_visible(a, q0, q0 + QB - 1, k0, k0 + KT - 1),
              [&](auto capped, auto masked) {
                constexpr bool CAP = decltype(capped)::value, MASKED = decltype(masked)::value;
#pragma unroll
                for (int i = 0; i < QB / 2; ++i) {
                  const int ql = 8 * (i / 4) + 2 * t + (i & 1), key = kl + 8 * ((i >> 1) & 1);
                  float dt;
                  float p = prob_dt<CAP>(s[i], sts[ql], cs, dt);
                  if constexpr (MASKED) {
                    if (!visible(a, q0 + ql, k0 + key)) p = 0.f;
                  }
                  pv[i] = p;
                  s[i] = CAP ? p * dt : p;
                }
              });
      if (n >= 2) mbar_wait(pempty + 8 * (n & 1), ((n >> 1) + 1) & 1);
#pragma unroll
      for (int i = 0; i < QB / 2; ++i) pq[i * 128 + tid] = s[i];
      mbar_arrive(pfull + 8 * (n & 1));
      // Pᵀ into its buffer once every warp's products of the last tile are done
      bar_wg(2);
#pragma unroll
      for (int i = 0; i < QB / 2; ++i)
        put_split<QB>(gb + S::BUF_OFF, kl + 8 * ((i >> 1) & 1), 8 * (i / 4) + 2 * t + (i & 1), pv[i]);
      fence_async_shared();
      bar_wg(2);
      mbar_wait(ready2 + 8 * st, (it / RING) & 1);
      // dVᵀ += dOᵀ·P
      tiles_t<S::VN, 0, QB>(acc, sg + S::BB, sg + S::BS, w, g, t, pbuf);
    } else {
      float dp[QB / 2];
      scores<QB, VD / 8, KT, S::CH>(dp, gb + VR, kl, t, sb + S::BB, sb + S::BS);
      // dS = p · dt · (dPᵀ − D), D by query column
      mbar_wait(pfull + 8 * (n & 1), (n >> 1) & 1);
#pragma unroll
      for (int i = 0; i < QB / 2; ++i) dp[i] = pq[i * 128 + tid] * (dp[i] - sts[QB + 8 * (i / 4) + 2 * t + (i & 1)]);
      mbar_arrive(pempty + 8 * (n & 1));
      bar_wg(3);
#pragma unroll
      for (int i = 0; i < QB / 2; ++i)
        put_split<QB>(gb + S::BUF_OFF + S::BUF, kl + 8 * ((i >> 1) & 1), 8 * (i / 4) + 2 * t + (i & 1),
                      dp[i]);
      fence_async_shared();
      bar_wg(3);
      // dKᵀ += Qᵀ·dS
      tiles_t<S::HN, 0, QB>(acc, sg + S::AB, sg + S::AS, w, g, t, dsbuf);
    }
    release(st);
    ++n;
  }

  // consumer 0 stores dV, consumer 1 dK = scale · Σ dSᵀ·Q; keys past Sk
  // clipped.  Value i of tile c: row 64c + kl + 8·((i >> 1) & 1) of dVᵀ or
  // dKᵀ, key k0 + 8·(i / 4) + 2t + (i & 1).
  float* out = static_cast<float*>(wgi == 0 ? a.dv : a.dk);
  const int dim = wgi == 0 ? VD : HD;
  const float f = wgi == 0 ? 1.f : a.scale;
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    if (c >= nt) break;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      if (key < a.Sk)
        out[((static_cast<long long>(b) * a.Sk + key) * a.KV + kvh) * dim + 64 * c + kl +
            8 * ((i >> 1) & 1)] = f * acc[c][i];
    }
  }
}

// dQ at a wide pair: one block a (b, head, 64 query rows).  Consumer 0
// forms S = Q·Kᵀ and P and hands p · dt to consumer 1, which forms dP =
// dO·Vᵀ and dS and writes dS into a buffer; consumer 0 sums the first
// HN / 2 tiles of dQᵀ += Kᵀ·dSᵀ, consumer 1 the others.
template <int HD, int VD>
__device__ __forceinline__ void dq_wide(const CUtensorMap& tq, const CUtensorMap& tk,
                                        const CUtensorMap& tv, const CUtensorMap& tdo,
                                        const Args& a) {
  using S = Wide<HD, VD>;
  constexpr int QT = S::KT, KB = S::QB, RING = S::RING, HC = S::HC, VC = S::VC;
  constexpr int H0 = S::HN / 2, H1 = S::HN - H0;  // consumer 0's tiles of dQᵀ, consumer 1's
  constexpr uint32_t QR = 0, OR = QT * HC * 128;  // Q and dO as they land
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gb = smem_raw + (base - raw);
  const uint32_t ring = base + S::RING_OFF;
  float* pdt = reinterpret_cast<float*>(gb + S::PDT_OFF);  // [2][KB / 2][128]
  const uint32_t qbar = base + S::BAR_OFF;  // Q and dO landed
  const uint32_t pfull = qbar + 8;          // [2] p · dt written
  const uint32_t pempty = pfull + 16;       // [2] p · dt read
  const uint32_t dsfull = pempty + 16;      // [2] dS written
  const uint32_t dsempty = dsfull + 16;     // [2] dS read
  const uint32_t full = qbar + S::BARS;      // [RING] a stage landed
  const uint32_t ready = full + 8 * RING;    // [RING] K split
  const uint32_t ready2 = ready + 8 * RING;  // [RING] V split
  const uint32_t empty = ready2 + 8 * RING;  // [RING] released

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QT;  // late (heavy) tiles first
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
    for (int s = 0; s < 2; ++s) {
      mbar_init(pfull + 8 * s, 128);
      mbar_init(pempty + 8 * s, 128);
      mbar_init(dsfull + 8 * s, 128);
      mbar_init(dsempty + 8 * s, 4 * wg::CONSUMERS);
    }
    for (int s = 0; s < RING; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(ready + 8 * s, SPLITTERS);
      mbar_init(ready2 + 8 * s, SPLITTERS);
      mbar_init(empty + 8 * s, 4 * wg::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * wg::CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (ntiles == 0) return;
    if (warp == 4 * wg::CONSUMERS) {  // one thread loads
      if (lane == 0) {
        mbar_expect_tx(qbar, S::FIXED);
#pragma unroll 1
        for (int c = 0; c < HC; ++c) tma_load(base + QR + c * QT * 128, &tq, qbar, 32 * c, h, q0, b, 0);
#pragma unroll 1
        for (int c = 0; c < VC; ++c) tma_load(base + OR + c * QT * 128, &tdo, qbar, 32 * c, h, q0, b, 0);
#pragma unroll 1
        for (int it = 0; it < ntiles; ++it) {
          const int st = it % RING;
          const int t0 = kbeg + it * KB;
          const uint32_t sb = ring + st * S::STAGE;
          if (it >= RING) mbar_wait(empty + 8 * st, (it / RING + 1) & 1);
          mbar_expect_tx(full + 8 * st, S::STAGE / 2);
#pragma unroll 1
          for (int c = 0; c < HC; ++c)
            tma_load(sb + S::AB + c * KB * 128, &tk, full + 8 * st, 32 * c, kvh, t0, b, 0);
#pragma unroll 1
          for (int c = 0; c < VC; ++c)
            tma_load(sb + S::BB + c * KB * 128, &tv, full + 8 * st, 32 * c, kvh, t0, b, 0);
        }
      }
    } else {  // warps 1-3 split each stage as it lands
      const int i = threadIdx.x - 128 * wg::CONSUMERS - 32;
#pragma unroll 1
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % RING;
        mbar_wait(full + 8 * st, (it / RING) & 1);
        uint8_t* sg = gb + S::RING_OFF + st * S::STAGE;
        split_tile<false>(sg + S::AB, sg + S::AS, nullptr, nullptr, KB, HD, i, SPLITTERS);
        split_done(ready + 8 * st);
        split_tile<false>(sg + S::BB, sg + S::BS, nullptr, nullptr, KB, VD, i, SPLITTERS);
        split_done(ready2 + 8 * st);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");

  // a consumer warpgroup: fragment rows (query rows) q0 + rl and + 8,
  // stage columns (keys) 8j + 2t + (i & 1) of its value i
  const int wgi = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4, tid = threadIdx.x % 128;
  const int rl = 16 * w + g, row0 = q0 + rl, row1 = row0 + 8;
  const long long lrow = (static_cast<long long>(b) * a.H + h) * a.Sq;
  const float lse0 = row0 < a.Sq ? a.lse[lrow + row0] * LOG2E : 0.f;
  const float lse1 = row1 < a.Sq ? a.lse[lrow + row1] * LOG2E : 0.f;
  const float d0 = row0 < a.Sq ? a.dd[lrow + row0] : 0.f;
  const float d1 = row1 < a.Sq ? a.dd[lrow + row1] : 0.f;
  float acc[H1][32];
#pragma unroll
  for (int c = 0; c < H1; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  const Consts cs{a.scale * LOG2E, a.cap > 0.f ? a.scale / a.cap : 0.f, a.cap * LOG2E};
  auto release = [&](int st) {
    if (lane == 0) mbar_arrive(empty + 8 * st);
  };

  if (ntiles > 0) mbar_wait(qbar, 0);
  int n = 0;  // tiles taken (both consumers take the same)
#pragma unroll 1
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % RING;
    const int t0 = kbeg + it * KB;
    const uint32_t sb = ring + st * S::STAGE;
    const uint8_t* sg = gb + S::RING_OFF + st * S::STAGE;
    // consumer 0 starts on K, consumer 1 waits for V too; both have seen
    // the stage split before they release it
    mbar_wait(ready + 8 * st, (it / RING) & 1);
    if (wgi == 1) mbar_wait(ready2 + 8 * st, (it / RING) & 1);
    if (none_visible(a, q0, q0 + QT - 1, t0, t0 + KB - 1)) {
      mbar_wait(ready2 + 8 * st, (it / RING) & 1);
      release(st);
      continue;
    }
    float* pq = pdt + (n & 1) * (KB / 2) * 128;
    const uint32_t dsb = base + S::BUF_OFF + (n & 1) * S::BUF;
    if (wgi == 0) {
      float s[KB / 2];
      scores<KB, HD / 8, QT, S::CH>(s, gb + QR, rl, t, sb + S::AB, sb + S::AS);
      by_case(a.cap > 0.f, all_visible(a, q0, q0 + QT - 1, t0, t0 + KB - 1),
              [&](auto capped, auto masked) {
                constexpr bool CAP = decltype(capped)::value, MASKED = decltype(masked)::value;
#pragma unroll
                for (int i = 0; i < KB / 2; ++i) {
                  float dt;
                  float p = prob_dt<CAP>(s[i], i & 2 ? lse1 : lse0, cs, dt);
                  if constexpr (MASKED) {
                    if (!visible(a, i & 2 ? row1 : row0, t0 + 8 * (i / 4) + 2 * t + (i & 1))) p = 0.f;
                  }
                  s[i] = CAP ? p * dt : p;
                }
              });
      if (n >= 2) mbar_wait(pempty + 8 * (n & 1), ((n >> 1) + 1) & 1);
#pragma unroll
      for (int i = 0; i < KB / 2; ++i) pq[i * 128 + tid] = s[i];
      mbar_arrive(pfull + 8 * (n & 1));
      mbar_wait(dsfull + 8 * (n & 1), (n >> 1) & 1);
      tiles_t<H0, 0, KB>(acc, sg + S::AB, sg + S::AS, w, g, t, dsb);
      mbar_wait(ready2 + 8 * st, (it / RING) & 1);
    } else {
      float dp[KB / 2];
      scores<KB, VD / 8, QT, S::CH>(dp, gb + OR, rl, t, sb + S::BB, sb + S::BS);
      // dS = p · dt · (dP − D), D by row
      mbar_wait(pfull + 8 * (n & 1), (n >> 1) & 1);
#pragma unroll
      for (int i = 0; i < KB / 2; ++i) dp[i] = pq[i * 128 + tid] * (dp[i] - (i & 2 ? d1 : d0));
      mbar_arrive(pempty + 8 * (n & 1));
      if (n >= 2) mbar_wait(dsempty + 8 * (n & 1), ((n >> 1) + 1) & 1);
#pragma unroll
      for (int i = 0; i < KB / 2; ++i)
        put_split<KB>(gb + S::BUF_OFF + (n & 1) * S::BUF, rl + 8 * ((i >> 1) & 1), 8 * (i / 4) + 2 * t + (i & 1),
                      dp[i]);
      fence_async_shared();
      mbar_arrive(dsfull + 8 * (n & 1));
      mbar_wait(dsfull + 8 * (n & 1), (n >> 1) & 1);
      tiles_t<H1, H0, KB>(acc, sg + S::AB, sg + S::AS, w, g, t, dsb);
    }
    if (lane == 0) mbar_arrive(dsempty + 8 * (n & 1));
    release(st);
    ++n;
  }

  // dQ = scale · Σ dS·K; value i of tile c: row 64·(c0 + c) + rl + 8·((i
  // >> 1) & 1) of dQᵀ (a head dim), query row q0 + 8·(i / 4) + 2t + (i & 1)
  const int c0 = wgi == 0 ? 0 : H0, nt = wgi == 0 ? H0 : H1;
  float* qo = static_cast<float*>(a.dq) + h * HD;
  const long long rs = static_cast<long long>(a.H) * HD;
#pragma unroll
  for (int c = 0; c < H1; ++c) {
    if (c >= nt) break;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = q0 + 8 * (i / 4) + 2 * t + (i & 1);
      if (row < a.Sq)
        qo[(static_cast<long long>(b) * a.Sq + row) * rs + 64 * (c0 + c) + rl + 8 * ((i >> 1) & 1)] =
            a.scale * acc[c][i];
    }
  }
}

// dK and dV: one block a (b, KV head, 64 keys).
template <int HD, int VD>
__global__ void __launch_bounds__(wg::THREADS, 1)
    flash_bwd_dkdv_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const __grid_constant__ Args a) {
  if constexpr (HD + VD > 256)
    dkdv_wide<HD, VD>(tq, tk, tv, tdo, a);
  else
    dkdv_narrow<HD, VD>(tq, tk, tv, tdo, a);
}

// dQ: one block a (b, head, query rows).
template <int HD, int VD>
__global__ void __launch_bounds__(wg::THREADS, 1)
    flash_bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ Args a) {
  if constexpr (HD + VD > 256)
    dq_wide<HD, VD>(tq, tk, tv, tdo, a);
  else
    dq_narrow<HD, VD>(tq, tk, tv, tdo, a);
}

// A (B, S, heads, dim) fp32 tensor's TMA map, read in boxes of 32 × rows
// (128 bytes, 128-byte swizzled; hd 16 zero-filled to 32): st its (batch,
// seq, head) element strides, 0 where the dim is 1 (wg::tma_map's rule).
bool tma_map(CUtensorMap* m, const void* ptr, int B, int S, int heads, int dim, const long long* st,
             int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  long long full[4];  // (outer, batch, seq, head)
  long long inner = dim;
  const int n[3] = {B, S, heads};
  for (int d = 2; d >= 0; --d) {
    full[1 + d] = n[d] > 1 ? st[d] : inner;
    inner = full[1 + d] * n[d];
  }
  full[0] = inner;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(dim), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B), 1};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(full[3]) * 4,
                                 static_cast<cuuint64_t>(full[2]) * 4,
                                 static_cast<cuuint64_t>(full[1]) * 4,
                                 static_cast<cuuint64_t>(full[0]) * 4};
  const cuuint32_t box[5] = {32, 1, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<void*>(ptr), dims, strides, box,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int VD>
cudaError_t launch(const Args& a, cudaStream_t s) {
  // the dK/dV kernel's stationary keys and streamed query rows, the dQ
  // kernel's stationary query rows and streamed keys
  int kt, qb, qt, kb, kv_smem, q_smem, q_threads;
  if constexpr (HD + VD > 256) {
    using W = Wide<HD, VD>;
    kt = qt = W::KT;
    qb = kb = W::QB;
    kv_smem = q_smem = W::SMEM;
    q_threads = wg::THREADS;
  } else {
    using KS = KvTile<HD, VD>;
    using QS = QTile<HD, VD>;
    kt = KS::KT;
    qb = KS::QB;
    qt = QS::QT;
    kb = QS::KB;
    kv_smem = KS::SMEM;
    q_smem = QS::SMEM;
    q_threads = QS::THREADS;
  }
  CUtensorMap kq, kk, kv, kdo, mq, mk, mv, mdo;
  if (!tma_map(&kq, a.q, a.B, a.Sq, a.H, HD, a.qs, qb) ||
      !tma_map(&kk, a.k, a.B, a.Sk, a.KV, HD, a.ks, kt) ||
      !tma_map(&kv, a.v, a.B, a.Sk, a.KV, VD, a.vs, kt) ||
      !tma_map(&kdo, a.dout, a.B, a.Sq, a.H, VD, a.ds, qb) ||
      !tma_map(&mq, a.q, a.B, a.Sq, a.H, HD, a.qs, qt) ||
      !tma_map(&mk, a.k, a.B, a.Sk, a.KV, HD, a.ks, kb) ||
      !tma_map(&mv, a.v, a.B, a.Sk, a.KV, VD, a.vs, kb) ||
      !tma_map(&mdo, a.dout, a.B, a.Sq, a.H, VD, a.ds, qt))
    return cudaErrorInvalidValue;
  const auto kvk = flash_bwd_dkdv_tf32_kernel<HD, VD>;
  cudaError_t e = cudaFuncSetAttribute(kvk, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (e != cudaSuccess) return e;
  kvk<<<dim3(a.B * a.KV, (a.Sk + kt - 1) / kt), wg::THREADS, kv_smem, s>>>(kq, kk, kv, kdo, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const auto dqk = flash_bwd_dq_tf32_kernel<HD, VD>;
  e = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, q_smem);
  if (e != cudaSuccess) return e;
  dqk<<<dim3(a.B * a.H, (a.Sq + qt - 1) / qt), q_threads, q_smem, s>>>(mq, mk, mv, mdo, a);
  return cudaGetLastError();
}

}  // namespace tf

// D = Σ dO · O into a.dd.
template <typename T, int VD>
cudaError_t launch_dot(const Args& a, cudaStream_t s) {
  const long long rows = static_cast<long long>(a.B) * a.H * a.Sq;
  constexpr int CH = VD * static_cast<int>(sizeof(T)) / 16;
  constexpr long long PER_BLOCK = DOT_THREADS / (CH < 32 ? CH : 32) * DOT_ROWS;
  flash_bwd_dot_kernel<T, VD><<<static_cast<unsigned>((rows + PER_BLOCK - 1) / PER_BLOCK),
                                DOT_THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

// D, then dK and dV, then dQ, on one stream: bf16 on wgmma, fp32 in
// three TF32 products on wgmma.
template <typename T, int HD, int VD>
cudaError_t launch(const Args& a, cudaStream_t s) {
  cudaError_t e = launch_dot<T, VD>(a, s);
  if (e != cudaSuccess) return e;
  if constexpr (std::is_same<T, bf16>::value)
    return wg::launch<HD, VD>(a, s);
  else
    return tf::launch<HD, VD>(a, s);
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

// D = Σ_d dO · O alone, the backward's first kernel: o and dout (B, Sq, H,
// vd) of dtype (0 = fp32, 1 = bf16) at vd 16, 32, 64, 128 or 256, strides
// their (batch, seq, head) element strides (o's, then dout's), every base
// 16-byte aligned and every stride a multiple of 16 bytes, the last dim
// contiguous; dd (B, H, Sq) fp32.  Returns the launch's cudaError_t (0 on
// success); launches nothing and returns cudaErrorInvalidValue for what
// it does not take.
extern "C" int flash_bwd_dot(const void* o, const void* dout, void* dd, int dtype, int vd, int B,
                             int H, int Sq, const long long* strides, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || (dtype != 0 && dtype != 1) ||
      static_cast<long long>(B) * H * Sq > 4LL * 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per16 = dtype == 1 ? 8 : 4;
  for (int i = 0; i < 6; ++i)
    if (strides[i] % per16) return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {o, dout})
    if (reinterpret_cast<uintptr_t>(p) % 16) return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.o = o;
  a.dout = dout;
  a.dd = static_cast<float*>(dd);
  a.B = B;
  a.H = H;
  a.Sq = Sq;
  a.vd = vd;
  for (int i = 0; i < 3; ++i) {
    a.os[i] = strides[i];
    a.ds[i] = strides[3 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (vd) {
    case 16: e = dtype == 1 ? launch_dot<bf16, 16>(a, s) : launch_dot<float, 16>(a, s); break;
    case 32: e = dtype == 1 ? launch_dot<bf16, 32>(a, s) : launch_dot<float, 32>(a, s); break;
    case 64: e = dtype == 1 ? launch_dot<bf16, 64>(a, s) : launch_dot<float, 64>(a, s); break;
    case 128: e = dtype == 1 ? launch_dot<bf16, 128>(a, s) : launch_dot<float, 128>(a, s); break;
    case 256: e = dtype == 1 ? launch_dot<bf16, 256>(a, s) : launch_dot<float, 256>(a, s); break;
    default: break;
  }
  return static_cast<int>(e);
}
