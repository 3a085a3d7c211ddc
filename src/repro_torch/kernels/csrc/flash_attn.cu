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
// in fp32, with the running max m and the running sum l, and writes o in
// the input dtype and the row's log-sum-exp m + log(l) in fp32 (the
// backward recomputes the probabilities from it).  The fp32 kernel
// applies the scale to q before the product, as written; the bf16 kernel
// applies it to the fp32 product q_i · k_j after it.  The two orders
// differ by fp32 rounding only.  Masked scores are
// −1e30, not −inf, exactly as the TPU kernel has them; keys past Sk are
// −inf and never counted.  Layout: q is (B, Sq, H, hd), k is
// (B, Sk, KV, hd) and v (B, Sk, KV, vd) with H % KV == 0; head h reads KV
// head h / (H / KV), so a GQA caller passes K and V once, not broadcast.
// No length has to be a multiple of a tile.
//
// Query row i sits at the absolute position q_offset + i, and keys at
// j >= kv_len are hidden: key j is visible to row i iff j < kv_len and,
// when causal, j <= q_offset + i and, when window > 0, j > q_offset + i −
// window.  That is the reference's masked decode attention (repro/models/
// base.py::attend with q_pos = pos + arange(Sq) and kv_len = pos + Sq);
// q_offset = 0 and kv_len = Sk are the whole-sequence attention.  Keys at
// or past kv_len are never loaded into the sums (the key loop stops at
// min(Sk, kv_len, q_offset + the block's last row + 1)), so a decode step
// over a long cache reads only its filled part.  This is exact whenever
// every row sees a key (the wrapper checks it for the masked launches):
// a hidden key's exp(−1e30 − m) is 0.
//
// What bounds it: operations.  A causal launch at the training path's
// shape (B·H = 8·32, S = 4096, hd = vd = 64, bf16) does 2·hd·S²/2
// multiply-adds twice (scores, then P·V) per head: 550 GFLOP, 0.56 ms at
// the tensor cores' 989 TFLOP/s; its bytes (q and the 4 KV heads' k, v
// read once, o and the log-sum-exp written once, 306 MB) take 0.09 ms at
// 3.35 TB/s.
//
// A decode launch is bound by bytes instead, and has kernels of its own,
// which replace these two on every launch whose KV group holds at most 64
// query rows (G · Sq <= 64, G = H / KV; every Sq = 1 decode, masked,
// cross or partial).  Each key and KV head gives 2·(hd + vd) bytes of K
// and V and takes 2·(hd + vd) operations for each of the group's G · Sq
// rows: at G <= 16 far fewer operations a byte than even the CUDA cores'
// 20 (67 TFLOP/s over 3.35 TB/s).  TinyLlama's decode (B = 16, kv_len
// 1088, 32 heads over 4 KV heads of 64, bf16) moves 17.9 MB (5.4 µs) for
// 0.14 GFLOP; gemma2-2b's global decode (B = 2 over 6176 keys, 8 heads
// over 4 KV heads of 256) 50.6 MB (15.1 µs) for 0.10 GFLOP.  Both decode
// kernels hold one (outer n, batch b, KV head) and one contiguous split
// of the keys some of its rows can see in each block, all G · Sq query
// rows of the group, so K and V are read from device memory once a
// launch; only the visible range [lo, hi) (causal edge, window, kv_len,
// the shard's base) is split, in whole tiles, by the plan the wrapper
// passes in (flash_attn.py::decode_plan).  A split a row cannot see adds
// exactly 0 (m = −inf); a row that sees no key of the launch (only under
// shards) gets o = 0, lse = −inf; the splits join in a fixed order,
// without atomics: the same launch gives the same bits.
//
// bf16 (flash_decode_mma_kernel, namespace dmma) answers what held the
// CUDA-core design below, in bf16, at 1.1–3.1 times SDPA's time on the
// serving paths' launches:
//
// * arithmetic on the CUDA cores, repeated for each row chunk: the
//   scores and P·V run on the tensor cores (mma.sync.m16n8k16, bf16 in,
//   fp32 accumulate).  The group's rows, padded to m16 tiles (1, 2 or 4),
//   are S = Q·Kᵀ's A operand, loaded once into registers; K's rows come
//   from shared memory by ldmatrix, V's by ldmatrix.trans as P·V's B
//   operand, so an element is read once a block where the rows fit one
//   tile (every model decode) and never converted on the CUDA cores.  S's
//   accumulator fragments are P's A operand as they stand, split as P_hi
//   = bf16(p) and P_lo = bf16(p − P_hi), two products into one fp32
//   accumulator (flash_fwd_wgmma_kernel's split: a single bf16 P would
//   move o by about 2^-15 · max|v| over thousands of keys).  Not wgmma:
//   it takes 64 rows, 4–64 times a decode group's, and these launches are
//   bound by bytes; the tensor cores are here to take the arithmetic off
//   the CUDA cores, not for their rate.  Four consumer warps: warp w
//   holds m tile w % MT and takes the key tiles it ≡ w / MT of the split
//   (mod 4 / MT), each with its own online softmax, joined in slice order
//   through shared memory at the end;
// * copies that cost instructions, and blocks too short to fill a ring:
//   one producer warp keeps a ring of 8 stages (two a consumer) in
//   flight by TMA, one 5-D map for K and one for V a launch (hopper.cuh's
//   make_map, 128-byte swizzle, 64-wide boxes, hd 16 and 32 zero-filled
//   to 64), a stage a tile of 32 keys up to hd 128 (8 KB of K and V to
//   hd 64, 16 KB at 128), 16 above (16 KB at hd 256), with a "full" and
//   an "empty" mbarrier.  Rows of V past the split are zeroed in shared
//   memory before use (P is 0 there, and 0 · a NaN in a cache's
//   unwritten rows would not be).  The plan gives each block at least as
//   many tiles as the ring has stages where the keys allow, and every SM
//   a block, but never more blocks than the SMs hold at once (two an SM,
//   one at hd 128 and 256, whose rings take 128 KB); where more blocks
//   see keys than that, the split count whose waves take the fewest tile
//   times.  Measured, a box's fixed cost outweighs smaller boxes, and
//   more lanes issuing them or 256-byte L2 promotion gain nothing;
// * a second launch for every split decode: the splits of one (n, b, KV
//   head) are one thread block cluster (cudaLaunchKernelEx), and after a
//   cluster barrier each block joins every splits-th output of the group
//   from all the splits' (m, l, unnormalised O) through distributed
//   shared memory, in split order: no partials in device memory, no
//   second kernel.  At more than 8 splits (the portable cluster), or
//   where clusters of more than two would take over three quarters of
//   the blocks the SMs hold (a cluster's blocks must find room in one GPC
//   at once; near a full card they waited), the splits write fp32
//   partials and flash_decode_join_kernel joins them (the plan picks by
//   the shape).
//
// fp32 (flash_decode_kernel, namespace dec) keeps the first decode
// kernel's design, which beats SDPA's fp32 by 11.7 times on the VLM's
// cross decode:
//
// * a ring of 3 stages of about 32 KB in dynamic shared memory by
//   cp.async (16-byte copies, or 4-byte ones where a base or stride does
//   not allow 16; keys past the split are zero-filled);
// * fp32 on the CUDA cores (q scaled first; scores in log2 units, ex2 on
//   the SFU): a key is DL lanes wide, each lane holding hd / DL of q's
//   and vd / DL of the output's values for RC rows, the score summed over
//   the DL lanes by shuffles.  Up to 16 rows RC = 2 and DL = hd / 16;
//   above, RC = 8 and DL = hd / 8 (DL = 16 at hd 192).  Each group of
//   lanes keeps its own online softmax state; the states meet at the end,
//   inside the warp, then across the warps of a row chunk in warp order;
// * with more than one split, fp32 partials in scratch and the join
//   kernel.
//
// Measured (PERF.md §6, an H100 80GB HBM3 at 700 W): tools/flash_ab.py
// --tree OLD/src --tree src --tree src --tree OLD/src times each decode
// launch beside SDPA and its byte bound in one run; tools/flash_ab.py
// --sweep times the bf16 launches at forced split counts and both joins,
// and tools/decode_variants.py the ring's shape and the grid's order.
//
// Keys that no row sees are never loaded, and the rows' masked keys add
// exactly 0, as in the kernels above (exact whenever a row sees a key).
//
// The training and prefill launches keep two kernels, picked by dtype:
//
// * bf16 (flash_fwd_wgmma_kernel): the tensor cores.  A block holds 128
//   query rows of one (batch, head): two consumer warpgroups of 64 rows
//   and one producer warpgroup, whose registers go to the consumers
//   (setmaxnreg 40 / 232).  One producer thread loads the Q tile once and
//   keeps K and V tiles of KT keys (128 at hd 64, 64 above, 32 at vd 256)
//   in flight in a ring of two stages, all by TMA (128-byte swizzle, so a
//   64-wide box a row: wider heads load as 2-4 boxes, narrower ones are
//   zero-filled to 64), with mbarriers for "loaded" and, apart for K and
//   V, "released".  A consumer computes S = Q·Kᵀ by wgmma (bf16 in, fp32
//   accumulate, both operands in shared memory), scales the fp32
//   fragment by scale · log2 e, caps it with accurate tanhf first when
//   cap > 0, masks only tiles that cross the diagonal, the window edge or
//   the ragged tail, and keeps the online max and sum on its fragment
//   rows (4 lanes a row, shuffles; ex2.approx.ftz on the SFU).  P stays
//   in registers as the A operand, split as P_hi = bf16(p) and P_lo =
//   bf16(p − P_hi): the two wgmmas P_hi·V and P_lo·V add into one fp32
//   accumulator, so each probability is carried to about 2^-16 of itself
//   (a single bf16 P, 2^-9, would move o by about 2^-15·max|v| over 4096
//   keys, past the bf16 tolerance).  That costs 1.5× the tensor-core
//   work (825 GFLOP at the path's shape, a 0.83 ms floor); the
//   exponentials, 16 a clock an SM, are the other floor (about 0.5 ms).
//   So the softmax is hidden under GEMMs twice over: a warpgroup issues
//   tile j + 1's scores before tile j's P·V and runs tile j + 1's softmax
//   while P·V runs, and the two warpgroups take turns issuing their
//   GEMMs (named barriers), so that one's softmax runs under the other's
//   GEMMs.  Head dims (hd, vd): (16, 16), (32, 32), (64, 64), (128, 128),
//   (256, 256) and (192, 128).
// * fp32 (flash_fwd_tf32_kernel): the tensor cores in TF32, three
//   products a GEMM (3xTF32), so that fp32 holds the reference's 3e-5.
//   What bounds it: operations, three times the flops at TF32's 495
//   TFLOP/s (the VLM's cross prefill, q (2, 1024, 64, 128) over 1600
//   keys: 3 · 107.4 GFLOP, a 0.651 ms floor; on the CUDA cores' 67 the
//   one product alone takes 1.603 ms).  The first fp32 kernel held a
//   query row a thread on the CUDA cores, one shared-memory load every
//   4 FMAs, and loaded K and V synchronously between two barriers.  This
//   one:
//   - splits each fp32 operand x as big = tf32(x) and small = tf32(x −
//     big), tf32 rounding as cvt.rna.tf32.f32 does (to nearest, ties
//     away), and computes every product as small·big + big·small +
//     big·big (smallest terms first) with mma.sync.m16n8k8 (TF32 wgmma
//     wants both shared operands K-major, and V is (keys, vd) with vd
//     contiguous): the dropped small·small is about 2^-22 of a product,
//     the arithmetic of the library's OpMultiplyAddFastF32.  A tensor
//     core aligns its addends to the largest and truncates, so each
//     product into a long running sum would lose about an ulp of it, all
//     one way (on an H100 at hd 256 with q = k that moved the log-sum-exp
//     by 5e-5): the products of two 8-wide chunks (CHUNKS) are summed
//     from 0 and then added to the score or the output in fp32;
//   - gives each of 8 warps 16 query rows (a block 128), its scores as
//     mma fragments: thread (g = lane / 4, t = lane % 4) holds keys 2t
//     and 2t + 1 of rows g and g + 8, and that fragment is the A operand
//     of P·V as it stands, k-slot t taking key 2t and k-slot t + 4 key
//     2t + 1, V's B fragment read in the same order (V[2t][g],
//     V[2t + 1][g]): no shuffle between the two GEMMs;
//   - keeps fl32(q) · scale in shared memory (split as it is read) and
//     streams K and V through a ring of two stages in dynamic shared
//     memory by cp.async (16-byte copies, or 4-byte ones where a base or
//     a stride is off 16 bytes; keys past the block's range are
//     zero-filled), tile j + 1 in flight while tile j is used; once a
//     tile lands the block splits it, the big halves in place and the
//     small ones beside, so that each of the 8 warps reads its fragments
//     split; rows are padded to d + 4 floats, so that the fragments'
//     reads fall on 32 banks;
//   - tiles of 32 keys (8 at hd 256, where q alone takes 133 KB and the
//     output 128 registers a thread), one block an SM;
//   - the online softmax in fp32 on the fragment's rows (4 lanes a row,
//     shuffles), the cap's tanhf, the masks only on tiles that cross an
//     edge, exp2((s − m) · log2 e) on the SFU.
//   Head dims (hd, vd): those of the bf16 kernel.  What holds it at
//   about 29 % of the floor is not measured (PERF.md §6 and §7: the
//   variants timed on an H100, and what they showed).
//
// Both skip key tiles that the causal mask or the window hides from
// every row of the block (exact: each skipped score would add
// exp(−1e30 − m) = 0 to a row that holds its own key), and both schedule
// heavy (late) causal query tiles first.
//
// Batch rows: the launch's batch is N · B rows, (outer n, inner b), each
// with a stride of its own, so that a KV cache laid out (ranks, L, B, S,
// KV, hd) is read where it lies, one layer's slice of every rank in one
// launch (row n · B + b of the output and the log-sum-exp).
//
// Partial attention over a shard of the keys (shards > 0): the keys of
// outer row n are the (n mod shards)-th block of Sk keys of a sequence
// split over `shards` ranks, key j at the absolute position
// (n mod shards) · Sk + j.  The causal mask, the window and kv_len (the
// count of valid keys of the whole sequence) apply to that position.  A
// query row that sees none of its shard's keys writes o = 0 and
// lse = −inf, so that the shards' results combine by their log-sum-exp
// (core/tp.py::lse_combine) with that shard's weight exactly 0; a block
// none of whose rows sees a key writes that and returns.  Without
// shards a row without a key is the caller's error (the wrapper refuses
// it), as before.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, H, KV, Sq, Sk;  // B: the inner batch rows an outer row
  // element strides (outer, batch, seq, head) of q, k, v, o
  long long qs[4], ks[4], vs[4], os[4];
  float scale, cap;
  int causal, window;
  int q_off;   // absolute position of query row 0
  int kv_len;  // keys at or past this absolute position are hidden
  int shards;  // > 0: partial attention over shard (n mod shards)
};

// The first key of outer row n's shard, an absolute position.
__device__ __forceinline__ int shard_base(int n, int shards, int Sk) {
  return shards > 0 ? (n % shards) * Sk : 0;
}

// Whether the row at position p (counted from the shard's first key)
// sees one of the klim keys below min(Sk, kv_len) under the mask.
__device__ __forceinline__ bool row_sees(int p, int klim, int causal, int window) {
  const int hi = causal ? min(klim, p + 1) : klim;
  const int lo = causal && window > 0 ? max(0, p - window + 1) : 0;
  return hi > lo;
}

}  // namespace


// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel.
// ---------------------------------------------------------------------------

namespace tc {

constexpr int CONSUMERS = 2;                    // warpgroups of 64 query rows
constexpr int QT = 64 * CONSUMERS;              // query rows a block
constexpr int THREADS = 128 * (CONSUMERS + 1);  // and one producer warpgroup
constexpr int STAGES = 2;                       // K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HD, int VD>
struct Shape {
  static constexpr int HDP = HD < 64 ? 64 : HD;  // padded to one 64-wide box
  static constexpr int VDP = VD < 64 ? 64 : VD;
  static constexpr int HC = HDP / 64, VC = VDP / 64;  // boxes a row
  // keys a tile: the score, P and output fragments of one consumer thread
  // (KT / 2 + KT / 2 + VDP / 2 registers) fit beside its other state
  static constexpr int KT = HDP == 64 && VDP == 64 ? 128 : VDP == 256 ? 32 : 64;
  static constexpr int Q_BYTES = QT * HDP * 2;
  static constexpr int K_BYTES = KT * HDP * 2;
  static constexpr int V_BYTES = KT * VDP * 2;
  static constexpr int TILE_BYTES = Q_BYTES + STAGES * (K_BYTES + V_BYTES);
  // tiles 1024-byte aligned (the swizzle's period), then the mbarriers
  static constexpr int SMEM = TILE_BYTES + 1024 + 8 * (1 + 4 * STAGES);
  static_assert(HD % 16 == 0 && VD % 16 == 0, "dims are multiples of 16");
  static_assert(SMEM <= 232448, "shared memory");
};

struct Args {
  void* o;
  float* lse;
  int B, H, KV, Sq, Sk;  // B: the inner batch rows an outer row
  long long os[4];  // element strides (outer, batch, seq, head) of o
  float scale, cap;
  int causal, window;
  int q_off;   // absolute position of query row 0
  int kv_len;  // keys at or past this absolute position are hidden
  int shards;  // > 0: partial attention over shard (n mod shards)
};

using namespace hopper;

// bf16(x0), bf16(x1) packed as the A operand wants them (x0 low), and the
// bf16 of what that leaves of each.
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// This thread's place in a consumer warpgroup's fragments: rows row0 and
// row1 = row0 + 8, columns col + {0, 1} of every 8-wide block.
struct Frag {
  int r_lo, row0, row1, col;
};

// One score tile, in log2 units: s = acc · scale · log2 e (capped first
// when cap > 0), masked to −1e30 · log2 e where the causal mask or the
// window hides a key and to −inf past min(Sk, kv_len) — only on a tile
// that some row of the warpgroup sees in part.  Then the online softmax on the
// thread's two rows: s becomes exp2(s − m), l gathers it, and al0, al1
// are the factors the output rows are rescaled by.
template <int KT>
__device__ __forceinline__ void softmax_tile(float (&s)[KT / 2], const Args& a, int qoff,
                                             int klim, const Frag& f, int t0, float& m0,
                                             float& m1, float& l0, float& l1, float& al0,
                                             float& al1) {
  if (a.cap > 0.f) {
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) s[i] = tanhf(s[i] * a.scale / a.cap) * a.cap * LOG2E;
  } else {
    const float c = a.scale * LOG2E;
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) s[i] *= c;
  }
  const int lo = qoff + f.r_lo;  // the warpgroup's first position
  const bool whole = t0 + KT <= klim &&
                     (!a.causal || (t0 + KT - 1 <= lo &&
                                    (a.window == 0 || t0 > lo + 63 - a.window)));
  if (!whole) {
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      const int key = t0 + 8 * (i / 4) + f.col + (i & 1);
      const int row = qoff + ((i & 2) ? f.row1 : f.row0);
      if (key >= klim) {
        s[i] = -INFINITY;  // no such key
      } else if (a.causal && (key > row || (a.window > 0 && key <= row - a.window))) {
        s[i] = -1e30f * LOG2E;
      }
    }
  }
  // the tile holds a key below Sk, so each row's max is finite
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int i = 0; i < KT / 2; i += 4) {
    mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh *= 2) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
  }
  al0 = ex2(m0 - mx0);
  al1 = ex2(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int i = 0; i < KT / 2; i += 4) {
    s[i] = ex2(s[i] - mx0);
    s[i + 1] = ex2(s[i + 1] - mx0);
    s[i + 2] = ex2(s[i + 2] - mx1);
    s[i + 3] = ex2(s[i + 3] - mx1);
    ps0 += s[i] + s[i + 1];
    ps1 += s[i + 2] + s[i + 3];
  }
  l0 = l0 * al0 + ps0;  // this thread's share; the 4 lanes add at the end
  l1 = l1 * al1 + ps1;
}

// SHARDED: a partial launch (shards > 0).  The ordinary launch is an
// instance of its own that does none of the shard work (tools/flash_ab.py
// times it against an earlier version of this file).
template <int HD, int VD, bool SHARDED>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ Args a) {
  using S = Shape<HD, VD>;
  constexpr int KT = S::KT;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;                          // Q  [HC][QT][64]
  const uint32_t sk = sq + S::Q_BYTES;               // K  [STAGES][HC][KT][64]
  const uint32_t sv = sk + STAGES * S::K_BYTES;      // V  [STAGES][VC][KT][64]
  const uint32_t qbar = base + S::TILE_BYTES;        // Q loaded
  const uint32_t kfull = qbar + 8;                   // [STAGES] K loaded
  const uint32_t vfull = kfull + 8 * STAGES;         // [STAGES] V loaded
  const uint32_t kfree = vfull + 8 * STAGES;         // [STAGES] K released
  const uint32_t vfree = kfree + 8 * STAGES;         // [STAGES] V released

  const int bh = blockIdx.x;
  const int bb = bh / a.H, h = bh % a.H;
  const int n = bb / a.B, b = bb % a.B;
  const int kvh = h / (a.H / a.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QT;  // late tiles first
  // positions from here on count from the shard's first key
  const int kb0 = SHARDED ? (n % a.shards) * a.Sk : 0;
  const int qoff = a.q_off - kb0;
  const int klim = min(a.Sk, a.kv_len - kb0);  // may be <= 0: no key
  // the key range any row of this block can see
  const int qlast = qoff + min(q0 + QT, a.Sq) - 1;
  int kbeg = 0, kend = klim;
  if (a.causal) {
    kend = min(klim, qlast + 1);
    if (a.window > 0 && qlast < klim) kbeg = max(0, qoff + q0 - a.window + 1) / KT * KT;
  }
  const int ntiles = (kend - kbeg + KT - 1) / KT;
  if (SHARDED && ntiles <= 0) {  // a shard none of whose rows sees a key (block-uniform)
    __nv_bfloat16* ob =
        static_cast<__nv_bfloat16*>(a.o) + n * a.os[0] + b * a.os[1] + h * a.os[3];
    float* lb = a.lse + static_cast<long long>(bh) * a.Sq;
    for (int i = threadIdx.x; i < QT * VD; i += THREADS) {
      const int row = q0 + i / VD;
      if (row < a.Sq) ob[row * a.os[2] + i % VD] = __float2bfloat16(0.f);
    }
    for (int i = threadIdx.x; i < QT; i += THREADS)
      if (q0 + i < a.Sq) lb[q0 + i] = -INFINITY;
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(kfull + 8 * s, 1);
      mbar_init(vfull + 8 * s, 1);
      mbar_init(kfree + 8 * s, 4 * CONSUMERS);  // every consumer warp
      mbar_init(vfree + 8 * s, 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {  // the producer warpgroup: one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 4 * CONSUMERS && lane == 0) {
      mbar_expect_tx(qbar, S::Q_BYTES);
#pragma unroll 1
      for (int c = 0; c < S::HC; ++c) tma_load(sq + c * QT * 128, &tq, qbar, 64 * c, h, q0, b, n);
#pragma unroll 1
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % STAGES;
        const uint32_t par = (it / STAGES + 1) & 1;  // the previous round's
        const int t0 = kbeg + it * KT;
        if (it >= STAGES) mbar_wait(kfree + 8 * st, par);
        mbar_expect_tx(kfull + 8 * st, S::K_BYTES);
#pragma unroll 1
        for (int c = 0; c < S::HC; ++c)
          tma_load(sk + st * S::K_BYTES + c * KT * 128, &tk, kfull + 8 * st, 64 * c, kvh, t0, b,
                   n);
        if (it >= STAGES) mbar_wait(vfree + 8 * st, par);
        mbar_expect_tx(vfull + 8 * st, S::V_BYTES);
#pragma unroll 1
        for (int c = 0; c < S::VC; ++c)
          tma_load(sv + st * S::V_BYTES + c * KT * 128, &tv, vfull + 8 * st, 64 * c, kvh, t0, b,
                   n);
      }
    }
    return;
  }
  // 128 · 40 + 256 · 232 registers: within the block's 384 · 168
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  // a consumer warpgroup: rows r_lo .. r_lo + 63
  const int wg = warp / 4;
  Frag f;
  f.r_lo = q0 + 64 * wg;
  f.row0 = f.r_lo + 16 * (warp % 4) + lane / 4;
  f.row1 = f.row0 + 8;
  f.col = 2 * (lane % 4);

  float o[S::VC][32];
#pragma unroll
  for (int c = 0; c < S::VC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float s[KT / 2];
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) s[i] = 0.f;
  uint32_t phi[KT / 16][4], plo[KT / 16][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, al0, al1;

  const uint32_t qa = sq + wg * 64 * 128;
  // S = Q · Kᵀ of tile `it` (over the true head dim: the padding is zeros)
  auto scores = [&](int it) {
    const uint32_t kb = sk + (it % STAGES) * S::K_BYTES;
    // Q's descriptors are rebuilt each tile, not held in registers
    uint32_t qt;
    asm volatile("mov.b32 %0, %1;\n" : "=r"(qt) : "r"(qa));
    mbar_wait(kfull + 8 * (it % STAGES), (it / STAGES) & 1);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      const uint32_t off = (kc % 4) * 32;  // 16 values along the swizzled row
      wgmma_ss<KT>(s, desc(qt + (kc / 4) * QT * 128 + off, 16, 1024),
                   desc(kb + (kc / 4) * KT * 128 + off, 16, 1024), kc > 0);
    }
    wg_commit();
  };
  // O += P_hi · V + P_lo · V of tile `it`
  auto values = [&](int it) {
    const uint32_t vb = sv + (it % STAGES) * S::V_BYTES;
    mbar_wait(vfull + 8 * (it % STAGES), (it / STAGES) & 1);
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int c = 0; c < S::VC; ++c) {
        const uint64_t dv = desc(vb + c * KT * 128 + kk * 16 * 128, KT * 128, 1024);
        wgmma_rs_n64(o[c], phi[kk], dv, 1);
        wgmma_rs_n64(o[c], plo[kk], dv, 1);
      }
    wg_commit();
  };
  // P as the A operand: keys 16·kk .. 16·kk + 15 are fragment values
  // 8·kk .. 8·kk + 7, in the A layout's order
  auto to_operand = [&]() {
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], phi[kk][r], plo[kk][r]);
  };
  auto release = [&](uint32_t bars, int it) {
    if (lane == 0) mbar_arrive(bars + 8 * (it % STAGES));
  };
  // ping-pong: a warpgroup issues its GEMMs on its turn, then hands the
  // turn to the other, so that one's softmax runs under the other's GEMMs
  // (named barriers 1 and 2)
  auto my_turn = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory"); };
  auto your_turn = [&]() { asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory"); };
  if (wg == 1) your_turn();  // warpgroup 0 goes first

  mbar_wait(qbar, 0);
  my_turn();
  scores(0);
  your_turn();
  wg_wait<0>();
  pin(s);
  release(kfree, 0);
  softmax_tile<KT>(s, a, qoff, klim, f, kbeg, m0, m1, l0, l1, al0, al1);
  to_operand();
  // tile it's scores on the tensor cores while tile it - 1's P·V follows
  // them, then tile it's softmax while P·V runs
  for (int it = 1; it < ntiles; ++it) {
    my_turn();
    scores(it);
    values(it - 1);
    your_turn();
    wg_wait<1>();
    pin(s);
    release(kfree, it);
    softmax_tile<KT>(s, a, qoff, klim, f, kbeg + it * KT, m0, m1, l0, l1, al0, al1);
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < S::VC; ++c) pin(o[c]);
    pin(phi);
    pin(plo);
    release(vfree, it - 1);
#pragma unroll
    for (int c = 0; c < S::VC; ++c)
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        o[c][i] *= al0;
        o[c][i + 1] *= al0;
        o[c][i + 2] *= al1;
        o[c][i + 3] *= al1;
      }
    to_operand();
  }
  my_turn();
  wg_fence();
  values(ntiles - 1);
  if (wg == 0) your_turn();  // the last turn is handed to no one
  wg_wait<0>();
#pragma unroll
  for (int c = 0; c < S::VC; ++c) pin(o[c]);
  pin(phi);
  pin(plo);

  // the epilogue: the row sums over the 4 lanes, o / max(l, 1e-30) in
  // bf16 clipped at Sq and vd, and the log-sum-exp m · ln 2 + log(l); a
  // shard's row without a key writes o = 0 and lse = −inf
#pragma unroll
  for (int sh = 1; sh <= 2; sh *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const bool none0 = SHARDED && !row_sees(qoff + f.row0, klim, a.causal, a.window);
  const bool none1 = SHARDED && !row_sees(qoff + f.row1, klim, a.causal, a.window);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.o) + n * a.os[0] + b * a.os[1] + h * a.os[3];
#pragma unroll
  for (int c = 0; c < S::VC; ++c)
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const int d = 64 * c + 8 * (i / 4) + f.col;
      if (d >= VD) continue;
      if (f.row0 < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + f.row0 * a.os[2] + d) =
            none0 ? __floats2bfloat162_rn(0.f, 0.f)
                  : __floats2bfloat162_rn(o[c][i] / d0, o[c][i + 1] / d0);
      if (f.row1 < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + f.row1 * a.os[2] + d) =
            none1 ? __floats2bfloat162_rn(0.f, 0.f)
                  : __floats2bfloat162_rn(o[c][i + 2] / d1, o[c][i + 3] / d1);
    }
  if (lane % 4 == 0) {
    float* lb = a.lse + static_cast<long long>(bh) * a.Sq;
    if (f.row0 < a.Sq) lb[f.row0] = none0 ? -INFINITY : m0 * LN2 + logf(l0);
    if (f.row1 < a.Sq) lb[f.row1] = none1 ? -INFINITY : m1 * LN2 + logf(l1);
  }
}

template <int HD, int VD>
cudaError_t launch(const void* q, const void* k, const void* v, const Args& a, int N,
                   const long long* strides, cudaStream_t s) {
  using Sh = Shape<HD, VD>;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, N, a.B, a.Sq, a.H, HD, strides, QT) ||
      !make_map(&mk, k, N, a.B, a.Sk, a.KV, HD, strides + 4, Sh::KT) ||
      !make_map(&mv, v, N, a.B, a.Sk, a.KV, VD, strides + 8, Sh::KT))
    return cudaErrorInvalidValue;
  const auto kernel = a.shards > 0 ? flash_fwd_wgmma_kernel<HD, VD, true>
                                    : flash_fwd_wgmma_kernel<HD, VD, false>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(N * a.B * a.H, (a.Sq + QT - 1) / QT);
  kernel<<<grid, THREADS, Sh::SMEM, s>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

}  // namespace tc


// ---------------------------------------------------------------------------
// The fp32 decode kernel: one block a (n, b, KV head, key split), fp32 on
// the CUDA cores (the note at the top of this file).
// ---------------------------------------------------------------------------

namespace dec {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 3;            // K/V ring depth
constexpr int KB = 2;                // keys a lane group scores before an update
constexpr int TILE_BYTES = 32768;    // what a stage aims at
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  float* part_o;   // [row][split][vd]: a split's unnormalised output
  float* part_ml;  // [row][split][2]: its max (log2 units) and sum
  int B, H, KV, Sq, Sk;  // B: the inner batch rows an outer row
  // element strides (outer, batch, seq, head) of q, k, v, o
  long long qs[4], ks[4], vs[4], os[4];
  float scale, cap;
  int causal, window;
  int q_off;   // absolute position of query row 0
  int kv_len;  // keys at or past this absolute position are hidden
  int shards;  // > 0: partial attention over shard (n mod shards)
  int R;       // query rows a block: G · Sq, row r = g · Sq + i
  int wk;      // warps sharing a row chunk (the chunks are WARPS / wk)
  int tile, tiles, splits;  // keys a stage; tiles of the widest range; splits
  int vec16;   // 16-byte copies (else 4-byte)
};

// Lanes a key for RC rows a warp: hd / 16 (a lane holds 16 of q's and of
// the output's values a row), hd / 8 at RC = 8 (8 a row, for registers),
// 16 at hd 192 (12 of q's, 8 of the output's).
__host__ __device__ constexpr int lanes(int hd, int rc) {
  return hd == 192 ? 16 : rc == 8 ? hd / 8 : hd / 16;
}

// The keys of a stage for R rows: a whole number of batches (the KB keys
// of every lane group of a warp), about TILE_BYTES of K and V; the warps
// that share a row chunk take the batches in turn.
// flash_attn.py::decode_tile is the same.
__host__ __device__ inline int tile_keys(int hd, int vd, int R, int* wk) {
  const int rc = R <= 16 ? 2 : 8;
  int chunks = 1;
  while (chunks * rc < R) chunks *= 2;
  *wk = WARPS / chunks;
  const int batch = 32 / lanes(hd, rc) * KB;
  const int per = TILE_BYTES / (batch * (hd + vd) * 4);
  return batch * (per > 1 ? per : 1);
}

// The head dim of a lane's value e: chunks of 4 values, interleaved over
// the DL lanes of a key (neighbouring lanes on neighbouring addresses).
template <int DL>
__device__ __forceinline__ int dim_of(int e, int dl) {
  return ((e / 4) * DL + dl) * 4 + e % 4;
}

// A lane's E values of a row at p (DL lanes a row, 16-byte chunks).
template <int E, int DL>
__device__ __forceinline__ void load_row(const float* p, int dl, float (&out)[E]) {
#pragma unroll
  for (int c = 0; c < E / 4; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(p + (c * DL + dl) * 4);
    out[4 * c] = x.x;
    out[4 * c + 1] = x.y;
    out[4 * c + 2] = x.z;
    out[4 * c + 3] = x.w;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(tc::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(tc::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The visible keys [lo, hi) of outer row n's block of keys (positions
// counted from the shard's first key); empty where hi <= lo.
__device__ __forceinline__ void key_range(int n, int shards, int Sk, int q_off, int kv_len,
                                          int Sq, int causal, int window, int& qoff, int& lo,
                                          int& hi) {
  const int kb0 = shards > 0 ? (n % shards) * Sk : 0;
  qoff = q_off - kb0;
  const int klim = min(Sk, kv_len - kb0);
  lo = 0;
  hi = klim;
  if (causal) {
    hi = min(klim, qoff + Sq);
    if (window > 0) lo = max(0, qoff - window + 1);
  }
}

// RC: query rows a warp holds (2, or 8 above 16 rows).  At RC = 2 a
// thread keeps within 128 registers, so that two blocks or more share an
// SM and one's start and end overlap the other's stream.
template <int HD, int VD, int RC>
__global__ void __launch_bounds__(THREADS, RC <= 2 ? 2 : 1)
    flash_decode_kernel(const __grid_constant__ Args a) {
  constexpr int DL = lanes(HD, RC), KL = 32 / DL;  // lanes a key, keys a warp at once
  constexpr int EK = HD / DL, EV = VD / DL;     // a lane's values of q and of o
  static_assert(EK % 4 == 0 && EV % 4 == 0 && 32 % DL == 0, "bad lane split");
  extern __shared__ __align__(16) uint8_t dsmem[];
  float* ring = reinterpret_cast<float*>(dsmem);
  const int tile = a.tile;
  const int stage = tile * (HD + VD);

  // the block: (n, b, split, KV head), KV heads fastest, so that blocks
  // running together read the same keys' rows of neighbouring heads
  int blk = blockIdx.x;
  const int kvh = blk % a.KV;
  blk /= a.KV;
  const int split = blk % a.splits;
  blk /= a.splits;
  const int b = blk % a.B, n = blk / a.B;
  const int G = a.H / a.KV;
  int qoff, lo, hi;
  key_range(n, a.shards, a.Sk, a.q_off, a.kv_len, a.Sq, a.causal, a.window, qoff, lo, hi);
  // this split's whole tiles of the visible range
  const int s_lo = lo + static_cast<int>(static_cast<long long>(split) * a.tiles / a.splits) * tile;
  const int s_hi =
      min(hi, lo + static_cast<int>(static_cast<long long>(split + 1) * a.tiles / a.splits) * tile);
  const int ntiles = s_hi > s_lo ? (s_hi - s_lo + tile - 1) / tile : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kg = warp % a.wk;           // this warp's share of a tile's keys
  const int r0 = warp / a.wk * RC;      // its first row
  const int nr = min(RC, a.R - r0);     // its rows (none past R)
  const int ks = lane / DL, dl = lane % DL;

  // q: this lane's values of its rows, fp32 scaled first
  float qr[RC][EK];
  int pos[RC];
#pragma unroll
  for (int rr = 0; rr < RC; ++rr) {
    const int r = r0 + rr, i = r % a.Sq, h = kvh * G + r / a.Sq;
    pos[rr] = qoff + i;
    const float* qp = static_cast<const float*>(a.q) + n * a.qs[0] + b * a.qs[1] +
                      static_cast<long long>(i) * a.qs[2] + h * a.qs[3];
    if (rr >= nr) {
#pragma unroll
      for (int e = 0; e < EK; ++e) qr[rr][e] = 0.f;
    } else if (a.vec16) {  // 16-byte aligned rows
      load_row<EK, DL>(qp, dl, qr[rr]);
#pragma unroll
      for (int e = 0; e < EK; ++e) qr[rr][e] *= a.scale;
    } else {
#pragma unroll
      for (int e = 0; e < EK; ++e) qr[rr][e] = qp[dim_of<DL>(e, dl)] * a.scale;
    }
  }
  // the causal positions of the block's first and last rows
  const int pmin = qoff, pmax = qoff + a.Sq - 1;
  float acc[RC][EV], m[RC], l[RC];
#pragma unroll
  for (int rr = 0; rr < RC; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < EV; ++e) acc[rr][e] = 0.f;
  }

  const float* kbase = static_cast<const float*>(a.k) + n * a.ks[0] + b * a.ks[1] + kvh * a.ks[3];
  const float* vbase = static_cast<const float*>(a.v) + n * a.vs[0] + b * a.vs[1] + kvh * a.vs[3];
  // tile `it` of the split into its stage: K [tile][HD], then V [tile][VD];
  // keys past the split zero-filled
  auto load_tile = [&](int it) {
    float* kst = ring + (it % STAGES) * stage;
    float* vst = kst + tile * HD;
    const int key0 = s_lo + it * tile;
    if (a.vec16) {
      constexpr int KC = HD / 4, PER = (HD + VD) / 4;
      for (int c = threadIdx.x; c < tile * PER; c += THREADS) {
        const int j = c / PER, w = c % PER, key = key0 + j;
        const bool in = key < s_hi;
        const float* src = w < KC ? kbase + static_cast<long long>(key) * a.ks[2] + w * 4
                                  : vbase + static_cast<long long>(key) * a.vs[2] + (w - KC) * 4;
        float* dst = w < KC ? kst + j * HD + w * 4 : vst + j * VD + (w - KC) * 4;
        cp_async16(dst, in ? src : kbase, in ? 16 : 0);
      }
    } else {
      for (int c = threadIdx.x; c < tile * (HD + VD); c += THREADS) {
        const int j = c / (HD + VD), w = c % (HD + VD), key = key0 + j;
        const bool in = key < s_hi;
        const float* src = w < HD ? kbase + static_cast<long long>(key) * a.ks[2] + w
                                  : vbase + static_cast<long long>(key) * a.vs[2] + (w - HD);
        float* dst = w < HD ? kst + j * HD + w : vst + j * VD + (w - HD);
        cp_async4(dst, in ? src : kbase, in ? 4 : 0);
      }
    }
  };

#pragma unroll 1
  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < ntiles) load_tile(it);
    cp_commit();
  }
  const int sweep = KL * KB * a.wk;  // the keys the warps of a row chunk take at once
#pragma unroll 1
  for (int it = 0; it < ntiles; ++it) {
    cp_wait<STAGES - 2>();  // tile it has landed (this thread's copies)
    __syncthreads();        // everyone's, and tile it - 1 is consumed
    if (it + STAGES - 1 < ntiles) load_tile(it + STAGES - 1);
    cp_commit();
    if (nr <= 0) continue;
    const float* kt = ring + (it % STAGES) * stage;
    const float* vt = kt + tile * HD;
    const int key0 = s_lo + it * tile;
#pragma unroll 1
    for (int j0 = kg * KL * KB; j0 < tile; j0 += sweep) {
      // the scores of KB keys for every row: this lane's share, then the
      // sum over the key's DL lanes (every lane gets the same bits)
      float s[KB][RC];
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        float kf[EK];
        load_row<EK, DL>(kt + (j0 + kb * KL + ks) * HD, dl, kf);
#pragma unroll
        for (int rr = 0; rr < RC; ++rr) {
          if (rr >= nr) break;
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < EK; ++e) x = fmaf(qr[rr][e], kf[e], x);
          s[kb][rr] = x;
        }
      }
#pragma unroll
      for (int rr = 0; rr < RC; ++rr) {
        if (rr >= nr) break;
#pragma unroll
        for (int off = 1; off < DL; off *= 2)
#pragma unroll
          for (int kb = 0; kb < KB; ++kb) s[kb][rr] += __shfl_xor_sync(0xffffffffu, s[kb][rr], off);
      }
      // the cap: its tanhf once a (key, row) score, lane p of a key's DL
      // lanes computing score p where there are lanes enough
      if (a.cap > 0.f) {
        if constexpr (DL >= KB * RC) {
          float mine = 0.f;  // score dl = rr · KB + kb (registers: no index)
#pragma unroll
          for (int rr = 0; rr < RC; ++rr)
#pragma unroll
            for (int kb = 0; kb < KB; ++kb)
              if (rr < nr && dl == rr * KB + kb) mine = s[kb][rr];
          const float capped = tanhf(mine / a.cap) * a.cap;
#pragma unroll
          for (int rr = 0; rr < RC; ++rr) {
            if (rr >= nr) break;
#pragma unroll
            for (int kb = 0; kb < KB; ++kb)
              s[kb][rr] = __shfl_sync(0xffffffffu, capped, ks * DL + rr * KB + kb);
          }
        } else {
#pragma unroll
          for (int rr = 0; rr < RC; ++rr) {
            if (rr >= nr) break;
#pragma unroll
            for (int kb = 0; kb < KB; ++kb) s[kb][rr] = tanhf(s[kb][rr] / a.cap) * a.cap;
          }
        }
      }
      // mask (−inf: the key is not this row's, or past the split) only
      // where the warp's batch of keys crosses an edge of a row's range;
      // then one online-softmax step a row
      const int b0 = key0 + j0, b1 = b0 + KL * KB;  // the warp's keys [b0, b1)
      const bool whole = b1 <= s_hi && (!a.causal || (b1 - 1 <= pmin &&
                                                      (a.window == 0 || b0 > pmax - a.window)));
#pragma unroll
      for (int rr = 0; rr < RC; ++rr) {
        if (rr >= nr) break;
        float mt = -INFINITY;
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          const int key = b0 + kb * KL + ks;
          const bool seen = whole || (key < s_hi && (!a.causal || (key <= pos[rr] &&
                                                     (a.window == 0 || key > pos[rr] - a.window))));
          s[kb][rr] = seen ? s[kb][rr] * LOG2E : -INFINITY;
          mt = fmaxf(mt, s[kb][rr]);
        }
        const float mn = fmaxf(m[rr], mt);
        float alpha = 1.f;
        if (mn == -INFINITY) {
#pragma unroll
          for (int kb = 0; kb < KB; ++kb) s[kb][rr] = 0.f;
        } else {
          if (mn > m[rr]) alpha = tc::ex2(m[rr] - mn);  // the max moved (rarely, once warm)
          float ps = 0.f;
#pragma unroll
          for (int kb = 0; kb < KB; ++kb) {
            s[kb][rr] = tc::ex2(s[kb][rr] - mn);
            ps += s[kb][rr];
          }
          l[rr] = l[rr] * alpha + ps;
          m[rr] = mn;
        }
        if (__any_sync(0xffffffffu, alpha != 1.f)) {
#pragma unroll
          for (int e = 0; e < EV; ++e) acc[rr][e] *= alpha;
        }
      }
      // P · V
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        float vf[EV];
        load_row<EV, DL>(vt + (j0 + kb * KL + ks) * VD, dl, vf);
#pragma unroll
        for (int rr = 0; rr < RC; ++rr) {
          if (rr >= nr) break;
#pragma unroll
          for (int e = 0; e < EV; ++e) acc[rr][e] = fmaf(s[kb][rr], vf[e], acc[rr][e]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' states next

  // the lane groups of a warp, DL lanes apart, fold into the first
#pragma unroll
  for (int rr = 0; rr < RC; ++rr) {
    if (rr >= nr) break;
#pragma unroll
    for (int off = DL; off < 32; off *= 2) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[rr], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[rr], off);
      const float mx = fmaxf(m[rr], m2);
      const float a1 = mx == -INFINITY ? 0.f : tc::ex2(m[rr] - mx);
      const float a2 = mx == -INFINITY ? 0.f : tc::ex2(m2 - mx);
      l[rr] = l[rr] * a1 + l2 * a2;
#pragma unroll
      for (int e = 0; e < EV; ++e)
        acc[rr][e] = acc[rr][e] * a1 + __shfl_xor_sync(0xffffffffu, acc[rr][e], off) * a2;
      m[rr] = mx;
    }
  }
  // then the warps of a row chunk, through shared memory, in warp order
  float* so = reinterpret_cast<float*>(dsmem);      // [WARPS][RC][VD]
  float* sm = so + WARPS * RC * VD;                 // [WARPS][RC]
  float* sl = sm + WARPS * RC;                      // [WARPS][RC]
  if (ks == 0) {
#pragma unroll
    for (int rr = 0; rr < RC; ++rr) {
      if (rr >= nr) break;
#pragma unroll
      for (int e = 0; e < EV; ++e) so[(warp * RC + rr) * VD + dim_of<DL>(e, dl)] = acc[rr][e];
      if (dl == 0) {
        sm[warp * RC + rr] = m[rr];
        sl[warp * RC + rr] = l[rr];
      }
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < a.R * VD; x += THREADS) {
    const int r = x / VD, d = x % VD;
    const int w0 = r / RC * a.wk, rr = r % RC;
    float mx = -INFINITY;
    for (int w = w0; w < w0 + a.wk; ++w) mx = fmaxf(mx, sm[w * RC + rr]);
    float lsum = 0.f, osum = 0.f;
    if (mx != -INFINITY) {
      for (int w = w0; w < w0 + a.wk; ++w) {
        const float f = tc::ex2(sm[w * RC + rr] - mx);
        lsum += sl[w * RC + rr] * f;
        osum += so[(w * RC + rr) * VD + d] * f;
      }
    }
    const int i = r % a.Sq, h = kvh * G + r / a.Sq;
    const long long row = (static_cast<long long>(n * a.B + b) * a.H + h) * a.Sq + i;
    if (a.splits == 1) {
      // a row without a key (a shard's only): o = 0, lse = −inf
      float* op = static_cast<float*>(a.o) + n * a.os[0] + b * a.os[1] +
                  static_cast<long long>(i) * a.os[2] + h * a.os[3];
      op[d] = mx == -INFINITY ? 0.f : osum / fmaxf(lsum, 1e-30f);
      if (d == 0) a.lse[row] = mx == -INFINITY ? -INFINITY : mx * LN2 + logf(lsum);
    } else {
      const long long p = row * a.splits + split;
      a.part_o[p * VD + d] = osum;
      if (d == 0) {
        a.part_ml[2 * p] = mx;
        a.part_ml[2 * p + 1] = lsum;
      }
    }
  }
}

// The splits of each query row (one block a row) joined: o = Σ O_s w_s /
// Σ l_s w_s in the input dtype, w_s = 2^(m_s − M), and lse = M ln 2 + log
// Σ l_s w_s; a row no split saw gets o = 0, lse = −inf.  The weights are
// staged in shared memory; a thread sums four dims over every G-th split
// (G = 1024 / vd groups of threads, float4 loads), then the groups' sums
// are added in group order: a fixed order, the same bits every launch.
// Both decode kernels' scratch paths end here (bf16's where its splits
// outnumber a cluster's blocks).
constexpr int JOIN_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(JOIN_THREADS) flash_decode_join_kernel(
    const __grid_constant__ Args a, int VD) {
  extern __shared__ __align__(16) float jsm[];  // w_s, l_s w_s, then [G][vd] sums
  __shared__ float red[JOIN_THREADS / 32];
  const long long row = blockIdx.x;
  const int i = static_cast<int>(row % a.Sq);
  long long t = row / a.Sq;
  const int h = static_cast<int>(t % a.H);
  t /= a.H;
  const int b = static_cast<int>(t % a.B), n = static_cast<int>(t / a.B);
  const float* ml = a.part_ml + row * a.splits * 2;
  const float* po = a.part_o + row * a.splits * VD;
  float mx = -INFINITY;
  for (int s = threadIdx.x; s < a.splits; s += JOIN_THREADS) mx = fmaxf(mx, ml[2 * s]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < JOIN_THREADS / 32; ++w) mx = fmaxf(mx, red[w]);
  for (int s = threadIdx.x; s < a.splits; s += JOIN_THREADS) {
    const float w = mx == -INFINITY ? 0.f : tc::ex2(ml[2 * s] - mx);
    jsm[s] = w;
    jsm[a.splits + s] = ml[2 * s + 1] * w;
  }
  __syncthreads();
  const int dv = VD / 4, groups = JOIN_THREADS / dv;
  const int dg = threadIdx.x % dv, sg = threadIdx.x / dv;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = sg; s < a.splits; s += groups) {
    const float4 x = *reinterpret_cast<const float4*>(po + s * VD + 4 * dg);
    const float w = jsm[s];
    acc.x += x.x * w;
    acc.y += x.y * w;
    acc.z += x.z * w;
    acc.w += x.w * w;
  }
  float* part = jsm + ((2 * a.splits + 3) & ~3);
  *reinterpret_cast<float4*>(part + sg * VD + 4 * dg) = acc;
  float lsum = 0.f;
  for (int s = 0; s < a.splits; ++s) lsum += jsm[a.splits + s];
  __syncthreads();
  T* op = static_cast<T*>(a.o) + n * a.os[0] + b * a.os[1] + static_cast<long long>(i) * a.os[2] +
          h * a.os[3];
  for (int d = threadIdx.x; d < VD; d += JOIN_THREADS) {
    float osum = 0.f;
    for (int g = 0; g < groups; ++g) osum += part[g * VD + d];
    op[d] = from_f<T>(mx == -INFINITY ? 0.f : osum / fmaxf(lsum, 1e-30f));
  }
  if (threadIdx.x == 0) a.lse[row] = mx == -INFINITY ? -INFINITY : mx * LN2 + logf(lsum);
}

// The join after a scratch path's splits (none with one split).
template <typename T>
cudaError_t launch_join(const Args& a, int N, int VD, cudaStream_t s) {
  if (a.splits == 1) return cudaSuccess;
  const size_t jsmem = (((2 * a.splits + 3) & ~3) + 4 * JOIN_THREADS) * sizeof(float);
  flash_decode_join_kernel<T><<<N * a.B * a.H * a.Sq, JOIN_THREADS, jsmem, s>>>(a, VD);
  return cudaGetLastError();
}

template <int HD, int VD, int RC>
cudaError_t launch_rc(const Args& a, int N, cudaStream_t s) {
  const size_t ring = static_cast<size_t>(STAGES) * a.tile * (HD + VD) * sizeof(float);
  const size_t merge = static_cast<size_t>(WARPS) * RC * (VD + 2) * sizeof(float);
  const size_t smem = ring > merge ? ring : merge;
  if (smem > 232448) return cudaErrorInvalidValue;
  const auto kernel = flash_decode_kernel<HD, VD, RC>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<N * a.B * a.KV * a.splits, THREADS, smem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_join<float>(a, N, VD, s);
}

template <int HD, int VD>
cudaError_t launch(const Args& a, int N, cudaStream_t s) {
  return a.R <= 16 ? launch_rc<HD, VD, 2>(a, N, s) : launch_rc<HD, VD, 8>(a, N, s);
}

cudaError_t launch_dims(const Args& a, int N, int hd, int vd, cudaStream_t s) {
  if (hd == vd) {
    switch (hd) {
      case 16: return launch<16, 16>(a, N, s);
      case 32: return launch<32, 32>(a, N, s);
      case 64: return launch<64, 64>(a, N, s);
      case 128: return launch<128, 128>(a, N, s);
      case 256: return launch<256, 256>(a, N, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (hd == 192 && vd == 128) return launch<192, 128>(a, N, s);
  return cudaErrorInvalidValue;
}

}  // namespace dec


// ---------------------------------------------------------------------------
// The bf16 decode kernel: one block a (n, b, KV head, key split), scores
// and P·V on the tensor cores by mma.sync, K and V by TMA, the splits
// joined inside a thread block cluster (the note at the top of this file).
// ---------------------------------------------------------------------------

namespace dmma {

using namespace hopper;
using tc::LN2;
using tc::LOG2E;

constexpr int CONSUMERS = 4;                   // consumer warps
constexpr int THREADS = 32 * (CONSUMERS + 1);  // and one producer warp
constexpr int STAGES = 2 * CONSUMERS;          // K/V ring depth: two tiles a warp
constexpr int CLUSTER = 8;                     // the most splits one cluster joins

template <int HD, int VD>
struct Shape {
  static constexpr int HDP = HD < 64 ? 64 : HD;  // padded to one 64-wide box
  static constexpr int VDP = VD < 64 ? 64 : VD;
  static constexpr int HC = HDP / 64, VC = VDP / 64;  // boxes a row
  // keys a tile: 32 where a key's padded K and V take at most 512 bytes
  // (hd <= 128: 8 KB stages up to hd 64, 16 KB at 128), else 16 (16 KB
  // at hd 256, 10 KB at (192, 128)); flash_attn.py::decode_tile
  static constexpr int KT = 2 * (HDP + VDP) <= 512 ? 32 : 16;
  static constexpr int K_BYTES = KT * HDP * 2, V_BYTES = KT * VDP * 2;
  static constexpr int STAGE = K_BYTES + V_BYTES;
  static constexpr int RING = STAGES * STAGE;
  // the ring, then each warp's (m, l) of 64 rows and the block's joined
  // ones, then the mbarriers; the ring holds the warps' outputs at the end
  static constexpr int SMEM = 1024 + RING + 4 * (2 * CONSUMERS * 16 + 2 * 64) + 16 * STAGES;
  static_assert(4 * CONSUMERS * 16 * VD <= RING, "the warps' outputs fit the ring");
  static_assert(SMEM <= 232448, "shared memory");
};

struct Args {
  const void* q;
  void* o;
  float* lse;
  float* part_o;   // the scratch path's partials, as dec::Args has them
  float* part_ml;
  int B, H, KV, Sq, Sk;  // B: the inner batch rows an outer row
  long long qs[4], os[4];  // element strides (outer, batch, seq, head) of q, o
  float scale, cap;
  int causal, window;
  int q_off;   // absolute position of query row 0
  int kv_len;  // keys at or past this absolute position are hidden
  int shards;  // > 0: partial attention over shard (n mod shards)
  int R;       // query rows a block: G · Sq, row r = g · Sq + i
  int tiles, splits;  // tiles of the widest range; splits
  int cluster;  // 1: the splits are one cluster and join there; 0: scratch
};

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a · b: one m16n8k16 product, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// addr (this block's shared memory) in block `rank` of the cluster, read
// as a float
__device__ __forceinline__ float ld_cluster(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(x) : "r"(remote) : "memory");
  return x;
}

// MT: m16 tiles of the group's rows (1, 2 or 4; 48 rows take 4).  Warp w
// < CONSUMERS holds tile w % MT and takes the tiles it ≡ w / MT (mod
// CONSUMERS / MT) of the split; warp CONSUMERS is the producer.
template <int HD, int VD, int MT>
__global__ void __launch_bounds__(THREADS, HD + VD > 384 ? 1 : 2)
    flash_decode_mma_kernel(const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ Args a) {
  using S = Shape<HD, VD>;
  constexpr int KT = S::KT, KS = CONSUMERS / MT, ROWS = 16 * MT;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  float* so = reinterpret_cast<float*>(gbase);              // [KS][ROWS][VD], at the end
  float* sm = reinterpret_cast<float*>(gbase + S::RING);    // [KS][ROWS]
  float* sl = sm + CONSUMERS * 16;                          // [KS][ROWS]
  float* fm = sl + CONSUMERS * 16;                          // [ROWS]: the block's joined m
  float* fl = fm + 64;                                      // and l
  const uint32_t full = base + S::RING + 4 * (2 * CONSUMERS * 16 + 2 * 64);  // [STAGES]
  const uint32_t empty = full + 8 * STAGES;                                  // [STAGES]

  const int split = blockIdx.x;
  int blk = blockIdx.y;
  const int kvh = blk % a.KV;
  blk /= a.KV;
  const int b = blk % a.B, n = blk / a.B;
  const int G = a.H / a.KV;
  int qoff, lo, hi;
  dec::key_range(n, a.shards, a.Sk, a.q_off, a.kv_len, a.Sq, a.causal, a.window, qoff, lo, hi);
  // this split's whole tiles of the visible range
  const int s_lo = lo + static_cast<int>(static_cast<long long>(split) * a.tiles / a.splits) * KT;
  const int s_hi =
      min(hi, lo + static_cast<int>(static_cast<long long>(split + 1) * a.tiles / a.splits) * KT);
  const int ntiles = s_hi > s_lo ? (s_hi - s_lo + KT - 1) / KT : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, MT);  // every warp that reads the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS) {  // the producer: one thread keeps the ring full
    if (lane == 0) {
#pragma unroll 1
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + 8 * st, (it / STAGES + 1) & 1);
        mbar_expect_tx(full + 8 * st, S::STAGE);
        const uint32_t kst = base + st * S::STAGE, vst = kst + S::K_BYTES;
        const int t0 = s_lo + it * KT;
#pragma unroll 1
        for (int c = 0; c < S::HC; ++c)
          tma_load(kst + c * KT * 128, &tk, full + 8 * st, 64 * c, kvh, t0, b, n);
#pragma unroll 1
        for (int c = 0; c < S::VC; ++c)
          tma_load(vst + c * KT * 128, &tv, full + 8 * st, 64 * c, kvh, t0, b, n);
      }
    }
    __syncwarp();
  } else {
    // a consumer: rows r0 = 16 · mt + lane / 4 and r1 = r0 + 8 of its m
    // tile, columns 2t, 2t + 1 of every 8-wide block
    const int mt = warp % MT, ks = warp / MT;
    const int g = lane / 4, t = lane % 4;
    const int r0 = 16 * mt + g, r1 = r0 + 8;
    const int pmin = qoff, pmax = qoff + a.Sq - 1;
    // a padded row (r >= R) scores zeros at the last row's position
    const int pos0 = qoff + (r0 < a.R ? r0 % a.Sq : a.Sq - 1);
    const int pos1 = qoff + (r1 < a.R ? r1 % a.Sq : a.Sq - 1);
    // q as the A operand: the raw bf16 pairs (the scale goes on the fp32
    // product), zero past R
    uint32_t qa[HD / 16][4];
    {
      const __nv_bfloat16* q0 =
          static_cast<const __nv_bfloat16*>(a.q) + n * a.qs[0] + b * a.qs[1] +
          static_cast<long long>(r0 % a.Sq) * a.qs[2] + (kvh * G + r0 / a.Sq) * a.qs[3];
      const __nv_bfloat16* q1 =
          static_cast<const __nv_bfloat16*>(a.q) + n * a.qs[0] + b * a.qs[1] +
          static_cast<long long>(r1 % a.Sq) * a.qs[2] + (kvh * G + r1 / a.Sq) * a.qs[3];
      const bool in0 = r0 < a.R, in1 = r1 < a.R;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = 16 * kk + 2 * t;
        qa[kk][0] = in0 ? *reinterpret_cast<const uint32_t*>(q0 + c) : 0u;
        qa[kk][1] = in1 ? *reinterpret_cast<const uint32_t*>(q1 + c) : 0u;
        qa[kk][2] = in0 ? *reinterpret_cast<const uint32_t*>(q0 + c + 8) : 0u;
        qa[kk][3] = in1 ? *reinterpret_cast<const uint32_t*>(q1 + c + 8) : 0u;
      }
    }
    float o[VD / 8][4];
#pragma unroll
    for (int i = 0; i < VD / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    // this lane's row and 16-byte chunk of an ldmatrix: matrix lane / 8,
    // its row lane % 8 (the 128-byte swizzle's phase)
    const int mi = lane / 8, rr = lane % 8;

#pragma unroll 1
    for (int it = ks; it < ntiles; it += KS) {
      const int st = it % STAGES;
      mbar_wait(full + 8 * st, (it / STAGES) & 1);
      const uint32_t kst = base + st * S::STAGE, vst = kst + S::K_BYTES;
      const int t0 = s_lo + it * KT;
      // keys of the tile past the split: V's rows zeroed (P is 0 there,
      // and 0 · a NaN in the cache's unwritten rows would not be)
      const int past = t0 + KT - s_hi;
      if (past > 0) {
        uint4* vz = reinterpret_cast<uint4*>(gbase + st * S::STAGE + S::K_BYTES);
        const int first = KT - past;
        for (int x = lane; x < past * 8 * S::VC; x += 32) {
          const int c = x / (8 * past), y = x % (8 * past);
          vz[(c * KT + first + y / 8) * 8 + y % 8] = make_uint4(0u, 0u, 0u, 0u);
        }
        __syncwarp();
      }

      // S = Q · Kᵀ over the tile: K's rows by ldmatrix, two 8-key blocks
      // and one 16-wide k step each
      float s[KT / 8][4];
#pragma unroll
      for (int i = 0; i < KT / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int chunk = 2 * kk + (mi & 1);
#pragma unroll
        for (int nb = 0; nb < KT / 16; ++nb) {
          const int key = 16 * nb + 8 * (mi >> 1) + rr;
          uint32_t bk[4];
          ldsm4(bk, kst + (chunk >> 3) * KT * 128 + key * 128 + (((chunk & 7) ^ rr) << 4));
          mma(s[2 * nb], qa[kk], bk[0], bk[1]);
          mma(s[2 * nb + 1], qa[kk], bk[2], bk[3]);
        }
      }
      // scale (capped first when cap > 0) into log2 units; −inf where the
      // key is past the split or hidden from the row, only on a tile that
      // crosses such an edge
      if (a.cap > 0.f) {
#pragma unroll
        for (int i = 0; i < KT / 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = tanhf(s[i][j] * a.scale / a.cap) * a.cap * LOG2E;
      } else {
        const float c = a.scale * LOG2E;
#pragma unroll
        for (int i = 0; i < KT / 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] *= c;
      }
      const bool whole = past <= 0 && (!a.causal || (t0 + KT - 1 <= pmin &&
                                                     (a.window == 0 || t0 > pmax - a.window)));
      if (!whole) {
#pragma unroll
        for (int i = 0; i < KT / 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int key = t0 + 8 * i + 2 * t + (j & 1);
            const int pos = (j & 2) ? pos1 : pos0;
            const bool seen = key < s_hi && (!a.causal || (key <= pos && (a.window == 0 ||
                                                                          key > pos - a.window)));
            if (!seen) s[i][j] = -INFINITY;
          }
      }
      // the online softmax on rows r0 and r1 (4 lanes a row); a row that
      // has seen no key yet keeps m = −inf and adds nothing
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < KT / 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(s[i][0], s[i][1]));
        mx1 = fmaxf(mx1, fmaxf(s[i][2], s[i][3]));
      }
#pragma unroll
      for (int sh = 1; sh <= 2; sh *= 2) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
      }
      const float b0 = mx0 == -INFINITY ? 0.f : mx0, b1 = mx1 == -INFINITY ? 0.f : mx1;
      const float al0 = ex2(m0 - b0), al1 = ex2(m1 - b1);
      m0 = mx0;
      m1 = mx1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < KT / 8; ++i) {
        s[i][0] = ex2(s[i][0] - b0);
        s[i][1] = ex2(s[i][1] - b0);
        s[i][2] = ex2(s[i][2] - b1);
        s[i][3] = ex2(s[i][3] - b1);
        ps0 += s[i][0] + s[i][1];
        ps1 += s[i][2] + s[i][3];
      }
      l0 = l0 * al0 + ps0;  // this thread's share; the 4 lanes add at the end
      l1 = l1 * al1 + ps1;
#pragma unroll
      for (int i = 0; i < VD / 8; ++i) {
        o[i][0] *= al0;
        o[i][1] *= al0;
        o[i][2] *= al1;
        o[i][3] *= al1;
      }
      // O += P_hi · V + P_lo · V: the score fragments of keys 16kc ..
      // 16kc + 15 are P's A operand as they stand; V's B fragments by
      // ldmatrix.trans, two 8-wide column blocks each
#pragma unroll
      for (int kc = 0; kc < KT / 16; ++kc) {
        uint32_t phi[4], plo[4];
        tc::split(s[2 * kc][0], s[2 * kc][1], phi[0], plo[0]);
        tc::split(s[2 * kc][2], s[2 * kc][3], phi[1], plo[1]);
        tc::split(s[2 * kc + 1][0], s[2 * kc + 1][1], phi[2], plo[2]);
        tc::split(s[2 * kc + 1][2], s[2 * kc + 1][3], phi[3], plo[3]);
        const int key = 16 * kc + 8 * (mi & 1) + rr;
#pragma unroll
        for (int nd = 0; nd < VD / 16; ++nd) {
          const int chunk = 2 * nd + (mi >> 1);
          uint32_t bv[4];
          ldsm4_t(bv, vst + (chunk >> 3) * KT * 128 + key * 128 + (((chunk & 7) ^ rr) << 4));
          mma(o[2 * nd], phi, bv[0], bv[1]);
          mma(o[2 * nd], plo, bv[0], bv[1]);
          mma(o[2 * nd + 1], phi, bv[2], bv[3]);
          mma(o[2 * nd + 1], plo, bv[2], bv[3]);
        }
      }
      // the zeroed rows ordered before the next TMA write into the stage
      if (past > 0) fence_async_shared();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh *= 2) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
      l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
    }
    // the warp's (m, l, unnormalised O) into shared memory once every
    // warp is done with the ring (the barrier below comes first)
    __syncthreads();
    float* sw = so + (ks * ROWS) * VD;
#pragma unroll
    for (int i = 0; i < VD / 8; ++i) {
      const int d = 8 * i + 2 * t;
      *reinterpret_cast<float2*>(sw + r0 * VD + d) = make_float2(o[i][0], o[i][1]);
      *reinterpret_cast<float2*>(sw + r1 * VD + d) = make_float2(o[i][2], o[i][3]);
    }
    if (t == 0) {
      sm[ks * ROWS + r0] = m0;
      sm[ks * ROWS + r1] = m1;
      sl[ks * ROWS + r0] = l0;
      sl[ks * ROWS + r1] = l1;
    }
  }
  if (warp == CONSUMERS) __syncthreads();  // the consumers' barrier above
  __syncthreads();

  // the warps' key slices joined in slice order, in place into slice 0:
  // O = Σ O_k 2^(m_k − M), L = Σ l_k 2^(m_k − M), M = max m_k
  for (int x = threadIdx.x; x < a.R * VD; x += THREADS) {
    const int r = x / VD, d = x % VD;
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < KS; ++k) mx = fmaxf(mx, sm[k * ROWS + r]);
    const float bm = mx == -INFINITY ? 0.f : mx;
    float osum = 0.f, lsum = 0.f;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const float w = ex2(sm[k * ROWS + r] - bm);
      osum += so[(k * ROWS + r) * VD + d] * w;
      lsum += sl[k * ROWS + r] * w;
    }
    so[r * VD + d] = osum;
    if (d == 0) {
      fm[r] = mx;
      fl[r] = lsum;
    }
  }

  const int R = a.R;
  if (!a.cluster) {
    __syncthreads();
    // the scratch path: this split's partials, joined by a second kernel
    for (int x = threadIdx.x; x < R * VD; x += THREADS) {
      const int r = x / VD, d = x % VD, i = r % a.Sq, h = kvh * G + r / a.Sq;
      const long long p =
          ((static_cast<long long>(n * a.B + b) * a.H + h) * a.Sq + i) * a.splits + split;
      a.part_o[p * VD + d] = so[r * VD + d];
      if (d == 0) {
        a.part_ml[2 * p] = fm[r];
        a.part_ml[2 * p + 1] = fl[r];
      }
    }
    return;
  }
  // the cluster's splits joined in split order through distributed shared
  // memory: block `split` writes every splits-th output of the group
  cluster_sync();
  const uint32_t so_u = smem_u32(so), fm_u = smem_u32(fm), fl_u = smem_u32(fl);
  for (int x = split * THREADS + threadIdx.x; x < R * VD; x += a.splits * THREADS) {
    const int r = x / VD, d = x % VD, i = r % a.Sq, h = kvh * G + r / a.Sq;
    float mx = -INFINITY;
    for (int c = 0; c < a.splits; ++c) mx = fmaxf(mx, ld_cluster(fm_u + 4 * r, c));
    const float bm = mx == -INFINITY ? 0.f : mx;
    float osum = 0.f, lsum = 0.f;
    for (int c = 0; c < a.splits; ++c) {
      const float w = ex2(ld_cluster(fm_u + 4 * r, c) - bm);
      osum += ld_cluster(so_u + 4 * (r * VD + d), c) * w;
      lsum += ld_cluster(fl_u + 4 * r, c) * w;
    }
    // a row without a key (a shard's only): o = 0, lse = −inf
    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + n * a.os[0] + b * a.os[1] +
                        static_cast<long long>(i) * a.os[2] + h * a.os[3];
    op[d] = __float2bfloat16(mx == -INFINITY ? 0.f : osum / fmaxf(lsum, 1e-30f));
    if (d == 0) {
      const long long row = (static_cast<long long>(n * a.B + b) * a.H + h) * a.Sq + i;
      a.lse[row] = mx == -INFINITY ? -INFINITY : mx * LN2 + logf(lsum);
    }
  }
  cluster_sync();  // no block leaves while another reads its shared memory
}

template <int HD, int VD, int MT>
cudaError_t launch_mt(const CUtensorMap& mk, const CUtensorMap& mv, const Args& a, int N,
                      cudaStream_t s) {
  using Sh = Shape<HD, VD>;
  const auto kernel = flash_decode_mma_kernel<HD, VD, MT>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, N * a.B * a.KV, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = Sh::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster ? a.splits : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, mk, mv, a);
  if (e != cudaSuccess) return e;
  e = cudaGetLastError();
  if (e != cudaSuccess || a.cluster) return e;
  dec::Args j = {};
  j.o = a.o;
  j.lse = a.lse;
  j.part_o = a.part_o;
  j.part_ml = a.part_ml;
  j.B = a.B;
  j.H = a.H;
  j.KV = a.KV;
  j.Sq = a.Sq;
  j.Sk = a.Sk;
  for (int i = 0; i < 4; ++i) j.os[i] = a.os[i];
  j.splits = a.splits;
  return dec::launch_join<__nv_bfloat16>(j, N, VD, s);
}

template <int HD, int VD>
cudaError_t launch(const void* k, const void* v, const Args& a, int N, const long long* strides,
                   cudaStream_t s) {
  using Sh = Shape<HD, VD>;
  CUtensorMap mk, mv;
  if (!make_map(&mk, k, N, a.B, a.Sk, a.KV, HD, strides + 4, Sh::KT) ||
      !make_map(&mv, v, N, a.B, a.Sk, a.KV, VD, strides + 8, Sh::KT))
    return cudaErrorInvalidValue;
  if (a.R <= 16) return launch_mt<HD, VD, 1>(mk, mv, a, N, s);
  if (a.R <= 32) return launch_mt<HD, VD, 2>(mk, mv, a, N, s);
  return launch_mt<HD, VD, 4>(mk, mv, a, N, s);
}

// Keys a tile at (hd, vd), 0 where the kernel takes no such pair
// (flash_attn.py::decode_tile is the same).
inline int tile_keys(int hd, int vd) {
  if (hd == vd) {
    switch (hd) {
      case 16: return Shape<16, 16>::KT;
      case 32: return Shape<32, 32>::KT;
      case 64: return Shape<64, 64>::KT;
      case 128: return Shape<128, 128>::KT;
      case 256: return Shape<256, 256>::KT;
      default: return 0;
    }
  }
  return hd == 192 && vd == 128 ? Shape<192, 128>::KT : 0;
}

cudaError_t launch_dims(const void* k, const void* v, const Args& a, int N, int hd, int vd,
                        const long long* strides, cudaStream_t s) {
  if (hd == vd) {
    switch (hd) {
      case 16: return launch<16, 16>(k, v, a, N, strides, s);
      case 32: return launch<32, 32>(k, v, a, N, strides, s);
      case 64: return launch<64, 64>(k, v, a, N, strides, s);
      case 128: return launch<128, 128>(k, v, a, N, strides, s);
      case 256: return launch<256, 256>(k, v, a, N, strides, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (hd == 192 && vd == 128) return launch<192, 128>(k, v, a, N, strides, s);
  return cudaErrorInvalidValue;
}

}  // namespace dmma


// ---------------------------------------------------------------------------
// fp32: 3xTF32 on the tensor cores (the note at the top of this file).
// ---------------------------------------------------------------------------

namespace f32 {

using tc::ex2;
using tc::LOG2E;
constexpr int STAGES = 2;  // K/V ring depth

template <int HD, int VD>
struct Shape {
  static constexpr int WARPS = 8;                  // 16 query rows each
  static constexpr int QT = 16 * WARPS;            // query rows a block
  static constexpr int THREADS = 32 * WARPS;
  // keys a tile: at hd 256 q alone takes 133 KB, and 8 keys keep the
  // 128 accumulator registers a thread free of spills
  static constexpr int KT = HD == 256 ? 8 : 32;
  static constexpr int HP = HD + 4, VP = VD + 4;   // padded rows, floats
  static constexpr int TILE = KT * (HP + VP);      // floats of a tile: K, then V
  // q, the ring's stages (each split in place into its big halves once
  // it lands), and the small halves of the tile in use
  static constexpr int SMEM = 4 * (QT * HP + (STAGES + 1) * TILE);
  static_assert(HD % 8 == 0 && VD % 8 == 0, "dims are multiples of 8");
  static_assert(SMEM <= 232448, "shared memory");
};

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero, on the 13 low bits: half of their weight added to the
// magnitude, then cut), in two integer operations; cvt.rna compiles to a
// longer sequence that took the kernel 6-15 % longer on an H100
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, each a TF32 value
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

// x's four values split: x keeps the big halves, lo gets the small ones
__device__ __forceinline__ void split4(float4& x, float4& lo) {
  uint32_t b, s;
  split(x.x, b, s);
  x.x = __uint_as_float(b);
  lo.x = __uint_as_float(s);
  split(x.y, b, s);
  x.y = __uint_as_float(b);
  lo.y = __uint_as_float(s);
  split(x.z, b, s);
  x.z = __uint_as_float(b);
  lo.z = __uint_as_float(s);
  split(x.w, b, s);
  x.w = __uint_as_float(b);
  lo.w = __uint_as_float(s);
}

// d += a · b, one m16n8k8 TF32 product (fp32 accumulate)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Chunks of 8 terms a sum takes on the tensor cores, from 0, before it
// is added to its running total in fp32 (the header: a tensor core
// truncates each sum to its largest addend)
constexpr int CHUNKS = 2;

// c += a · b (8 of the sum's terms) in three TF32 products, the smallest
// first: small·big, big·small, big·big (a's halves ab, as; b's bb0/bb1
// and bs0/bs1)
__device__ __forceinline__ void prod3(float (&c)[4], const uint32_t (&ab)[4],
                                      const uint32_t (&as)[4], uint32_t bb0, uint32_t bb1,
                                      uint32_t bs0, uint32_t bs1) {
  mma(c, as, bb0, bb1);
  mma(c, ab, bs0, bs1);
  mma(c, ab, bb0, bb1);
}

// One block: QT query rows of one (n, b, head), WARPS warps of 16 rows.
// vec16: every base 16-byte aligned and every stride a multiple of 4.
template <int HD, int VD>
__global__ void __launch_bounds__(Shape<HD, VD>::THREADS, 1)
    flash_fwd_tf32_kernel(const __grid_constant__ Args a, int vec16) {
  using S = Shape<HD, VD>;
  constexpr int KT = S::KT, HP = S::HP, VP = S::VP, QT = S::QT;
  extern __shared__ __align__(16) float fsm[];
  float* qsm = fsm;                         // [QT][HP]: fl32(q) · scale
  float* ring = fsm + QT * HP;              // [STAGES]: K [KT][HP], V [KT][VP]
  float* small = ring + STAGES * S::TILE;   // the same, the small halves

  const int bh = blockIdx.x;
  const int bb = bh / a.H, h = bh % a.H;
  const int n = bb / a.B, b = bb % a.B;
  const int kvh = h / (a.H / a.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QT;  // late tiles first
  // positions from here on count from the shard's first key
  const int qoff = a.q_off - shard_base(n, a.shards, a.Sk);
  const int klim = min(a.Sk, a.kv_len - shard_base(n, a.shards, a.Sk));  // may be <= 0
  // the key range any row of this block can see
  const int qlast = qoff + min(q0 + QT, a.Sq) - 1;
  int kbeg = 0, kend = klim;
  if (a.causal) {
    kend = min(klim, qlast + 1);
    if (a.window > 0 && qlast < klim) kbeg = max(0, qoff + q0 - a.window + 1) / KT * KT;
  }
  const int ntiles = (kend - kbeg + KT - 1) / KT;
  float* ob = static_cast<float*>(a.o) + n * a.os[0] + b * a.os[1] + h * a.os[3];
  float* lb = a.lse + static_cast<long long>(bh) * a.Sq;
  if (ntiles <= 0) {  // no row of the block sees a key (a shard's only)
    for (int i = threadIdx.x; i < QT * VD; i += S::THREADS) {
      const int row = q0 + i / VD;
      if (row < a.Sq) ob[row * a.os[2] + i % VD] = 0.f;
    }
    for (int i = threadIdx.x; i < QT; i += S::THREADS)
      if (q0 + i < a.Sq) lb[q0 + i] = -INFINITY;
    return;
  }

  const float* qb = static_cast<const float*>(a.q) + n * a.qs[0] + b * a.qs[1] + h * a.qs[3];
  const float* kbase = static_cast<const float*>(a.k) + n * a.ks[0] + b * a.ks[1] + kvh * a.ks[3];
  const float* vbase = static_cast<const float*>(a.v) + n * a.vs[0] + b * a.vs[1] + kvh * a.vs[3];
  // tile `it` into its stage; keys past the block's range zero-filled
  auto load_tile = [&](int it) {
    float* kst = ring + (it % STAGES) * S::TILE;
    float* vst = kst + KT * HP;
    const int key0 = kbeg + it * KT;
    if (vec16) {
      constexpr int KC = HD / 4, PER = (HD + VD) / 4;
      for (int c = threadIdx.x; c < KT * PER; c += S::THREADS) {
        const int j = c / PER, w = c % PER, key = key0 + j;
        const bool in = key < kend;
        const float* src = w < KC ? kbase + static_cast<long long>(key) * a.ks[2] + 4 * w
                                  : vbase + static_cast<long long>(key) * a.vs[2] + 4 * (w - KC);
        float* dst = w < KC ? kst + j * HP + 4 * w : vst + j * VP + 4 * (w - KC);
        dec::cp_async16(dst, in ? src : kbase, in ? 16 : 0);
      }
    } else {
      for (int c = threadIdx.x; c < KT * (HD + VD); c += S::THREADS) {
        const int j = c / (HD + VD), w = c % (HD + VD), key = key0 + j;
        const bool in = key < kend;
        const float* src = w < HD ? kbase + static_cast<long long>(key) * a.ks[2] + w
                                  : vbase + static_cast<long long>(key) * a.vs[2] + (w - HD);
        float* dst = w < HD ? kst + j * HP + w : vst + j * VP + (w - HD);
        dec::cp_async4(dst, in ? src : kbase, in ? 4 : 0);
      }
    }
  };
  load_tile(0);
  dec::cp_commit();
  // q, scaled first (the fp32 order), while tile 0 lands; rows past Sq 0
  for (int c = threadIdx.x; c < QT * (HD / 4); c += S::THREADS) {
    const int r = c / (HD / 4), w = c % (HD / 4), row = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < a.Sq) {
      const float* src = qb + static_cast<long long>(row) * a.qs[2] + 4 * w;
      x = vec16 ? *reinterpret_cast<const float4*>(src)
                : make_float4(src[0], src[1], src[2], src[3]);
    }
    *reinterpret_cast<float4*>(qsm + r * HP + 4 * w) =
        make_float4(x.x * a.scale, x.y * a.scale, x.z * a.scale, x.w * a.scale);
  }

  // this thread's place in the warp's fragments: rows g and g + 8 of the
  // warp's 16, keys (and output columns) 2t and 2t + 1 of each 8
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_lo = q0 + 16 * warp;
  const int row0 = r_lo + g, row1 = row0 + 8;
  const int pos0 = qoff + row0, pos1 = qoff + row1;
  const float* qw = qsm + 16 * warp * HP;
  float acc[VD / 8][4];
#pragma unroll
  for (int i = 0; i < VD / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

#pragma unroll 1
  for (int it = 0; it < ntiles; ++it) {
    dec::cp_wait<0>();  // tile it has landed (this thread's copies)
    __syncthreads();    // everyone's, q too, and tile it - 1 is consumed
    if (it + 1 < ntiles) load_tile(it + 1);
    dec::cp_commit();
    // the tile split once for every warp: its big halves in place, its
    // small ones beside (the rows' padding too, never read)
    float* kt = ring + (it % STAGES) * S::TILE;
    for (int c = threadIdx.x; c < S::TILE / 4; c += S::THREADS) {
      float4 x = reinterpret_cast<float4*>(kt)[c], lo;
      split4(x, lo);
      reinterpret_cast<float4*>(kt)[c] = x;
      reinterpret_cast<float4*>(small)[c] = lo;
    }
    __syncthreads();
    if (r_lo >= a.Sq) continue;  // a warp past the last row
    const float* vt = kt + KT * HP;
    const float* ks = small;
    const float* vs = small + KT * HP;
    const int t0 = kbeg + it * KT;

    // S = (fl32(q) · scale) · Kᵀ, three TF32 products
    float s[KT / 8][4];
#pragma unroll
    for (int i = 0; i < KT / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    constexpr int SC = HD / 8 < CHUNKS ? HD / 8 : CHUNKS;
#pragma unroll 4  // in full, the loads run ahead and spill
    for (int k0 = 0; k0 < HD / 8; k0 += SC) {
      uint32_t ab[SC][4], as[SC][4];
#pragma unroll
      for (int u = 0; u < SC; ++u) {
        const float* qa = qw + g * HP + 8 * (k0 + u) + t;
        split(qa[0], ab[u][0], as[u][0]);
        split(qa[8 * HP], ab[u][1], as[u][1]);
        split(qa[4], ab[u][2], as[u][2]);
        split(qa[8 * HP + 4], ab[u][3], as[u][3]);
      }
#pragma unroll
      for (int nb = 0; nb < KT / 8; ++nb) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int u = 0; u < SC; ++u) {
          const int o = (8 * nb + g) * HP + 8 * (k0 + u) + t;
          prod3(c, ab[u], as[u], bits(kt[o]), bits(kt[o + 4]), bits(ks[o]), bits(ks[o + 4]));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) s[nb][j] += c[j];
      }
    }

    // cap, then the masks, only where the tile crosses an edge of the
    // warp's rows: −1e30 where the causal mask or the window hides a key,
    // −inf past the block's range
    if (a.cap > 0.f) {
#pragma unroll
      for (int i = 0; i < KT / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = tanhf(s[i][j] / a.cap) * a.cap;
    }
    const int lo = qoff + r_lo;  // the warp's first position
    const bool whole = t0 + KT <= kend &&
                       (!a.causal || (t0 + KT - 1 <= lo &&
                                      (a.window == 0 || t0 > lo + 15 - a.window)));
    if (!whole) {
#pragma unroll
      for (int i = 0; i < KT / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = t0 + 8 * i + 2 * t + (j & 1);
          const int pos = (j & 2) ? pos1 : pos0;
          if (key >= kend) {
            s[i][j] = -INFINITY;
          } else if (a.causal && (key > pos || (a.window > 0 && key <= pos - a.window))) {
            s[i][j] = -1e30f;
          }
        }
    }
    // the online softmax on rows g and g + 8 (the tile holds a key of the
    // range, so each row's max is finite)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < KT / 8; ++i) {
      mx0 = fmaxf(mx0, fmaxf(s[i][0], s[i][1]));
      mx1 = fmaxf(mx1, fmaxf(s[i][2], s[i][3]));
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
    }
    const float al0 = ex2((m0 - mx0) * LOG2E), al1 = ex2((m1 - mx1) * LOG2E);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < KT / 8; ++i) {
      s[i][0] = ex2((s[i][0] - mx0) * LOG2E);
      s[i][1] = ex2((s[i][1] - mx0) * LOG2E);
      s[i][2] = ex2((s[i][2] - mx1) * LOG2E);
      s[i][3] = ex2((s[i][3] - mx1) * LOG2E);
      ps0 += s[i][0] + s[i][1];
      ps1 += s[i][2] + s[i][3];
    }
    l0 = l0 * al0 + ps0;  // this thread's share; the 4 lanes add at the end
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int i = 0; i < VD / 8; ++i) {
      acc[i][0] *= al0;
      acc[i][1] *= al0;
      acc[i][2] *= al1;
      acc[i][3] *= al1;
    }

    // O += P · V, three TF32 products: the score fragment is P's A
    // fragment, k-slot t key 2t and k-slot t + 4 key 2t + 1
    constexpr int PC = KT / 8 < CHUNKS ? KT / 8 : CHUNKS;
#pragma unroll
    for (int k0 = 0; k0 < KT / 8; k0 += PC) {
      uint32_t pb[PC][4], ps[PC][4];
#pragma unroll
      for (int u = 0; u < PC; ++u) {
        split(s[k0 + u][0], pb[u][0], ps[u][0]);
        split(s[k0 + u][2], pb[u][1], ps[u][1]);
        split(s[k0 + u][1], pb[u][2], ps[u][2]);
        split(s[k0 + u][3], pb[u][3], ps[u][3]);
      }
#pragma unroll
      for (int c = 0; c < VD / 8; ++c) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int u = 0; u < PC; ++u) {
          const int o = (8 * (k0 + u) + 2 * t) * VP + 8 * c + g;
          prod3(d, pb[u], ps[u], bits(vt[o]), bits(vt[o + VP]), bits(vs[o]), bits(vs[o + VP]));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[c][j] += d[j];
      }
    }
  }
  dec::cp_wait<0>();
  if (r_lo >= a.Sq) return;

  // the row sums over the 4 lanes, o / max(l, 1e-30) clipped at Sq and the
  // log-sum-exp m + log(l); a shard's row without a key writes o = 0 and
  // lse = −inf
#pragma unroll
  for (int sh = 1; sh <= 2; sh *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const bool none0 = a.shards > 0 && !row_sees(pos0, klim, a.causal, a.window);
  const bool none1 = a.shards > 0 && !row_sees(pos1, klim, a.causal, a.window);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int c = 0; c < VD / 8; ++c) {
    const int d = 8 * c + 2 * t;
    if (row0 < a.Sq)
      *reinterpret_cast<float2*>(ob + row0 * a.os[2] + d) =
          none0 ? make_float2(0.f, 0.f) : make_float2(acc[c][0] / d0, acc[c][1] / d0);
    if (row1 < a.Sq)
      *reinterpret_cast<float2*>(ob + row1 * a.os[2] + d) =
          none1 ? make_float2(0.f, 0.f) : make_float2(acc[c][2] / d1, acc[c][3] / d1);
  }
  if (t == 0) {
    if (row0 < a.Sq) lb[row0] = none0 ? -INFINITY : m0 + logf(l0);
    if (row1 < a.Sq) lb[row1] = none1 ? -INFINITY : m1 + logf(l1);
  }
}

template <int HD, int VD>
cudaError_t launch(const Args& a, int N, int vec16, cudaStream_t s) {
  using Sh = Shape<HD, VD>;
  const dim3 grid(N * a.B * a.H, (a.Sq + Sh::QT - 1) / Sh::QT);
  const auto kernel = flash_fwd_tf32_kernel<HD, VD>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<grid, Sh::THREADS, Sh::SMEM, s>>>(a, vec16);
  return cudaGetLastError();
}

cudaError_t launch_dims(const Args& a, int N, int hd, int vd, int vec16, cudaStream_t s) {
  if (hd == vd) {
    switch (hd) {
      case 16: return launch<16, 16>(a, N, vec16, s);
      case 32: return launch<32, 32>(a, N, vec16, s);
      case 64: return launch<64, 64>(a, N, vec16, s);
      case 128: return launch<128, 128>(a, N, vec16, s);
      case 256: return launch<256, 256>(a, N, vec16, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (hd == 192 && vd == 128) return launch<192, 128>(a, N, vec16, s);
  return cudaErrorInvalidValue;
}

}  // namespace f32

// The decode kernels: q, k, v, o, lse, strides, the mask and shards as
// for flash_attn_fwd below, at any (hd, vd) of the bf16 kernel, G · Sq <=
// 64 query rows a KV group; bf16 (dtype 1) on the tensor cores
// (flash_decode_mma_kernel), fp32 (dtype 0) on the CUDA cores
// (flash_decode_kernel).  tile, tiles and splits are flash_attn.py::
// decode_plan's (tile must be the dtype's kernel's own).  bf16 with
// cluster = 1: the splits (at most dmma::CLUSTER) are one thread block
// cluster and join in it; otherwise, with splits > 1, part_o (N·B·H·Sq,
// splits, vd) and part_ml (N·B·H·Sq, splits, 2) are fp32 scratch and a
// join kernel follows on the same stream.  vec16: every base 16-byte
// aligned and every stride a multiple of 16 bytes (bf16 must be: its K and
// V are read by TMA; fp32 otherwise copies 4 bytes at a time).  Returns
// the launches' cudaError_t (0 on success); launches nothing and returns
// cudaErrorInvalidValue for what it does not take.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                void* part_o, void* part_ml, int dtype, int hd, int vd, int N,
                                int B, int H, int KV, int Sq, int Sk, const long long* strides,
                                float scale, int causal, float cap, int window, int q_offset,
                                int kv_len, int shards, int tile, int tiles, int splits,
                                int cluster, int vec16, void* stream) {
  if (N < 1 || B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Sk < 1 || q_offset < 0 ||
      kv_len < 1 || shards < 0 || (dtype != 0 && dtype != 1) || H / KV * Sq > 64 ||
      tiles < 1 || splits < 1 || splits > tiles || splits > 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  cluster = cluster || splits == 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (!vec16 || tile != dmma::tile_keys(hd, vd) || splits > 65535 ||
        static_cast<long long>(N) * B * KV > 65535 || (cluster && splits > dmma::CLUSTER) ||
        (!cluster && (!part_o || !part_ml)))
      return static_cast<int>(cudaErrorInvalidValue);
    dmma::Args a;
    a.q = q;
    a.o = o;
    a.lse = static_cast<float*>(lse);
    a.part_o = static_cast<float*>(part_o);
    a.part_ml = static_cast<float*>(part_ml);
    a.B = B;
    a.H = H;
    a.KV = KV;
    a.Sq = Sq;
    a.Sk = Sk;
    for (int i = 0; i < 4; ++i) {
      a.qs[i] = strides[i];
      a.os[i] = strides[12 + i];
    }
    a.scale = scale;
    a.cap = cap;
    a.causal = causal;
    a.window = window;
    a.q_off = q_offset;
    a.kv_len = kv_len;
    a.shards = shards;
    a.R = H / KV * Sq;
    a.tiles = tiles;
    a.splits = splits;
    a.cluster = cluster;
    return static_cast<int>(dmma::launch_dims(k, v, a, N, hd, vd, strides, s));
  }
  if (splits > 1 && (!part_o || !part_ml)) return static_cast<int>(cudaErrorInvalidValue);
  dec::Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.part_o = static_cast<float*>(part_o);
  a.part_ml = static_cast<float*>(part_ml);
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.Sq = Sq;
  a.Sk = Sk;
  for (int i = 0; i < 4; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[4 + i];
    a.vs[i] = strides[8 + i];
    a.os[i] = strides[12 + i];
  }
  a.scale = scale;
  a.cap = cap;
  a.causal = causal;
  a.window = window;
  a.q_off = q_offset;
  a.kv_len = kv_len;
  a.shards = shards;
  a.R = H / KV * Sq;
  a.tile = tile;
  a.tiles = tiles;
  a.splits = splits;
  a.vec16 = vec16;
  if (tile != dec::tile_keys(hd, vd, a.R, &a.wk)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dec::launch_dims(a, N, hd, vd, s));
}

// q (N, B, Sq, H, hd), k (N, B, Sk, KV, hd), v (N, B, Sk, KV, vd), o (N, B,
// Sq, H, vd) in dtype (0 = fp32: the 3xTF32 kernel; 1 = bf16: the wgmma
// kernel), both at the (hd, vd) pairs (16, 16), (32, 32), (64, 64), (128,
// 128), (256, 256) and (192, 128); lse (N, B, H, Sq) fp32, contiguous.
// strides holds the (outer, batch, seq, head) element strides of q, k, v
// and o in that order; the bf16 kernel reads q, k and v by TMA, so their
// bases are 16-byte aligned and their strides multiples of 8 elements.
// vec16: every base of q, k, v 16-byte aligned and every stride a
// multiple of 16 bytes (bf16 must be; fp32 otherwise copies 4 bytes at a
// time).  Query row i sits at position q_offset + i and keys at or past
// kv_len are hidden (q_offset = 0 and kv_len = Sk: no such mask).
// shards = 0: every row must see a key (the caller makes sure of it);
// shards > 0: outer row n holds the (n mod shards)-th block of Sk keys of
// the sequence, and a row that sees none of them writes o = 0, lse =
// −inf.  Returns the launch's cudaError_t (0 on success); launches
// nothing and returns cudaErrorInvalidValue for arguments neither kernel
// takes.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                              void* lse, int dtype, int hd, int vd, int N, int B, int H,
                              int KV, int Sq, int Sk, const long long* strides, float scale,
                              int causal, float cap, int window, int q_offset, int kv_len,
                              int shards, int vec16, void* stream) {
  if (N < 1 || B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Sk < 1 ||
      Sq > 65535 * tc::QT || q_offset < 0 || kv_len < 1 || shards < 0 ||
      (dtype == 1 && !vec16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    tc::Args a;
    a.o = o;
    a.lse = static_cast<float*>(lse);
    a.B = B;
    a.H = H;
    a.KV = KV;
    a.Sq = Sq;
    a.Sk = Sk;
    for (int i = 0; i < 4; ++i) a.os[i] = strides[12 + i];
    a.scale = scale;
    a.cap = cap;
    a.causal = causal;
    a.window = window;
    a.q_off = q_offset;
    a.kv_len = kv_len;
    a.shards = shards;
    cudaError_t err = cudaErrorInvalidValue;
    if (hd == vd) {
      switch (hd) {
        case 16: err = tc::launch<16, 16>(q, k, v, a, N, strides, s); break;
        case 32: err = tc::launch<32, 32>(q, k, v, a, N, strides, s); break;
        case 64: err = tc::launch<64, 64>(q, k, v, a, N, strides, s); break;
        case 128: err = tc::launch<128, 128>(q, k, v, a, N, strides, s); break;
        case 256: err = tc::launch<256, 256>(q, k, v, a, N, strides, s); break;
        default: break;
      }
    } else if (hd == 192 && vd == 128) {
      err = tc::launch<192, 128>(q, k, v, a, N, strides, s);
    }
    return static_cast<int>(err);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
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
  for (int i = 0; i < 4; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[4 + i];
    a.vs[i] = strides[8 + i];
    a.os[i] = strides[12 + i];
  }
  a.scale = scale;
  a.cap = cap;
  a.causal = causal;
  a.window = window;
  a.q_off = q_offset;
  a.kv_len = kv_len;
  a.shards = shards;
  return static_cast<int>(f32::launch_dims(a, N, hd, vd, vec16, s));
}
