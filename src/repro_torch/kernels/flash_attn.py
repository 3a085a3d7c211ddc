"""CUDA kernels: flash attention forward (online softmax), for Hopper.

The port of the Pallas kernel ``repro/kernels/flash_attn.py::
flash_attention``: ``csrc/flash_attn.cu``, written by hand, computes
causal / sliding-window / tanh-capped attention with fp32 state over
``(B, Sq, H, hd)`` queries, ``(B, Sk, KV, hd)`` keys and ``(B, Sk, KV,
vd)`` values (GQA: head ``h`` reads KV head ``h // (H / KV)``), and
writes each query row's log-sum-exp beside the output.  Ragged
``Sq``/``Sk`` tails are masked in the kernel.  It is bound by
operations: ``2·(hd + vd)`` flops per visible (query, key) pair.

Masked decode: ``q_offset`` places query row ``i`` at position
``q_offset + i`` and ``kv_len`` hides the keys at or past it, the
reference's ``attend(q_pos=pos + arange(Sq), kv_len=pos + Sq)`` over a KV
cache.  The kernel streams only the keys some row can see, so a decode
step reads the cache's filled part; it is then bound by those bytes.

Rank axes: the tensors may also be ``(N, B, S, heads, d)``, an outer and
an inner batch dim each with a stride of its own, so that one layer's
slice of a cache laid out ``(ranks, L, B, S, KV, hd)`` is read where it
lies.  Partial attention over a sequence split across ``shards`` ranks
(``shards=``, the sharded serving's decode): outer row ``n`` holds the
``(n mod shards)``-th block of ``Sk`` keys, key ``j`` at the absolute
position ``(n mod shards)·Sk + j``, the masks and ``kv_len`` apply there,
and a query row that sees none of its block's keys gets ``o = 0`` and
``lse = -inf``; ``core.tp.lse_combine`` joins the blocks' results.

The shape picks a decode kernel: a launch whose KV group holds at most
``DECODE_ROWS`` query rows (``G·Sq``, ``G = H / KV``: every decode step,
masked, cross or partial) runs one block a (batch row, KV head, split of
the visible keys), which reads the cache once; :func:`decode_plan`
splits the keys.  bf16 runs ``flash_decode_mma_kernel``: the scores and
P·V on the tensor cores (``mma.sync``, the group's rows padded to m16
tiles, P split into two bf16 halves), K and V by TMA into a ring of
``DECODE_STAGES`` fed by a producer warp, and the splits joined inside a
thread block cluster (:func:`decode_cluster`; otherwise through scratch
and a join kernel).  fp32 runs ``flash_decode_kernel`` on the CUDA cores,
a second kernel joining its splits.  Every other launch is a training or
prefill one, and the dtype picks its kernel, both on the tensor cores:
bf16 runs ``flash_fwd_wgmma_kernel`` (``wgmma`` fed by TMA, probabilities
split into two bf16 halves), fp32 ``flash_fwd_tf32_kernel`` (``mma.sync``
in TF32, each operand split into a TF32 big and small part and each
product taken three times, small·big + big·small + big·big, which holds
fp32 to the reference's 3e-5; K and V through a ``cp.async`` ring).
Every kernel takes the head dims ``TC_DIMS``.  ``launches`` counts every
launch, ``tc_launches`` the bf16 tensor-core kernel's alone,
``fp32_launches`` the fp32 one's, ``decode_launches`` either decode
kernel's, ``decode_mma_launches`` the bf16 decode kernel's.

``FlashAttention`` is the ``torch.autograd.Function`` around it.  The
JAX package has no backward kernel (its training path differentiates
the attention through XLA); the port's backward is a kernel of its own,
``csrc/flash_bwd.cu`` (:func:`attention_bwd`): a pass for ``D = Σ dO·O``
(16-byte loads, several rows a warp; :func:`attention_dot` alone),
a dK/dV kernel (one block a KV head and tile of keys, looping over the
group's heads and the query tiles that see them) and a dQ kernel (one
block a head and tile of query rows), both recomputing the
probabilities from the forward's saved log-sum-exp on the tensor cores,
without atomics, at every ``TC_DIMS`` pair.  bf16 runs
``flash_bwd_dkdv_wgmma_kernel`` and ``flash_bwd_dq_wgmma_kernel``:
``wgmma`` fed by TMA from a producer warpgroup, P and dS kept in
registers as the products' A operand (at hd 256 the dK/dV kernel's two
consumers share them through shared memory), tiles ``BWD_TILES``.  fp32
runs ``flash_bwd_dkdv_tf32_kernel`` and ``flash_bwd_dq_tf32_kernel``:
the same structure on ``wgmma`` in TF32, each product taken three times
(small·big + big·small + big·big), each landed tile split once in shared
memory by the producer's other warps into its TF32 big and small parts
and, where a product wants it, transposed (TF32 ``wgmma`` reads shared
memory K-major only), tiles ``BWD_TF32_TILES``; at the wide pairs (256,
256) and (192, 128), whose split K and V do not fit beside a stage, the
same kernels keep a block's K and V (dQ: Q and dO) as they land and
split their fragments in registers, take the products along a stage's
rows transposed (dVᵀ = dOᵀ·P, dKᵀ = Qᵀ·dS, dQᵀ = Kᵀ·dSᵀ, P and dS split
into shared memory as the B operand) and give each consumer a role
(scores and dV, or dP and dK).  ``bwd_launches`` counts its launches
(one a backward), ``bwd_tf32_launches`` those on the fp32 ``wgmma``
kernels alone: every fp32 backward.  Its plain version is
``ref.flash_attention_bwd``, which the tests and ``chip_smoke.py`` hold
it against.

The sources are compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/`` beside this file and loaded with ``ctypes`` (``build.py``);
the kernels launch on PyTorch's current stream.  Nothing is built when
this module is imported.  The plain version of the forward is
``ref.flash_attention_bshd``; ``ops`` picks between them by device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref as _ref

SOURCE = _build.CSRC / "flash_attn.cu"
BWD_SOURCE = _build.CSRC / "flash_bwd.cu"

#: dtype codes of the C entry point
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (hd, vd) every kernel takes, in either dtype
TC_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (256, 256), (192, 128))
#: query rows a block (the grid's second dimension is ceil(Sq / QT))
QT = 128
#: the most query rows of a KV group (``G·Sq``) the decode kernel holds
DECODE_ROWS = 64
#: the card's SMs (an H100 SXM's 132): the decode plans cover them
SMS = 132
#: the fp32 decode kernel's warps a block, keys a lane group scores before
#: an update, and the bytes of K and V a stage of its 3-stage ring aims at
#: (``csrc/flash_attn.cu``'s ``dec::WARPS``, ``KB``, ``TILE_BYTES``)
DECODE_WARPS, DECODE_KB, DECODE_TILE_BYTES = 8, 2, 32768
#: the most splits a decode launch takes (the join's shared memory)
DECODE_SPLITS = 4096
#: the bf16 decode kernel's ring: its stages, two a consumer warp
#: (``dmma::STAGES``)
DECODE_STAGES = 8
#: the bf16 decode kernel's consumer warps (``dmma::CONSUMERS``): each
#: holds one m16 tile of the group's rows (:func:`decode_row_tiles`) and
#: takes every ``DECODE_CONSUMERS / row tiles``-th key tile of the split
DECODE_CONSUMERS = 4
#: a bf16 decode block's start and end in tile times, where its plan
#: balances several waves of blocks (PERF.md §6, the design runs)
DECODE_BLOCK_TILES = 8
#: the most splits the bf16 decode kernel joins inside one thread block
#: cluster (``dmma::CLUSTER``, the portable cluster size); a plan of more
#: splits writes them to scratch, and a second kernel joins them
DECODE_CLUSTER = 8


class BwdTiles(NamedTuple):
    """The backward kernels' tiles at one ``(hd, vd)`` pair
    (``csrc/flash_bwd.cu``'s ``KvTile`` and ``QTile``): the dK/dV
    kernel's keys a block and query rows a stage (its loop takes the
    group's heads in turn, each head's stages from the first row that
    sees the block's keys), the dQ kernel's query rows a block and keys a
    stage (from the first key a row of the block sees); ``alternate``: the
    fp32 dK/dV kernel's two consumers take alternate stages whole, else
    (bf16, fp32 at hd 128) each its share of every stage; ``whole``: one
    consumer sums each stage's dK and another its dV (fp32's wide pairs);
    ``chunk``: the head dims S and dP sum in place from 0 before the
    chunks are added in fp32 (0: the whole head dim)."""
    keys: int
    rows: int
    dq_rows: int
    dq_keys: int
    alternate: bool = False
    whole: bool = False
    chunk: int = 0


#: the bf16 backward kernels' tiles by ``(hd, vd)``: dK and dV of a
#: block's keys in registers (wide, hd 256: its 64 keys shared by the two
#: consumers); 32 query rows a stage where dK and dV take 160 registers
BWD_TILES = {(16, 16): BwdTiles(128, 64, 128, 128),
             (32, 32): BwdTiles(128, 64, 128, 128),
             (64, 64): BwdTiles(128, 64, 128, 128),
             (128, 128): BwdTiles(128, 64, 128, 64),
             (256, 256): BwdTiles(64, 64, 128, 32),
             (192, 128): BwdTiles(128, 32, 128, 64)}

#: the fp32 backward kernels' tiles by ``(hd, vd)`` (``csrc/flash_bwd.cu``'s
#: ``tf::KvTile`` and ``tf::QTile``, and ``tf::Wide`` at the wide pairs): 64
#: keys a dK/dV block, its two consumers taking alternate stages of 32 rows
#: (at hd 128, whose ring holds one stage, halves of every stage of 16); a
#: dQ block of 128 rows (64 at hd 128, whose split Q and dO take 128 KB).
#: At (256, 256) and (192, 128) a block holds its 64 keys' K and V (dQ: its
#: 64 rows' Q and dO) as they land, stages of 16 rows (dQ: keys), each
#: stage's dK and dV summed by one consumer apiece, S and dP from 0 over
#: each 128 of the head dim.
BWD_TF32_TILES = {(16, 16): BwdTiles(64, 32, 128, 32, True),
                  (32, 32): BwdTiles(64, 32, 128, 32, True),
                  (64, 64): BwdTiles(64, 32, 128, 32, True),
                  (128, 128): BwdTiles(64, 16, 64, 16),
                  (256, 256): BwdTiles(64, 16, 64, 16, whole=True,
                                       chunk=128),
                  (192, 128): BwdTiles(64, 16, 64, 16, whole=True,
                                       chunk=128)}

#: Kernel launches so far, either kernel; the wrapper adds one per launch
#: and nothing else touches it but a caller that resets it.
launches = 0
#: The bf16 tensor-core kernel's launches alone, counted the same way.
tc_launches = 0
#: The fp32 (3xTF32) kernel's launches alone.
fp32_launches = 0
#: The partial launches over a shard of the keys alone (``shards=``).
partial_launches = 0
#: Either decode kernel's launches (a launch with a join counts once).
decode_launches = 0
#: The bf16 decode kernel's launches alone (``flash_decode_mma_kernel``).
decode_mma_launches = 0
#: The backward's launches (its three kernels count once), counted apart
#: from ``launches``, which counts forward launches only.
bwd_launches = 0
#: The backward's launches on the fp32 TF32 ``wgmma`` kernels alone
#: (every fp32 backward).
bwd_tf32_launches = 0
#: The D kernel's launches on its own (:func:`attention_dot`); inside a
#: backward it is counted by ``bwd_launches``.
dot_launches = 0


@functools.cache
def _entry():
    fn = _build.load(SOURCE).flash_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _decode_entry():
    fn = _build.load(SOURCE).flash_decode_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_entry():
    fn = _build.load(BWD_SOURCE).flash_attn_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_int, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _dot_entry():
    fn = _build.load(BWD_SOURCE).flash_bwd_dot
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def decodes(h: int, kv: int, sq: int) -> bool:
    """Whether a launch of ``h`` query heads over ``kv`` KV heads and ``sq``
    query rows takes the decode kernel: its KV group's ``G·Sq`` rows fit
    in one block (the shape alone decides)."""
    return h // kv * sq <= DECODE_ROWS


def dims(dtype: torch.dtype, h: int, kv: int, sq: int) -> tuple:
    """The (hd, vd) pairs a launch of this dtype and shape can take:
    ``TC_DIMS``, whichever kernel the dtype and the shape pick."""
    return TC_DIMS


def decode_lanes(hd: int, rows: int) -> int:
    """Lanes a key of the fp32 decode kernel for ``rows`` query rows a
    block: ``hd / 16`` (a warp holds 2 rows, up to 16), ``hd / 8`` above
    16 rows (8 a warp), 16 at hd 192 (``dec::lanes``)."""
    return 16 if hd == 192 else hd // 8 if rows > 16 else hd // 16


def decode_tile(hd: int, vd: int, esize: int, rows: int) -> int:
    """Keys a stage of a decode kernel's ring for ``rows`` query rows.
    bf16 (``esize`` 2, ``dmma::Shape::KT``), whatever the rows: 32 keys
    where a key's K and V, each padded to a 64-wide box, take at most 512
    bytes (hd up to 128), else 16 (hd 256, (192, 128)): the design runs'
    best (PERF.md §6).  fp32 (``dec::tile_keys``): whole
    batches (``DECODE_KB`` keys of every lane group of a warp,
    ``32 / decode_lanes`` groups), about ``DECODE_TILE_BYTES``."""
    if esize == 2:
        return 32 if 2 * (max(hd, 64) + max(vd, 64)) <= 512 else 16
    batch = 32 // decode_lanes(hd, rows) * DECODE_KB
    return batch * max(1, DECODE_TILE_BYTES // (batch * (hd + vd) * esize))


def decode_row_tiles(rows: int) -> int:
    """The bf16 decode kernel's m16 tiles for ``rows`` query rows of a KV
    group: 1, 2 or 4 (48 rows take 4), one a consumer warp."""
    return 1 if rows <= 16 else 2 if rows <= 32 else 4


class DecodePlan(NamedTuple):
    """How a decode launch splits its keys: ``tile`` keys a stage,
    ``tiles`` tiles in the widest visible range of a block, ``splits``
    contiguous runs of whole tiles, each a block of its own
    (``ref.split_keys`` gives split ``s``'s keys)."""
    tile: int
    tiles: int
    splits: int


def decode_plan(n: int, b: int, h: int, kv: int, sq: int, sk: int,
                hd: int, vd: int, dtype: torch.dtype, *, causal: bool,
                window: int, q_offset: int, kv_len: int,
                shards: int | None = None) -> DecodePlan:
    """The decode launch's splits of the visible range of each outer row's
    keys (``ref.visible_keys``, the widest over the shards), in whole
    tiles, never more splits than tiles, for a grid of ``n·b·kv`` blocks
    a split.  bf16 (:func:`_mma_splits`): enough splits that the grid
    covers the SMs within one wave of the blocks they hold, as long as
    each block keeps at least ``DECODE_STAGES`` tiles to fill its ring;
    :func:`decode_cluster` says how they join.  fp32
    (:func:`_splits`): at least as many splits as give the grid ``2·SMS``
    blocks; of those counts, up to four times the least, the one whose
    waves of blocks take the fewest tile times.  The choice is kept for
    each shape: a decode step asks once a layer, at a new position."""
    tile = _decode_tile(hd, vd, _ESIZE[dtype], h // kv * sq)
    ranges = [_ref.visible_keys(sq, sk, causal=causal, window=window,
                                q_offset=q_offset, kv_len=kv_len, base=k0)
              for k0 in _bases(sk, shards)]
    tiles = max(1, -(-max(hi - lo for lo, hi in ranges) // tile))
    if dtype == torch.bfloat16:
        seen = sum(hi > lo for lo, hi in ranges)   # shards with a key
        return DecodePlan(tile, tiles, _mma_splits(
            n * b * kv, n * b * kv * seen // (shards or 1), tiles,
            decode_blocks_per_sm(hd, vd)))
    return DecodePlan(tile, tiles, _splits(n * b * kv, tiles, h // kv * sq))


_ESIZE = {torch.float32: 4, torch.bfloat16: 2}
_decode_tile = functools.lru_cache(maxsize=256)(decode_tile)


def decode_ring_bytes(hd: int, vd: int) -> int:
    """The bf16 decode kernel's ring at ``(hd, vd)``: ``DECODE_STAGES``
    tiles of K and V, each row padded to a 64-wide box."""
    return (DECODE_STAGES * decode_tile(hd, vd, 2, 1)
            * 2 * (max(hd, 64) + max(vd, 64)))


def decode_blocks_per_sm(hd: int, vd: int) -> int:
    """The bf16 decode kernel's blocks an SM holds at once at ``(hd,
    vd)``: two where two rings (and 2 KB beside each) fit an SM's 227 KB
    and the consumers keep within 204 registers a thread (``hd + vd <=
    384``), else one (hd 128's and hd 256's 128 KB rings)."""
    fits = 2 * (decode_ring_bytes(hd, vd) + 2048) <= 232448
    return 2 if fits and hd + vd <= 384 else 1


def decode_cluster(splits: int, hd: int, vd: int, blocks: int) -> bool:
    """Whether a bf16 decode launch of ``splits`` splits of ``blocks``
    blocks each joins them inside a thread block cluster (else through
    fp32 scratch and a second kernel): a single split, or at most
    ``DECODE_CLUSTER`` where the clusters are pairs or take at most three
    quarters of the blocks the SMs hold at once (a cluster's blocks must
    find room in one GPC together: near a full card, clusters of more
    than two waited for one, PERF.md §6)."""
    slots = SMS * decode_blocks_per_sm(hd, vd)
    return splits == 1 or (splits <= DECODE_CLUSTER and (
        splits <= 2 or 4 * blocks * splits <= 3 * slots))


@functools.lru_cache(maxsize=4096)
def _mma_splits(blocks: int, seen: int, tiles: int, per_sm: int) -> int:
    """:func:`decode_plan`'s bf16 split count for ``blocks`` blocks a
    split (``seen`` of them over keys some row sees: a partial launch's
    other shards end at once), ``tiles`` tiles and ``per_sm`` blocks an
    SM, never leaving a block fewer than ``DECODE_STAGES`` tiles where
    the keys allow: the fewest splits that give every SM a block, but no
    more blocks than the SMs hold at once; where the blocks that see
    keys outnumber those already, the count whose waves of blocks take
    the fewest tile times, a block's start and end counted as
    ``DECODE_BLOCK_TILES`` tiles (the last wave's tail balanced)."""
    slots = SMS * per_sm
    fill = min(tiles, max(1, tiles // DECODE_STAGES), DECODE_SPLITS)
    if seen > slots:
        return min(range(1, fill + 1), key=lambda s: (
            -(-seen * s // slots) * (-(-tiles // s) + DECODE_BLOCK_TILES),
            s))
    cover = -(-SMS // blocks)
    wave = max(1, slots // blocks)
    return max(1, min(cover, wave, fill))


@functools.lru_cache(maxsize=4096)
def _splits(blocks: int, tiles: int, rows: int) -> int:
    """:func:`decode_plan`'s fp32 split count for ``blocks`` blocks a
    split and ``tiles`` tiles."""
    least = min(tiles, -(-2 * SMS // blocks), DECODE_SPLITS)
    slots = SMS * (2 if rows <= 16 else 1)

    def cost(s):
        return -(-blocks * s // slots) * (-(-tiles // s) + 1)
    return min(range(least, min(tiles, 4 * least, DECODE_SPLITS) + 1),
               key=lambda s: (cost(s), s))


def _spans(sq: int, sk: int, *, causal: bool, window: int, q_offset: int,
           kv_len: int | None, base: int = 0) -> torch.Tensor:
    """Each query row's count of visible keys among the ``sk`` keys at
    the absolute positions ``base …``: the causal mask, the window and
    ``kv_len`` applied there."""
    klim = min(sk, (sk + base if kv_len is None else kv_len) - base)
    pos = q_offset - base + torch.arange(sq, dtype=torch.int64)
    if not causal:
        return torch.full((sq,), max(klim, 0), dtype=torch.int64)
    hi = torch.clamp(pos + 1, max=klim)
    lo = torch.clamp(pos - window + 1, min=0) if window > 0 else 0 * pos
    return torch.clamp(hi - lo, min=0)


def _bases(sk: int, shards: int | None) -> tuple:
    """The absolute position of each shard's first key (one shard, at 0,
    without ``shards``)."""
    return tuple(m * sk for m in range(shards or 1))


def flops(b: int, h: int, sq: int, sk: int, hd: int, *, causal: bool,
          window: int = 0, vd: int | None = None, q_offset: int = 0,
          kv_len: int | None = None, shards: int | None = None) -> int:
    """Flops one forward launch needs: ``2·hd`` for the score and ``2·vd``
    for its share of ``P·V``, for every (query, key) pair the mask leaves
    visible.  With ``shards`` the launch's ``b`` rows are spread evenly
    over the shards (rank-major), each over its own block of keys."""
    vd = hd if vd is None else vd
    pairs = sum(int(_spans(sq, sk, causal=causal, window=window,
                           q_offset=q_offset, kv_len=kv_len, base=k0).sum())
                for k0 in _bases(sk, shards))
    return 2 * (hd + vd) * pairs * (b // len(_bases(sk, shards))) * h


def bytes_moved(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kv_len: int | None = None, *, window: int = 0,
                q_offset: int = 0, shards: int | None = None) -> int:
    """Bytes one launch must move: q and the keys and values some query
    row can see read once (those below ``kv_len``, all of them by
    default, and with a causal ``window`` none before the first row's
    window, which starts at ``q_offset - window + 1``; with ``shards``
    those of each shard's block of keys, its rows spread evenly over the
    shards), the output ``(…, Sq, H, vd)`` and the fp32 log-sum-exp
    written once."""
    sq, h = q.shape[-3], q.shape[-2]
    rows = q.numel() // (sq * h * q.shape[-1])
    sk = k.shape[-3]
    per_key = (k.numel() * k.element_size()
               + v.numel() * v.element_size()) // sk
    lo = max(0, q_offset - window + 1) if window > 0 else 0
    bases = _bases(sk, shards)
    keys = sum(max(0, min(k0 + sk, k0 + sk if kv_len is None else kv_len)
                   - max(k0, lo)) for k0 in bases)
    out = rows * sq * h * v.shape[-1] * q.element_size()
    return (q.numel() * q.element_size() + per_key * keys // len(bases)
            + out + 4 * rows * h * sq)


def flops_bwd(b: int, h: int, sq: int, sk: int, hd: int, *, causal: bool,
              window: int = 0, vd: int | None = None) -> int:
    """Flops one backward launch needs: five products for every visible
    (query, key) pair of a training launch (``S``, ``dP``, ``dV``, ``dK``,
    ``dQ``), ``2·(3·hd + 2·vd)``; the kernel's dQ pass recomputes ``S``
    and ``dP``, which is not counted."""
    vd = hd if vd is None else vd
    pairs = int(_spans(sq, sk, causal=causal, window=window, q_offset=0,
                       kv_len=None).sum())
    return 2 * (3 * hd + 2 * vd) * pairs * b * h


def bytes_moved_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> int:
    """Bytes one backward launch must move: q, k, v, the output and its
    gradient (both ``(B, Sq, H, vd)`` in q's dtype) and the fp32
    log-sum-exp read once, dq, dk and dv written once."""
    b, sq, h, _ = q.shape
    ins = sum(t.numel() * t.element_size() for t in (q, k, v))
    out = 2 * b * sq * h * v.shape[-1] * q.element_size()
    return 2 * ins + out + 4 * b * h * sq


def rows_see_a_key(sq: int, sk: int, *, causal: bool, window: int,
                   q_offset: int, kv_len: int) -> bool:
    """Whether every query row sees at least one key under the mask.

    The kernel leaves out keys that no row of a block sees, exactly only
    if every row sees one (a row that sees none gets the reference's
    mean over all ``-1e30`` scores).  The visible span of row ``i`` is
    ``[lo_i, hi_i)`` with both ends nondecreasing in ``i``, so its
    length is smallest at the first or the last row."""
    klim = min(sk, kv_len)
    if not causal:
        return klim >= 1
    for pos in (q_offset, q_offset + sq - 1):
        lo = max(0, pos - window + 1) if window > 0 else 0
        if min(klim, pos + 1) <= lo:
            return False
    return True


def _strides(t: torch.Tensor) -> tuple[int, int, int, int]:
    """``t``'s (outer, batch, seq, head) element strides (``t`` is ``(N,
    B, S, heads, d)``), a size-1 dim's taken as if packed (it is never
    stepped, and TMA checks every stride)."""
    shape, stride = t.shape, t.stride()
    out = []
    inner = shape[4]                        # the head dim is contiguous
    for d in (3, 2, 1, 0):
        out.append(stride[d] if shape[d] > 1 else inner)
        inner = out[-1] * shape[d]
    return out[3], out[2], out[1], out[0]


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, scale: float, attn_cap: float, window: int,
                  q_offset: int = 0, kv_len: int | None = None,
                  shards: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch a kernel → ``(o (B, Sq, H, vd), lse (B, H, Sq) fp32)``.

    ``q`` is ``(B, Sq, H, hd)``, ``k`` ``(B, Sk, KV, hd)`` and ``v``
    ``(B, Sk, KV, vd)``, CUDA tensors of one dtype, ``H % KV == 0``, each
    with a contiguous last dim; or all three ``(N, B, …)``, which gives
    ``o (N, B, Sq, H, vd)`` and ``lse (N, B, H, Sq)``.  A launch of at
    most ``DECODE_ROWS`` query rows a KV group (:func:`decodes`) takes a
    decode kernel (bf16 ``flash_decode_mma_kernel``, fp32
    ``flash_decode_kernel``), its keys split by :func:`decode_plan` (fp32
    scratch for splits that do not join in a cluster is allocated here).
    Any other bf16 launch takes the
    wgmma kernel, any other fp32 one the 3xTF32 kernel; every kernel at
    ``(hd, vd)`` in ``TC_DIMS``.  bf16 is read by TMA or 16-byte copies,
    so each base is 16-byte aligned and each stride a multiple of 8
    elements; fp32 strides are free (16-byte copies where they allow,
    else 4-byte ones).  ``q_offset`` (a host
    int, at least 0) is query row 0's position and ``kv_len`` (a host
    int, at least 1; ``Sk`` by default) hides the keys at or past it.

    Without ``shards`` a mask under which some row sees no key raises.
    With ``shards`` (at least 1) the launch is partial attention over a
    sequence split across ``shards`` ranks: outer row ``n``'s keys are
    the ``(n mod shards)``-th block of ``Sk``, at the absolute positions
    ``(n mod shards)·Sk + j``, ``kv_len`` counts the whole sequence's
    valid keys, and a row that sees none of its block's keys gets ``o =
    0`` and ``lse = -inf``.  Anything else raises; nothing is copied.
    """
    global launches, tc_launches, fp32_launches, partial_launches
    global decode_launches, decode_mma_launches
    ts = (q, k, v)
    if any(t.device.type != "cuda" for t in ts):
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got "
                         f"{[str(t.device) for t in ts]}")
    if len({t.device for t in ts}) != 1:
        raise ValueError("flash_attention kernel: q, k, v on different "
                         "devices")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel: dtypes {q.dtype} "
                         f"{k.dtype} {v.dtype}; wants one of {list(DTYPES)}")
    nd = q.dim()
    if nd not in (4, 5) or k.dim() != nd or v.dim() != nd \
            or v.shape[:-1] != k.shape[:-1]:
        raise ValueError(f"flash_attention kernel wants (B, Sq, H, hd) q, "
                         f"(B, Sk, KV, hd) k and (B, Sk, KV, vd) v (or all "
                         f"with an outer (N, ...) dim); got "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    q5, k5, v5 = (t if nd == 5 else t.unsqueeze(0) for t in ts)
    n, b, sq, h, hd = q5.shape
    sk, kv, vd = k5.shape[2], k5.shape[3], v5.shape[4]
    if k5.shape[:2] != (n, b) or k5.shape[4] != hd or h % kv:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)} and "
                         f"k {tuple(k.shape)} do not match (H % KV == 0)")
    dec = decodes(h, kv, sq)
    tc = q.dtype == torch.bfloat16 and not dec
    mma = q.dtype == torch.bfloat16 and dec
    takes = dims(q.dtype, h, kv, sq)
    if (hd, vd) not in takes:
        raise ValueError(f"flash_attention kernel: (hd, vd) = {(hd, vd)} "
                         f"not in {takes} for {q.dtype}")
    if sq < 1 or sk < 1 or b < 1 or n < 1 or sq > 65535 * QT:
        raise ValueError(f"flash_attention kernel: empty or too long "
                         f"{tuple(q.shape)} {tuple(k.shape)}")
    kv_len = (sk * (shards or 1)) if kv_len is None else kv_len
    if not (isinstance(q_offset, int) and isinstance(kv_len, int)):
        raise TypeError(f"flash_attention kernel: q_offset and kv_len are "
                        f"host ints, got {type(q_offset).__name__} and "
                        f"{type(kv_len).__name__}")
    if shards is not None and (not isinstance(shards, int) or shards < 1):
        raise ValueError(f"flash_attention kernel: shards {shards!r} is not "
                         "a count of at least 1")
    if shards is not None and (q_offset < 0 or kv_len < 1):
        raise ValueError(f"flash_attention kernel: q_offset {q_offset}, "
                         f"kv_len {kv_len}")
    if shards is None and (q_offset, kv_len) != (0, sk) and (
            q_offset < 0 or kv_len < 1 or not rows_see_a_key(
                sq, sk, causal=causal, window=window, q_offset=q_offset,
                kv_len=kv_len)):
        raise ValueError(f"flash_attention kernel: q_offset {q_offset}, "
                         f"kv_len {kv_len} leave a query row of "
                         f"{tuple(q.shape)} without a key")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("flash_attention kernel: the head dim must be "
                         "contiguous")
    strides = [_strides(t) for t in (q5, k5, v5)]
    per16 = 16 // q.element_size()
    vec16 = not (any(t.data_ptr() % 16 for t in ts)
                 or any(x % per16 for st in strides for x in st))
    if q.dtype == torch.bfloat16 and not vec16:
        raise ValueError(f"flash_attention kernel: bf16 is read by TMA or "
                         f"16-byte copies, which want 16-byte aligned bases "
                         f"and strides of 8 elements; got strides {strides}")
    o = torch.empty((n, b, sq, h, vd), dtype=q.dtype, device=q.device)
    lse = torch.empty((n, b, h, sq), dtype=torch.float32, device=q.device)
    cstrides = (ctypes.c_longlong * 16)(*strides[0], *strides[1],
                                        *strides[2], *o.stride()[:4])
    opts = (float(scale), int(bool(causal)), float(attn_cap), int(window),
            q_offset, kv_len, shards or 0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if dec:
            plan = decode_plan(n, b, h, kv, sq, sk, hd, vd, q.dtype,
                               causal=causal, window=window,
                               q_offset=q_offset, kv_len=kv_len,
                               shards=shards)
            # bf16 joins up to DECODE_CLUSTER splits inside a cluster;
            # otherwise the splits' fp32 partials go to scratch: o (rows,
            # splits, vd), then (m, l) (rows, splits, 2)
            cluster = mma and decode_cluster(plan.splits, hd, vd,
                                             n * b * kv)
            parts = n * b * h * sq * plan.splits
            part = (torch.empty(parts * (vd + 2), dtype=torch.float32,
                                device=q.device)
                    if plan.splits > 1 and not cluster else None)
            ptrs = ((part.data_ptr(), part.data_ptr() + 4 * parts * vd)
                    if part is not None else (None, None))
            err = _decode_entry()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), *ptrs, DTYPES[q.dtype], hd, vd, n, b, h, kv,
                sq, sk, cstrides, *opts, *plan, int(cluster), int(vec16),
                stream)
        else:
            err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), lse.data_ptr(), DTYPES[q.dtype], hd,
                           vd, n, b, h, kv, sq, sk, cstrides, *opts,
                           int(vec16), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError "
                           f"{err} for q {tuple(q.shape)} k {tuple(k.shape)} "
                           f"v {tuple(v.shape)} {q.dtype}")
    launches += 1
    tc_launches += tc
    fp32_launches += not (tc or dec)
    decode_launches += dec
    decode_mma_launches += mma
    partial_launches += shards is not None
    if nd == 4:
        return o[0], lse[0]
    return o, lse


def _packed(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backward kernels read it (bf16 by TMA): the last dim
    contiguous, the base 16-byte aligned and each stepped stride a
    positive multiple of 16 bytes; a copy where ``t`` is not (an expanded
    or oddly strided gradient)."""
    per16 = 16 // t.element_size()
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(st > 0 and st % per16 == 0
                  for n, st in zip(t.shape[:-1], t.stride()) if n > 1))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                  causal: bool, scale: float, attn_cap: float, window: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels → ``(dq, dk, dv)`` of a training launch
    of :func:`attention_fwd` (no ``q_offset``, ``kv_len`` or ``shards``).

    ``q`` ``(B, Sq, H, hd)``, ``k`` ``(B, Sk, KV, hd)``, ``v`` ``(B, Sk,
    KV, vd)``, the forward's output ``o`` and its gradient ``do`` ``(B, Sq,
    H, vd)``, CUDA tensors of one dtype at ``(hd, vd)`` in ``TC_DIMS``;
    ``lse`` the forward's ``(B, H, Sq)`` fp32.  The gradients come back
    contiguous in that dtype, ``dk`` and ``dv`` summed over each KV head's
    query heads, all accumulated in fp32.  A tensor the kernels cannot
    read where it lies (the last dim not contiguous, a base or a stride
    off 16 bytes) is copied first; MLA's strided ``v`` is read in place.
    Anything else raises, as does a mask under which a row sees no key.
    """
    global bwd_launches, bwd_tf32_launches
    ts = (q, k, v, o, do)
    if any(t.device.type != "cuda" for t in (*ts, lse)):
        raise ValueError(f"flash_attention backward kernel needs CUDA "
                         f"tensors, got {[str(t.device) for t in ts]}")
    if len({t.device for t in (*ts, lse)}) != 1:
        raise ValueError("flash_attention backward kernel: tensors on "
                         "different devices")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in ts) \
            or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention backward kernel: dtypes "
                         f"{[t.dtype for t in ts]} lse {lse.dtype}; wants "
                         f"one of {list(DTYPES)} and fp32 lse")
    if any(t.dim() != 4 for t in ts):
        raise ValueError(f"flash_attention backward kernel wants 4-D "
                         f"tensors, got {[tuple(t.shape) for t in ts]}")
    b, sq, h, hd = q.shape
    sk, kv, vd = k.shape[1], k.shape[2], v.shape[-1]
    if (k.shape != (b, sk, kv, hd) or v.shape[:3] != (b, sk, kv) or h % kv
            or o.shape != (b, sq, h, vd) or do.shape != o.shape
            or lse.shape != (b, h, sq)):
        raise ValueError(f"flash_attention backward kernel: q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} o {tuple(o.shape)} do "
                         f"{tuple(do.shape)} lse {tuple(lse.shape)} do not "
                         f"match (H % KV == 0)")
    if (hd, vd) not in TC_DIMS:
        raise ValueError(f"flash_attention backward kernel: (hd, vd) = "
                         f"{(hd, vd)} not in {TC_DIMS}")
    if not rows_see_a_key(sq, sk, causal=causal, window=window, q_offset=0,
                          kv_len=sk):
        raise ValueError(f"flash_attention backward kernel: window "
                         f"{window} leaves a query row of {tuple(q.shape)} "
                         f"without a key of {tuple(k.shape)}")
    if sq > 65535 * 64 or sk > 65535 * 32:
        raise ValueError(f"flash_attention backward kernel: too long "
                         f"{tuple(q.shape)} {tuple(k.shape)}")
    ts = tuple(_packed(t) for t in ts)
    lse = lse.contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    dd = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 15)(*(
        st if n > 1 else 0 for t in ts
        for n, st in zip(t.shape[:3], t.stride()[:3])))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_entry()(
            *(t.data_ptr() for t in ts), lse.data_ptr(), dd.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), DTYPES[q.dtype],
            hd, vd, b, h, kv, sq, sk, strides, float(scale),
            int(bool(causal)), float(attn_cap), int(window), stream)
    if err:
        raise RuntimeError(f"flash_attention backward kernel launch failed: "
                           f"cudaError {err} for q {tuple(q.shape)} k "
                           f"{tuple(k.shape)} v {tuple(v.shape)} {q.dtype}")
    bwd_launches += 1
    bwd_tf32_launches += q.dtype == torch.float32
    return dq, dk, dv


def attention_dot(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Launch the backward's D kernel alone → ``D (B, H, Sq)`` fp32, ``D =
    Σ_d dO·O`` (``flash_bwd_dot_kernel``, which :func:`attention_bwd`
    launches first).  ``o`` and ``do`` ``(B, Sq, H, vd)``, CUDA tensors of
    one dtype, ``vd`` one of ``TC_DIMS``' value dims, read where they lie
    when the last dim is contiguous, the bases 16-byte aligned and each
    stepped stride a multiple of 16 bytes (else copied).  Its plain
    version is ``ref.flash_attention_dot``."""
    global dot_launches
    if any(t.device.type != "cuda" for t in (o, do)) or o.device != do.device:
        raise ValueError(f"flash_bwd_dot kernel needs CUDA tensors on one "
                         f"device, got {o.device} {do.device}")
    if o.dtype not in DTYPES or do.dtype != o.dtype:
        raise ValueError(f"flash_bwd_dot kernel: dtypes {o.dtype} {do.dtype};"
                         f" wants one of {list(DTYPES)}")
    if o.dim() != 4 or do.shape != o.shape or o.shape[-1] not in {
            vd for _, vd in TC_DIMS}:
        raise ValueError(f"flash_bwd_dot kernel wants (B, Sq, H, vd) o and "
                         f"do of one shape, vd in {sorted({x for _, x in TC_DIMS})}; "
                         f"got {tuple(o.shape)} {tuple(do.shape)}")
    b, sq, h, vd = o.shape
    o, do = _packed(o), _packed(do)
    dd = torch.empty((b, h, sq), dtype=torch.float32, device=o.device)
    strides = (ctypes.c_longlong * 6)(*(
        st if n > 1 else 0 for t in (o, do)
        for n, st in zip(t.shape[:3], t.stride()[:3])))
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = _dot_entry()(o.data_ptr(), do.data_ptr(), dd.data_ptr(),
                           DTYPES[o.dtype], vd, b, h, sq, strides, stream)
    if err:
        raise RuntimeError(f"flash_bwd_dot kernel launch failed: cudaError "
                           f"{err} for o {tuple(o.shape)} {o.dtype}")
    dot_launches += 1
    return dd


class FlashAttention(torch.autograd.Function):
    """Attention whose forward and backward are kernels: the backward
    recomputes the probabilities from the saved log-sum-exp
    (:func:`attention_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, attn_cap, window):
        o, lse = attention_fwd(q, k, v, causal=causal, scale=scale,
                               attn_cap=attn_cap, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = (causal, scale, attn_cap, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, attn_cap, window = ctx.opts
        dq, dk, dv = attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   scale=scale, attn_cap=attn_cap,
                                   window=window)
        return dq, dk, dv, None, None, None, None
