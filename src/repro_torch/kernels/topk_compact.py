"""CUDA kernel: per-block magnitude top-k compaction (feeds §7).

The port of the Pallas kernel ``repro/kernels/topk_compact.py::
topk_compact`` (``pallas_call`` at :95), the SparCML sparsifier behind
``ops.blockwise_sparsify``: for each block of ``block`` elements (512 on
the path), the ``k`` elements of largest magnitude above the threshold of
the reference's 24-step fp32 bisection, the ones strictly above it first
and the ties at it after them, each run in index order, so the output is
not index-sorted.

The reference's step asks ``count(|x| >= mid) >= k``, which holds exactly
when the block's k-th largest magnitude ``v_k`` is ``>= mid``.
``csrc/sparse.cu`` (its head comment gives the design) runs one warp a
block with ``block / 32`` elements a lane in registers, finds ``v_k`` in
one pass (for ``k = 1`` the block's max; for ``k > 1`` a radix select
over the 31-bit magnitude patterns, per-lane byte counters in shared
memory), runs the bisection on scalars, so no step reads an element,
then compacts by warp prefix sums.  Its values are what the reference's
one-hot product gives: NaN in a block that holds a NaN or an inf
elsewhere, a selected ``-0.0`` as ``+0.0``; bitwise equal to
``ref.topk_compact`` (NaN payloads aside).

Bound by memory: ``topk_bytes``.  Built with ``nvcc`` at first launch
(``build.py``); ``ops`` pads to whole blocks and picks between kernel and
plain version by the tensor's device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build as _build

SOURCE = _build.CSRC / "sparse.cu"

#: dtype codes of the C entry point
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: block sizes the kernel is built for (32 lanes × 1..32 elements)
BLOCKS = (32, 64, 128, 256, 512, 1024)
#: the reference's bisection steps
N_ITER = 24

#: Kernel launches so far; the wrapper adds one per launch and nothing
#: else touches it but a caller that resets it.
launches = 0


@functools.cache
def _entry():
    fn = _build.load(SOURCE).topk_compact
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def topk_bytes(x: torch.Tensor, k: int, block: int) -> int:
    """Bytes one launch must move: ``x`` read once, the ``(n / block,
    k)`` values and int32 indices written once."""
    return x.numel() * x.element_size() + (
        x.numel() // block) * k * (x.element_size() + 4)


def topk_compact(x: torch.Tensor, k: int, block: int = 512
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch on a contiguous ``(n,)`` CUDA vector, ``n`` a multiple of
    ``block`` → ``(values (n / block, k)`` in ``x``'s dtype, ``local
    indices (n / block, k)`` int32, ``-1`` in empty slots)."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"topk_compact kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"topk_compact kernel: unsupported dtype {x.dtype}; "
                         f"have {list(DTYPES)}")
    if block not in BLOCKS:
        raise ValueError(f"topk_compact kernel: block={block} not in "
                         f"{BLOCKS}")
    if x.dim() != 1 or not x.is_contiguous() or x.numel() % block:
        raise ValueError(f"topk_compact kernel wants a contiguous (n,) with "
                         f"n % {block} == 0, got {tuple(x.shape)}")
    if not 1 <= k <= block:
        raise ValueError(f"topk_compact kernel: k={k} not in [1, {block}]")
    nb = x.numel() // block
    vals = torch.empty((nb, k), dtype=x.dtype, device=x.device)
    idxs = torch.empty((nb, k), dtype=torch.int32, device=x.device)
    if nb == 0:
        return vals, idxs
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry()(x.data_ptr(), vals.data_ptr(), idxs.data_ptr(),
                       DTYPES[x.dtype], block, nb, k, N_ITER, stream)
    if err:
        raise RuntimeError(f"topk_compact kernel launch failed: cudaError "
                           f"{err} for {tuple(x.shape)} {x.dtype} k={k}")
    launches += 1
    return vals, idxs
