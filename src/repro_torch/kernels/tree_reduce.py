"""CUDA kernel: fixed-tree reduction of stacked partials (§6.3), for Hopper.

The port of the Pallas kernels ``repro/kernels/tree_reduce.py::
tree_reduce_slots`` and ``::tree_reduce``: one kernel, written by hand in
``csrc/tree_reduce.cu``, folds a ``(G, P, S, E)`` stack over ``P`` in the
aligned binary tree, ``G`` switches in one launch.  It is bound by
memory: ``(P + 1)·G·S·E·itemsize`` bytes over the card's bandwidth.

The source is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/`` beside this file (named by the source's hash) and loaded with
``ctypes`` (``build.py``); the kernel launches on PyTorch's current
stream.  Nothing is
built or imported when this module is imported.  The plain version of
the same function is ``ref.tree_reduce``; ``ops`` picks between them by
the tensor's device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build as _build

SOURCE = _build.CSRC / "tree_reduce.cu"

#: dtype codes of the C entry point
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.int32: 3}
MAX_P = 64

#: Kernel launches so far; the wrapper adds one per launch and nothing
#: else touches it but a caller that resets it.
launches = 0
#: The same for the flat ``(P, N)`` form, ``tree_reduce``.
flat_launches = 0


@functools.cache
def _entry():
    fn = _build.load(SOURCE).tree_reduce_slots
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bytes_moved(x: torch.Tensor) -> int:
    """Bytes one launch must move: every input once, the output once."""
    g, p, s, e = x.shape
    return (p + 1) * g * s * e * x.element_size()


def _launch(x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """Check a ``(G, P, S, E)`` CUDA stack and launch the kernel on it;
    returns the output and whether a kernel ran (not for an empty one)."""
    if x.device.type != "cuda":
        raise ValueError(f"tree_reduce_slots kernel needs a CUDA tensor, "
                         f"got {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"tree_reduce_slots kernel: unsupported dtype "
                         f"{x.dtype}; have {list(DTYPES)}")
    if x.dim() != 4:
        raise ValueError(f"tree_reduce_slots kernel wants (G, P, S, E), "
                         f"got {tuple(x.shape)}")
    g, p, s, e = x.shape
    if p < 1 or p & (p - 1) or p > MAX_P:
        raise ValueError(f"tree_reduce_slots kernel: P={p} must be a power "
                         f"of two <= {MAX_P}")
    if (e > 1 and x.stride(3) != 1) or (s > 1 and x.stride(2) != e):
        raise ValueError(f"tree_reduce_slots kernel: each (S, E) block must "
                         f"be contiguous, strides {x.stride()}")
    out = torch.empty((g, s, e), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out, False
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), DTYPES[x.dtype], p, g, s * e,
                 x.stride(0), x.stride(1), stream)
    if err:
        raise RuntimeError(f"tree_reduce_slots kernel launch failed: "
                           f"cudaError {err} for {tuple(x.shape)} {x.dtype}")
    return out, True


def tree_reduce_slots(x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a ``(G, P, S, E)`` CUDA stack → ``(G, S, E)``.

    ``P`` must be a power of two up to 64 (``ops`` pads it with zero
    rows).  Floats accumulate in fp32, int32 natively.  Each ``(S, E)``
    block must be contiguous; the ``G`` and ``P`` strides are free, so
    a stack gathered along any rank axis is a view.
    """
    global launches
    out, ran = _launch(x)
    launches += ran
    return out


def tree_reduce(x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a ``(P, N)`` CUDA stack → ``(N,)``: the case
    of one group and one slot, counted in ``flat_launches``."""
    global flat_launches
    if x.dim() != 2:
        raise ValueError(f"tree_reduce kernel wants (P, N), got "
                         f"{tuple(x.shape)}")
    p, n = x.shape
    out, ran = _launch(x.reshape(1, p, 1, n))
    flat_launches += ran
    return out.reshape(n)
