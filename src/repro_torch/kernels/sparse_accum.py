"""CUDA kernel: sparse (index, value) accumulate into dense buffers (§7).

The port of the Pallas kernels ``repro/kernels/sparse_accum.py::
sparse_accum_slots`` and ``::sparse_accum``: the paper's array storage,
where the root switch adds incoming coordinate lists into a dense
buffer.  ``csrc/sparse.cu`` (its head comment gives the design) takes
``(G, B, E)`` int32 indices and values (f32, bf16 or f16) to ``(G, B,
size)`` fp32: zeros plus every entry whose index lies in ``[0, size)``,
duplicates added.  The flat form is its one-row reshape.

Two modes:

* ``indices_sorted=True`` — every list ascending as unsigned integers
  (valid indices ascending, then a ``-1`` tail), as the sparse data
  plane's lists are.  One block a tile of outputs adds each run of equal
  indices in list order and writes the tile once: bitwise equal to the
  plain version (``ref.sparse_accum_slots``), every run.  The caller
  vouches for the order; it is not checked.
* ``indices_sorted=False`` — any list: a zero fill, then one thread an
  entry adding with IEEE round-to-nearest in the hardware's order.
  Bitwise equal to the plain version where no index appears more than
  twice;
  with three or more duplicates the sum's order differs, within the
  reference's own tolerance for the kernel (``rtol = atol = 1e-5``,
  ``tests/test_kernels.py``).

Bound by memory: ``sparse_accum_bytes``.  Built with ``nvcc`` at first
launch (``build.py``) and launched on PyTorch's current stream; ``ops``
picks between kernel and plain version by the tensor's device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build as _build

SOURCE = _build.CSRC / "sparse.cu"

#: dtype codes of the C entry points
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: Kernel launches so far, by wrapper; each wrapper adds one per launch
#: and nothing else touches them but a caller that resets them.
launches = {"sparse_accum_slots": 0, "sparse_accum": 0}

_P, _L = ctypes.c_void_p, ctypes.c_longlong


@functools.cache
def _entry():
    fn = _build.load(SOURCE).sparse_accum_slots
    fn.argtypes = [_P, _P, _P, ctypes.c_int, _L, _L, _L, _L, _L, _L, _L, _L,
                   ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    return fn


def sparse_accum_bytes(idx: torch.Tensor, val: torch.Tensor,
                       size: int) -> int:
    """Bytes one launch must move: each entry that lands in ``[0, size)``
    read once (index and value), each output written once."""
    rows = idx.numel() // max(1, idx.shape[-1])
    kept = int(((idx >= 0) & (idx < size)).sum())
    return kept * (4 + val.element_size()) + 4 * rows * size


def _launch(idx: torch.Tensor, val: torch.Tensor, size: int,
            indices_sorted: bool, name: str) -> torch.Tensor:
    for t in (idx, val):
        if t.device.type != "cuda":
            raise ValueError(f"{name} kernel needs CUDA tensors, got "
                             f"{t.device}")
    if idx.dtype != torch.int32 or val.dtype not in DTYPES:
        raise ValueError(f"{name} kernel wants int32 indices and values in "
                         f"{list(DTYPES)}, got {idx.dtype} and {val.dtype}")
    if idx.dim() != 3 or val.shape != idx.shape:
        raise ValueError(f"{name} kernel wants (G, B, E) indices and values, "
                         f"got {tuple(idx.shape)} and {tuple(val.shape)}")
    if not 1 <= size < 2**31:
        raise ValueError(f"{name} kernel: size={size} out of range")
    g, b, e = idx.shape
    for t in (idx, val):
        if e > 1 and t.stride(2) != 1:
            raise ValueError(f"{name} kernel: each list must be contiguous, "
                             f"strides {t.stride()}")
    out = torch.empty((g, b, size), dtype=torch.float32, device=idx.device)
    if g * b == 0:
        return out
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        err = _entry()(idx.data_ptr(), val.data_ptr(), out.data_ptr(),
                       DTYPES[val.dtype], g, b, e, size, idx.stride(0),
                       idx.stride(1), val.stride(0), val.stride(1),
                       int(indices_sorted), stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} "
                           f"for {tuple(idx.shape)} {val.dtype} size={size}")
    launches[name] += 1
    return out


def sparse_accum_slots(idx: torch.Tensor, val: torch.Tensor, size: int,
                       indices_sorted: bool = False) -> torch.Tensor:
    """Launch on ``(G, B, E)`` CUDA lists → ``(G, B, size)`` fp32.  Each
    list must be contiguous; the G and B strides are free, so the lists
    of a level's switches are read where they lie."""
    return _launch(idx, val, size, indices_sorted, "sparse_accum_slots")


def sparse_accum(idx: torch.Tensor, val: torch.Tensor,
                 size: int) -> torch.Tensor:
    """Launch on one ``(E,)`` CUDA list, in any order → ``(size,)``
    fp32: the slot kernel's unsorted mode on the reshape ``(1, 1, E)``."""
    if idx.dim() != 1:
        raise ValueError(f"sparse_accum kernel wants (E,), got "
                         f"{tuple(idx.shape)}")
    return _launch(idx.reshape(1, 1, -1), val.reshape(1, 1, -1), size,
                   False, "sparse_accum").reshape(size)
