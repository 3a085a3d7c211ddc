"""CUDA kernel: fixed-tree reduction of stacked partials (§6.3), for Hopper.

The port of the Pallas kernels ``repro/kernels/tree_reduce.py::
tree_reduce_slots`` and ``::tree_reduce``: one kernel, written by hand in
``csrc/tree_reduce.cu``, folds a ``(G, P, S, E)`` stack over ``P`` in the
aligned binary tree, ``G`` switches in one launch.  It is bound by
memory: ``(P + 1)·G·S·E·itemsize`` bytes over the card's bandwidth.

The source is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/`` beside this file (named by the source's hash) and loaded with
``ctypes``; the kernel launches on PyTorch's current stream.  Nothing is
built or imported when this module is imported.  The plain version of
the same function is ``ref.tree_reduce``; ``ops`` picks between them by
the tensor's device.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SOURCE = Path(__file__).with_name("csrc") / "tree_reduce.cu"
BUILD_DIR = Path(__file__).with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: dtype codes of the C entry point
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.int32: 3}
MAX_P = 64

#: Kernel launches so far; the wrapper adds one per launch and nothing
#: else touches it but a caller that resets it.
launches = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the tree_reduce kernel")
    return found


def build() -> Path:
    """Compile the kernel if this source has not been built yet.

    The compiler's output (``-Xptxas -v``: registers, spills) is kept
    beside the library as ``.log``.  The library is written under a
    temporary name and renamed, so processes building at once are safe.
    """
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libtree_reduce_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    r = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if r.returncode:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}"
                           f"\n{r.stdout}\n{r.stderr}")
    lib.with_suffix(".log").write_text(r.stdout + r.stderr)
    os.replace(tmp, lib)
    return lib


@functools.cache
def _entry():
    fn = ctypes.CDLL(str(build())).tree_reduce_slots
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bytes_moved(x: torch.Tensor) -> int:
    """Bytes one launch must move: every input once, the output once."""
    g, p, s, e = x.shape
    return (p + 1) * g * s * e * x.element_size()


def tree_reduce_slots(x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a ``(G, P, S, E)`` CUDA stack → ``(G, S, E)``.

    ``P`` must be a power of two up to 64 (``ops`` pads it with zero
    rows).  Floats accumulate in fp32, int32 natively.  Each ``(S, E)``
    block must be contiguous; the ``G`` and ``P`` strides are free, so
    a stack gathered along any rank axis is a view.
    """
    global launches
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
        return out
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), DTYPES[x.dtype], p, g, s * e,
                 x.stride(0), x.stride(1), stream)
    if err:
        raise RuntimeError(f"tree_reduce_slots kernel launch failed: "
                           f"cudaError {err} for {tuple(x.shape)} {x.dtype}")
    launches += 1
    return out
