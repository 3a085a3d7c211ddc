"""Build this package's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` is compiled for ``sm_90a`` into a shared
library with a plain C interface, ``build/lib<stem>_<hash>.so`` beside
this file, named by the hash of the source and of the headers it
includes (``#include "..."``, followed recursively), so that an edited
source or header is rebuilt.  The compiler's output (``-Xptxas -v``: registers, spills) is
kept beside the library as ``.log``.  Nothing is built when a module is
imported: the kernel wrappers build at their first launch, and
``build`` compiles several sources at once, one ``nvcc`` each.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


#: a quoted include, resolved beside the file that names it
_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def inputs(source: Path) -> list[Path]:
    """``source`` and the headers it includes with quotes (resolved
    beside the file that names them), followed recursively, each once, in
    the order first met."""
    seen: list[Path] = []
    todo = [source]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [Path(os.path.normpath(path.parent / name))
                 for name in _INCLUDE.findall(
                     path.read_text(encoding="utf-8"))]
    return seen


def library(source: Path) -> Path:
    """Where ``source``'s library lives once built: named by the hash of
    the source's bytes and its headers' (a source without headers keeps
    the hash of its own bytes alone)."""
    digest = hashlib.sha256()
    for path in inputs(source):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def build(*sources: Path) -> list[Path]:
    """Compile every source not built yet, all at once; return the
    libraries in the order given.

    Each library is written under a temporary name and renamed, so
    processes building at once are safe.
    """
    libs = [library(s) for s in sources]
    jobs = []
    for src, lib in zip(sources, libs):
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((cmd, tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for cmd, tmp, lib, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


@functools.cache
def load(source: Path) -> ctypes.CDLL:
    """The built library of ``source``, loaded (built first if needed)."""
    return ctypes.CDLL(str(build(source)[0]))
