"""The kernel builder's library names (``repro_torch.kernels.build``).

A library is named by the hash of its source and of the headers the
source includes with quotes, followed recursively, so that an edited
header is rebuilt rather than a stale library loaded.  Nothing here
compiles: the names are computed from the files' bytes.
"""
from pathlib import Path

import pytest

from repro_torch.kernels import build


def _tree(tmp_path: Path) -> tuple[Path, Path, Path]:
    """A source that includes a header that includes another, beside a
    system include the builder must not follow."""
    inner = tmp_path / "inner.cuh"
    inner.write_text("#pragma once\nconstexpr int K = 1;\n")
    (tmp_path / "sub").mkdir()
    outer = tmp_path / "sub" / "outer.cuh"
    outer.write_text('#pragma once\n#include "../inner.cuh"\n')
    src = tmp_path / "kernel.cu"
    src.write_text('#include <cuda_runtime.h>\n  #  include "sub/outer.cuh"\n'
                   'int f() { return K; }\n')
    return src, outer, inner


def test_inputs_follow_quoted_includes(tmp_path):
    """The source first, then each quoted header once, resolved beside
    the file that names it; angle-bracket includes are not followed."""
    src, outer, inner = _tree(tmp_path)
    (tmp_path / "again.cu").write_text('#include "inner.cuh"\n'
                                       '#include "inner.cuh"\n')
    assert build.inputs(src) == [src, outer, inner]
    assert build.inputs(tmp_path / "again.cu") == [tmp_path / "again.cu",
                                                   inner]


@pytest.mark.parametrize("which", ["source", "header", "nested header"])
def test_library_name_changes_with_any_input(tmp_path, which):
    """Changing one byte of the source, of its header or of the header's
    header gives the library another name; the same bytes the same."""
    src, outer, inner = _tree(tmp_path)
    before = build.library(src)
    assert before == build.library(src)
    assert before.name.startswith("libkernel_") and before.suffix == ".so"
    path = {"source": src, "header": outer, "nested header": inner}[which]
    path.write_text(path.read_text() + "\n")
    assert build.library(src) != before


def test_library_of_a_source_without_headers_is_its_own_hash(tmp_path):
    """A source that includes no header keeps the name it had before
    headers counted: the hash of its own bytes."""
    import hashlib
    src = tmp_path / "plain.cu"
    src.write_text("#include <stdint.h>\nint f() { return 0; }\n")
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    assert build.library(src).name == f"libplain_{tag}.so"


def test_flash_sources_count_the_shared_header():
    """Both flash sources include the Hopper helpers' header, so an edit
    there renames both libraries; the other sources include none."""
    for name in ("flash_attn.cu", "flash_bwd.cu"):
        names = [p.name for p in build.inputs(build.CSRC / name)]
        assert names == [name, "hopper.cuh"], names
    for name in ("tree_reduce.cu", "quant.cu", "sparse.cu"):
        assert build.inputs(build.CSRC / name) == [build.CSRC / name]
