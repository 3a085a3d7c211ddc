"""The port on the card: the CUDA kernel against its plain version, and
the whole reduction on the GPU against the same reduction on the CPU.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance is zero throughout: the kernel adds in the plain version's
order and rounds the same way.
"""
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import tinyllama_1_1b as tl
from repro_torch.core.engine import FlareConfig, GradReducer
from repro_torch.kernels import ops
from repro_torch.kernels import tree_reduce as tr
from repro_torch.mesh import AXES, FLAT, TWO_LEVEL, RankMesh
from repro_torch.models import transformer

torch.set_num_threads(1)

_INT = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(_INT[a.element_size()]).cpu(),
                            b.view(_INT[b.element_size()]).cpu()))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "int32"])
def test_kernel_matches_plain_on_cuda(cuda, dtype):
    """Every P up to 64 (3 padded), G > 1, ragged rows (the scalar path),
    a stack strided over the rank axes, and -0.0 rows."""
    dt = getattr(torch, dtype)
    for p in (1, 2, 3, 4, 8, 64):
        for s, e in ((5, 256), (3, 100)):
            if dt == torch.int32:
                x = torch.randint(-2**31, 2**31 - 1, (3, p, s, e),
                                  generator=cuda, device="cuda", dtype=dt)
            else:
                x = torch.randn((3, p, s, e), generator=cuda,
                                device="cuda").to(dt)
                x[0, :, 0, :4] = -0.0
            got = ops.tree_reduce_slots(x)
            torch.cuda.synchronize()
            assert _same_bits(got, ops.tree_reduce_slots_plain(x)), (p, s, e)
    strided = torch.randint(-9, 9, (2, 4, 6, 256), generator=cuda,
                            device="cuda").to(dt).movedim(0, 1)
    assert _same_bits(ops.tree_reduce_slots(strided),
                      ops.tree_reduce_slots_plain(strided))


@pytest.mark.cuda
@pytest.mark.parametrize("mshape", [FLAT, TWO_LEVEL])
def test_grad_reducer_on_cuda_matches_cpu(cuda, mshape):
    """GradReducer on the GPU launches the kernel and gives the bits the
    plain fold gives on the CPU, on the SMOKE model's gradient tree."""
    params = transformer.init_params(tl.SMOKE, cuda)
    grads = tree.map_leaves(lambda p: torch.randn(
        (*mshape, *p.shape), generator=cuda, device="cuda"), params)
    red = GradReducer(FlareConfig(axes=AXES, transport="innetwork",
                                  reproducible=True), RankMesh(mshape))
    tr.launches = 0
    out, _ = red(grads)
    torch.cuda.synchronize()
    assert tr.launches == (1 if mshape == FLAT else 2)
    want, _ = red(tree.map_leaves(lambda g: g.cpu(), grads))
    for g, w in zip(tree.flatten(out)[0], tree.flatten(want)[0]):
        assert _same_bits(g.contiguous(), w.contiguous())
