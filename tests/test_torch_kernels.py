"""The port's fixed-tree fold against the JAX package's kernel, bitwise.

The same seeded numpy inputs go through ``repro.kernels.ref.tree_reduce``,
the Pallas body of ``repro.kernels.tree_reduce.tree_reduce_slots`` run in
interpret mode, and ``repro_torch.kernels.ops`` (on the CPU: its plain
PyTorch version).  Every combine is an fp32 (or native int32) add in the
same tree order, so the tolerance is zero: the bits must agree.  The
CUDA kernel itself is held against its plain version on the card in
``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import tree_reduce as jtr
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels import tree_reduce as tr

torch.set_num_threads(1)

DTYPES = ("float32", "bfloat16", "float16", "int32")
_INT = {1: np.int8, 2: np.int16, 4: np.int32}


def _bits(a) -> np.ndarray:
    """Raw bits of a JAX/numpy array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view({1: torch.int8, 2: torch.int16,
                       4: torch.int32}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view(_INT[a.dtype.itemsize])


def _stack(rng, shape, dtype) -> np.ndarray:
    """Seeded inputs in ``dtype``; row 0 holds a -0.0 in every float case."""
    if dtype == "int32":
        # near the int32 edge, so the native sums wrap around
        return rng.integers(-2**31, 2**31 - 1, size=shape, dtype=np.int32)
    x = (rng.normal(size=shape) * 1e3).astype(np.float32)
    x.reshape(-1)[:7] = -0.0
    return np.asarray(jnp.asarray(x).astype(dtype))


def _pad_pow2(x: np.ndarray) -> np.ndarray:
    p = x.shape[0]
    pp = 1 << max(0, (p - 1).bit_length())
    return np.concatenate([x, np.zeros((pp - p,) + x.shape[1:], x.dtype)])


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tree_reduce_slots_matches_jax(dtype, p):
    rng = np.random.default_rng(p * 10 + DTYPES.index(dtype))
    x = _stack(rng, (p, 8, 64), dtype)
    acc = jnp.float32 if dtype != "int32" else jnp.int32
    xp = jnp.asarray(_pad_pow2(x))
    want = _bits(jref.tree_reduce(xp, accum_dtype=acc))
    pallas = _bits(jtr.tree_reduce_slots(xp, tile_s=8, accum_dtype=acc,
                                         interpret=True))
    assert np.array_equal(pallas, want), "Pallas body != JAX oracle"

    got = ops.tree_reduce_slots(tensor_from_numpy(x, "cpu"))
    assert got.dtype == getattr(torch, dtype)
    assert np.array_equal(_bits(got), want)
    # the flat (P, N) form is the same fold with one slot
    flat = ops.tree_reduce(tensor_from_numpy(x.reshape(p, -1), "cpu"))
    assert np.array_equal(_bits(flat).reshape(8, 64), want)


def test_tree_reduce_flat_matches_pallas_2d():
    rng = np.random.default_rng(3)
    x = _stack(rng, (4, 4096), "bfloat16")
    want = _bits(jtr.tree_reduce(jnp.asarray(x), tile_n=2048,
                                 interpret=True))
    got = ops.tree_reduce(tensor_from_numpy(x, "cpu"))
    assert np.array_equal(_bits(got), want)


@pytest.mark.parametrize("p,sign", [(3, 0), (4, 1)])
def test_negative_zero_pads_in_tree_position(p, sign):
    """A stack of -0.0 keeps its sign only when no zero row is padded in:
    the pad is a real +0.0 added in tree position (-0.0 + 0.0 = +0.0)."""
    x = np.full((p, 1, 16), -0.0, np.float32)
    got = ops.tree_reduce_slots(tensor_from_numpy(x, "cpu"))
    assert (np.signbit(got.numpy()) == bool(sign)).all()
    want = jops.tree_reduce_slots(jnp.asarray(x))
    assert np.array_equal(_bits(got), _bits(want))


def test_grouped_strided_stack_folds_per_group():
    """G switches fold at once from a strided view of the rank axes (a
    stack gathered along a non-leading axis), as G separate folds."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 4, 6, 32)).astype(np.float32))
    stack = x.movedim(0, 1)                        # (G=4, P=2, S, E) view
    got = ops.tree_reduce_slots(stack)
    for g in range(4):
        assert torch.equal(got[g], ref.tree_reduce(stack[g]))


def test_kernel_wrapper_refuses_cpu_tensors():
    """On the CPU the wrapper's plain version runs only through ``ops``;
    the kernel entry itself launches or raises, never falls back."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        tr.tree_reduce_slots(torch.zeros(1, 2, 1, 4))
    assert tr.bytes_moved(torch.zeros(3, 4, 5, 8)) == 5 * 3 * 5 * 8 * 4
