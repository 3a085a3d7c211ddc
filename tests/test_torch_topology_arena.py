"""The port's mesh, reduction trees and flat arena against the JAX package.

Trees and mesh levels must be equal field for field; the arena plan must
be the same plan, and pack/unpack bitwise equal to JAX's for f32, bf16,
f16 and int32.  The rank-mesh collectives are held against JAX's under
nested ``jax.vmap`` with named axes (one program per emulated rank).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core import arena as jarena
from repro.core import topology as jtopo
from repro_torch import tree
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import arena, topology
from repro_torch.mesh import RankMesh

torch.set_num_threads(1)

_INT = {1: np.int8, 2: np.int16, 4: np.int32}


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view({1: torch.int8, 2: torch.int16,
                       4: torch.int32}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view(_INT[a.dtype.itemsize])


def _nested(f):
    """Run a per-rank JAX function over a ``(pod, data)`` leading layout."""
    return jax.jit(jax.vmap(jax.vmap(f, axis_name="data"), axis_name="pod"))


@pytest.mark.parametrize("sizes", [(8,), (1, 8), (2, 4), (4, 2), (2, 2, 2),
                                   (1, 1)])
def test_mesh_tree_and_levels_match_jax(sizes):
    names = ("x", "pod", "data")[-len(sizes):]
    mine, ref = topology.build_mesh_tree(sizes), jtopo.build_mesh_tree(sizes)
    assert dataclasses.astuple(mine) == dataclasses.astuple(ref)
    assert (mine.depth, mine.leaf_fanin) == (ref.depth, ref.leaf_fanin)
    levels = topology.mesh_levels(names, sizes)
    assert [dataclasses.astuple(l) for l in levels] == \
        [dataclasses.astuple(l) for l in jtopo.mesh_levels(names, sizes)]
    assert topology.transport_schedule(mine) == jtopo.transport_schedule(ref)


def _leaves(rng, lead, dtype_names):
    """Ragged per-rank leaves (scalars included) with leading rank axes."""
    out = []
    for i, dt in enumerate(dtype_names):
        shape = tuple(int(s) for s in rng.integers(1, 9, size=i % 4))
        x = rng.normal(size=lead + shape) * 100
        if dt == "int32":
            out.append(x.astype(np.int32))
        else:
            x = jnp.asarray(x.astype(np.float32)).astype(dt)
            out.append(np.asarray(x))
    return out


@pytest.mark.parametrize("pad_multiple", [1, 16])
@pytest.mark.parametrize("bucket_bytes", [64, 1 << 20])
def test_arena_plan_pack_unpack_bitwise(bucket_bytes, pad_multiple):
    rng = np.random.default_rng(bucket_bytes + pad_multiple)
    kinds = ["float32", "bfloat16", "float16", "int32"] * 3
    lead = (2, 4)
    np_leaves = _leaves(rng, lead, kinds)
    j_plan = jarena.build_plan([jax.ShapeDtypeStruct(l.shape[2:], l.dtype)
                                for l in np_leaves], bucket_bytes,
                               pad_multiple=pad_multiple)
    t_leaves = [tensor_from_numpy(l, "cpu") for l in np_leaves]
    plan = arena.build_plan(t_leaves, bucket_bytes, pad_multiple=pad_multiple,
                            lead_dims=2)
    assert len(plan.groups) == len(j_plan.groups) == 4
    for g, jg in zip(plan.groups, j_plan.groups):
        assert arena.dtype_name(g.dtype) == jnp.dtype(jg.dtype).name
        assert (g.num_buckets, g.bucket_elems, g.stagger_base) == \
            (jg.num_buckets, jg.bucket_elems, jg.stagger_base)
        assert [dataclasses.astuple(s) for s in g.slots] == \
            [dataclasses.astuple(s) for s in jg.slots]
        assert g.valid_extents == jg.valid_extents
        assert g.staggers().tolist() == np.asarray(jg.staggers()).tolist()

    # every rank's arena equals JAX's pack of that rank's leaves
    j_arenas = _nested(lambda ls: j_plan.pack(ls))(
        [jnp.asarray(l) for l in np_leaves])
    arenas = plan.pack(t_leaves)
    for a, ja in zip(arenas, j_arenas):
        assert a.shape == lead + tuple(ja.shape[2:])
        assert np.array_equal(_bits(a), _bits(ja))
    for out, src in zip(plan.unpack(arenas), np_leaves):
        assert np.array_equal(_bits(out), _bits(src))


def test_tree_flatten_orders_dict_keys_like_jax():
    t = {"b": [np.ones(1), {"z": np.ones(2), "a": np.ones(3)}],
         "a": (np.ones(4), None)}
    leaves, spec = tree.flatten(t)
    assert [l.size for l in leaves] == \
        [l.size for l in jax.tree.leaves(t)] == [4, 1, 3, 2]
    back = tree.unflatten(spec, leaves)
    assert back["a"][1] is None and back["b"][1]["z"].size == 2


@pytest.mark.parametrize("shape", [(1, 8), (2, 4)])
def test_rank_mesh_collectives_match_jax(shape):
    mesh = RankMesh(shape)
    rng = np.random.default_rng(11)
    x = rng.integers(-1000, 1000, size=shape + (3, 5)).astype(np.int32)
    t = torch.from_numpy(x)
    for axis in ("pod", "data"):
        p = mesh.axis_size(axis)
        perm = [(i, (i + 1) % p) for i in range(p)]

        def f(v, axis=axis, perm=perm):
            return (lax.all_gather(v, axis), lax.psum(v, axis),
                    lax.ppermute(v, axis, perm),
                    lax.axis_index(axis) + jnp.zeros((), jnp.int32))

        gat, ps, pp, idx = _nested(f)(x)
        assert np.array_equal(mesh.all_gather(t, axis).numpy(), gat)
        assert np.array_equal(mesh.psum(t, axis).numpy(), ps)
        assert np.array_equal(mesh.ppermute(t, axis, perm).numpy(), pp)
        assert np.array_equal(
            mesh.axis_index(axis).broadcast_to(shape).numpy(), idx)
        # a partial permutation leaves the ranks that receive nothing at 0
        part = mesh.ppermute(t, axis, [(0, p - 1)]).movedim(mesh.dim(axis), 0)
        assert torch.equal(part[p - 1], t.movedim(mesh.dim(axis), 0)[0])
        assert not part[:p - 1].any()
    assert mesh.world_size() == 8
    with pytest.raises(ValueError, match="mesh shape"):
        mesh.psum(torch.zeros(8, 3), "data")
