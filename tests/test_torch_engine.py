"""The port's GradReducer against the JAX package's, bitwise.

The same per-rank gradients (seeded numpy, the ``tinyllama_1_1b.SMOKE``
parameter tree and a mixed f32/bf16/int32 tree) are reduced by the JAX
``GradReducer`` under nested ``jax.vmap`` over ``("pod", "data")`` and by
the port's ``GradReducer`` on the rank-axis layout, carried across by
``convert.params_from_jax``.  Reproducible mode promises exact bits, so
the tolerance is zero.
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tinyllama_1_1b as jtl
from repro.core import engine as jengine
from repro.models import transformer as jtransformer
from repro_torch import tree
from repro_torch.configs import tinyllama_1_1b as tl
from repro_torch.convert import params_from_jax
from repro_torch.core.engine import FlareConfig, GradReducer
from repro_torch.mesh import RankMesh
from repro_torch.models import transformer

torch.set_num_threads(1)

AXES = ("pod", "data")
_INT = {1: np.int8, 2: np.int16, 4: np.int32}

CONFIGS = {
    "innetwork": dict(axes=AXES, transport="innetwork", reproducible=True),
    "wire_fixed_tree": dict(axes=AXES, algorithm="fixed_tree",
                            reproducible=True),
}


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view({1: torch.int8, 2: torch.int16,
                       4: torch.int32}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view(_INT[a.dtype.itemsize])


def _reduce_both(grads_np, mshape, config):
    jred = jengine.GradReducer(jengine.FlareConfig(**config))
    want = jax.jit(jax.vmap(jax.vmap(lambda g: jred(g)[0], axis_name="data"),
                            axis_name="pod"))(grads_np)
    red = GradReducer(FlareConfig(**config), RankMesh(mshape))
    got, state = red(params_from_jax(grads_np, "cpu"))
    assert state is None
    return jax.tree.leaves(want), tree.flatten(got)[0]


def _smoke_grads(mshape, seed):
    shapes = jax.eval_shape(lambda: jtransformer.init_params(
        jtl.SMOKE, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.normal(size=mshape + s.shape).astype(
        np.float32), shapes)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("mshape", [(1, 8), (2, 4)])
def test_grad_reducer_matches_jax_on_tinyllama_smoke(mshape, config):
    grads = _smoke_grads(mshape, seed=len(config))
    want, got = _reduce_both(grads, mshape, CONFIGS[config])
    assert len(want) == len(got) == len(jax.tree.leaves(grads))
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        assert np.array_equal(_bits(g), _bits(w))
    # every rank holds the same bits, within a tree's rounding of the sum
    for g, x in zip(got, jax.tree.leaves(grads)):
        exact = x.astype(np.float64).sum((0, 1))
        bound = 3 * 2.0**-24 * np.abs(x).astype(np.float64).sum((0, 1))
        last = g.numpy()[mshape[0] - 1, mshape[1] - 1]
        assert (np.abs(last - exact) <= bound).all()


def test_grad_reducer_matches_jax_on_mixed_dtypes():
    rng = np.random.default_rng(1)
    mshape = (2, 4)
    grads = {
        "w": rng.normal(size=mshape + (5, 7)).astype(np.float32),
        "b": np.asarray(jnp.asarray(rng.normal(size=mshape + (33,)),
                                    jnp.bfloat16)),
        "count": rng.integers(-1000, 1000, size=mshape + (3,),
                              dtype=np.int32),
        "scale": rng.normal(size=mshape).astype(np.float32),
    }
    want, got = _reduce_both(grads, mshape, CONFIGS["innetwork"])
    for w, g in zip(want, got):
        assert g.dtype == getattr(torch, w.dtype.name)
        assert np.array_equal(_bits(g), _bits(w))


def test_model_tree_matches_jax_leaves():
    """The port's dense parameter tree has the JAX model's leaves, in the
    same order, so a gradient tree packs into the same arena."""
    jshapes = jax.eval_shape(lambda: jtransformer.init_params(
        jtl.SMOKE, jax.random.PRNGKey(0)))
    params = transformer.init_params(tl.SMOKE,
                                     torch.Generator().manual_seed(0))
    assert [tuple(p.shape) for p in tree.flatten(params)[0]] == \
        [s.shape for s in jax.tree.leaves(jshapes)]
    assert tl.CONFIG.d_model == jtl.CONFIG.d_model == 2048


BAD_CONFIGS = [
    dict(transport="bogus"),
    dict(fault_plan=object()),
    dict(transport="innetwork", algorithm="ring"),
    dict(transport="innetwork", hierarchical=False),
    dict(reproducible=True, compression="int8"),
    dict(reproducible=True, sparse_k_frac=0.1),
    dict(compression="fp8"),
    dict(hierarchical=True),
    dict(axes=AXES, hierarchical=True, algorithm="ring"),
    dict(axes=AXES, hierarchical=False, algorithm="hierarchical"),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS)
def test_flare_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as mine:
        FlareConfig(**kw)
    with pytest.raises(ValueError) as ref:
        jengine.FlareConfig(**kw)
    assert str(mine.value) == str(ref.value)


def test_unported_paths_raise_naming_their_roadmap_item():
    mesh = RankMesh((2, 4))
    grads = {"w": torch.zeros(2, 4, 8)}
    # the per-bucket path, the hierarchical schedule that auto picks on
    # the (2, 4) mesh and the wire int8 transport are ported: they give
    # the reference's bits
    rng = np.random.default_rng(9)
    jgrads = {"w": rng.normal(size=(2, 4, 8)).astype(np.float32)}
    for kw in (dict(arena=False), dict(reproducible=True),
               dict(compression="int8")):
        jred = jengine.GradReducer(jengine.FlareConfig(axes=AXES, **kw))
        want = jax.jit(jax.vmap(jax.vmap(lambda g: jred(g)[0],
                                         axis_name="data"),
                                axis_name="pod"))(jgrads)
        got, _ = GradReducer(FlareConfig(axes=AXES, **kw), mesh)(
            params_from_jax(jgrads, "cpu"))
        assert np.array_equal(_bits(got["w"]), _bits(want["w"])), kw
    # the lossy fabric is ported: a plan gives the reference's bits
    from repro.switch import packets as jpk
    from repro_torch.switch import packets as pk
    plan = dict(seed=1, drop=0.05, duplicate=0.3, reorder=0.5, corrupt=0.02,
                retry=(8,))
    kw = dict(transport="innetwork", reproducible=True)
    jred = jengine.GradReducer(jengine.FlareConfig(
        axes=AXES, fault_plan=jpk.FaultPlan(**dict(
            plan, retry=jpk.RetryPolicy(*plan["retry"]))), **kw))
    want = jax.jit(jax.vmap(jax.vmap(lambda g: jred(g)[0], axis_name="data"),
                            axis_name="pod"))(jgrads)
    got, _ = GradReducer(FlareConfig(axes=AXES, fault_plan=pk.FaultPlan(
        **dict(plan, retry=pk.RetryPolicy(*plan["retry"]))), **kw), mesh)(
        params_from_jax(jgrads, "cpu"))
    assert np.array_equal(_bits(got["w"]), _bits(want["w"]))
    # telemetry is ported: a reducer with a flight recorder gives the
    # bits of the one without, and records the switch's counters once
    from repro_torch.obs import Telemetry
    tm = Telemetry.create()
    wired = GradReducer(FlareConfig(axes=AXES, telemetry=tm, fault_plan=(
        pk.FaultPlan(**dict(plan, retry=pk.RetryPolicy(*plan["retry"])))),
        **kw), mesh)
    counts = []
    for _ in range(2):
        again, _ = wired(params_from_jax(jgrads, "cpu"))
        assert np.array_equal(_bits(again["w"]), _bits(got["w"]))
        counts.append(tm.metrics_json())
    assert counts[0] == counts[1]
    assert tm.registry.value("switch.solo.l1.ingress_packets") > 0
    with pytest.raises(ValueError, match="mesh shape"):
        GradReducer(FlareConfig(axes=AXES), mesh)({"w": torch.zeros(8, 8)})


def test_results_are_freed_without_the_cyclic_collector():
    """Dropping a reduction's result frees it at once: a reference cycle
    inside the port would hold device memory until the cyclic garbage
    collector happened to run."""
    red = GradReducer(FlareConfig(axes=AXES, transport="innetwork",
                                  reproducible=True), RankMesh((2, 4)))
    grads = {"a": torch.ones(2, 4, 8), "b": [torch.ones(2, 4, 3), None]}
    gc.disable()
    try:
        out, _ = red(grads)
        refs = [weakref.ref(t) for t in tree.flatten(out)[0]]
        del out
        assert refs and all(r() is None for r in refs)
    finally:
        gc.enable()


def test_in_network_ranks_share_one_reduced_copy():
    """The in-network result is one copy broadcast over the rank axes
    (stride 0), so an in-place update raises rather than writing through
    to every rank; the wire transport gives each rank its own tensor."""
    rng = np.random.default_rng(4)
    grads = {"w": torch.from_numpy(rng.normal(size=(2, 4, 5, 7))
                                   .astype(np.float32))}
    mesh = RankMesh((2, 4))
    shared, _ = GradReducer(FlareConfig(**CONFIGS["innetwork"]), mesh)(grads)
    w = shared["w"]
    assert w.stride()[:2] == (0, 0)
    with pytest.raises(RuntimeError, match="single memory location"):
        w.add_(1.0)
    w = w + 1.0                                     # out of place is fine
    assert w.stride()[:2] != (0, 0)
    own, _ = GradReducer(FlareConfig(**CONFIGS["wire_fixed_tree"]),
                         mesh)(grads)
    before = own["w"][1, 3].clone()
    own["w"][0, 0].add_(1.0)
    assert torch.equal(own["w"][1, 3], before)
