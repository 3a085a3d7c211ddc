"""The int8 and sparse planes with one process a rank (``mesh.ProcessMesh``)
against the emulated ranks (``mesh.RankMesh``) and against the JAX package.

The ranks run on eight threads of this process with
``tests/test_torch_procs.py``'s harness (``_ranks``: a ``ProcessGroupGloo``
a group over one ``HashStore``, one torch thread, 60 s on every group and
join).  Each rank's result, error-feedback state and sparse collision
counts must be, bit for bit, its slice of what ``RankMesh`` gives on the
stacked input:

* ``switch_allreduce_int8`` on ``(2, 4)``, ``(1, 8)`` and ``(2, 3)`` in
  every design, and ``Int8Transport`` on the wire (batched and per
  bucket, two calls with the state); at the ``single`` design the
  in-network ``GradReducer`` is also the JAX reducer's under nested
  ``vmap``, bitwise, as ``tests/test_torch_int8.py`` holds the emulated
  one;
* ``switch_allreduce_sparse`` with ``with_stats`` on ``(2, 4)`` and
  ``(1, 8)``, the lists densifying before level 1, mid-tree and at the
  root, and ``SparseTransport`` on the wire: also the JAX package's at
  tolerance zero (the data hold no NaN, the exception that
  ``tests/test_torch_sparse.py`` states);
* ``GradReducer`` with ``compression="int8"`` and with ``sparse_k_frac =
  0.01``, in the network and on the wire, over two calls.

One test starts real processes: ``launch.train --ranks processes`` with
``--compression int8`` and with ``--sparse-k 0.01`` through
``procs.spawn``, every rank's losses the emulated launcher's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_procs import _nested, _own, _ranks, _same, _smoke_and_mixed

from repro.core import engine as jengine
from repro.core import transports as jtransports
from repro.switch import dataplane as jdp
from repro_torch import tree
from repro_torch.convert import params_from_jax
from repro_torch.core import transports
from repro_torch.core.engine import FlareConfig, GradReducer
from repro_torch.launch import procs
from repro_torch.launch import train as launch_train
from repro_torch.mesh import RankMesh
from repro_torch.switch import dataplane

torch.set_num_threads(1)

AXES = ("pod", "data")


def _t(a: np.ndarray) -> torch.Tensor:
    return params_from_jax(np.ascontiguousarray(a), "cpu")


def _check_slices(got: list, want: list, mshape, what: str) -> None:
    """Each rank's tensors (``got[r]``) against its slices of the
    every-rank tensors ``want``."""
    for r, leaves in enumerate(got):
        assert len(leaves) == len(want), what
        for i, (g, w) in enumerate(zip(leaves, want)):
            assert _same(g, _own(w, mshape, r)), (what, r, i)


# ---------------------------------------------------------------------------
# The int8 plane and the wire's int8 transport.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("design", ["single", "multi", "tree"])
@pytest.mark.parametrize("mshape", [(2, 4), (1, 8), (2, 3)])
def test_switch_allreduce_int8_on_ranks(mshape, design):
    rng = np.random.default_rng(sum(mshape) + len(design))
    x = _t((rng.normal(size=mshape + (2, 2000)) * 3).astype(np.float32))
    want = dataplane.switch_allreduce_int8(x, RankMesh(mshape), AXES,
                                           design=design)
    got = _ranks(mshape, lambda m: [dataplane.switch_allreduce_int8(
        m.own(x), m, AXES, design=design)])
    _check_slices(got, [want], mshape, design)


@pytest.mark.parametrize("mshape", [(2, 4), (1, 8), (2, 3)])
def test_int8_transport_on_ranks(mshape):
    """The wire's int8 protocol (``all_to_all`` and ``all_gather`` on
    the process groups), batched and per bucket, two calls with the
    error-feedback state, a ragged last bucket: results and states."""
    rng = np.random.default_rng(len(mshape) + mshape[1])
    x1, x2 = (_t(rng.normal(size=mshape + (2, 768)).astype(np.float32))
              for _ in range(2))
    extents = (768, 500)
    stagger = torch.arange(2)

    def two_calls(m, xs):
        out = []
        for batched in (True, False):
            t = transports.Int8Transport(m, AXES, batched=batched)
            r1, e1 = t(m.own(xs[0]).clone(), None, stagger, extents)
            r2, e2 = t(m.own(xs[1]).clone(), e1.clone(), stagger, extents)
            out += [r1, e1, r2, e2]
        return out
    want = two_calls(RankMesh(mshape), (x1, x2))
    got = _ranks(mshape, lambda m: two_calls(m, (x1, x2)))
    _check_slices(got, want, mshape, "Int8Transport")


def test_grad_reducer_int8_on_ranks_matches_jax_at_single_design():
    """``tests/test_torch_int8.py``'s case: 600,064 elements a bucket,
    over the §6.4 line, so every level takes the ``single`` design; two
    steps, the state carried.  Every rank's result and state are its
    slice of the JAX reducer's, bitwise."""
    mshape = (2, 4)
    rng = np.random.default_rng(11)
    shapes = {"w": (600, 1000), "b": (64,)}
    g1, g2 = ({k: rng.normal(size=mshape + v).astype(np.float32)
               for k, v in shapes.items()} for _ in range(2))
    assert dataplane.resolve_design(600_064, "auto") == ("single", 1)
    cfg = dict(axes=AXES, transport="innetwork", compression="int8")
    jred = jengine.GradReducer(jengine.FlareConfig(**cfg))
    step = _nested(lambda g, s: jred(g, s))
    r1, st1 = step(g1, jax.tree.map(jnp.zeros_like, g1))
    r2, st2 = step(g2, st1)
    want = [params_from_jax(np.asarray(a), "cpu") for a in
            jax.tree.leaves((r1, st1, r2, st2))]
    t1, t2 = params_from_jax(g1, "cpu"), params_from_jax(g2, "cpu")

    def run(m):
        red = GradReducer(FlareConfig(**cfg), m)
        p1, s1 = red(tree.map_leaves(m.own, t1))
        p2, s2 = red(tree.map_leaves(m.own, t2), s1)
        return [l for a in (p1, s1, p2, s2) for l in tree.flatten(a)[0]]
    _check_slices(_ranks(mshape, run), want, mshape, "int8 at single")


# ---------------------------------------------------------------------------
# The sparse plane and the wire's sparse transport.
# ---------------------------------------------------------------------------

B, S, K = 2, 128, 8


def _thresholds(mshape):
    """``tests/test_torch_sparse.py``'s crossover points: the lists
    densify before level 1, mid-tree (two levels) or at the root."""
    out = {"leaf": 0.01, "root": 1.1}
    if mshape[0] > 1:
        out["mid"] = (K * mshape[1] + 1) / S
    return out


SPARSE_CASES = [(m, c) for m in [(2, 4), (1, 8)] for c in _thresholds(m)]


@pytest.mark.parametrize("mshape,cross", SPARSE_CASES)
def test_switch_allreduce_sparse_on_ranks(mshape, cross):
    """Result, sent lists and collision counts (``with_stats``) bitwise
    the emulated slices and the JAX plane's."""
    thr = _thresholds(mshape)[cross]
    rng = np.random.default_rng(sum(mshape) * 5 + len(cross))
    xn = (rng.normal(size=mshape + (B, S)) * 1e2).astype(np.float32)
    xn[..., 0, :5] = 0.0                                  # ties at zero
    x, ks = _t(xn), (K, 5)

    def run(m, a):
        red, (val, idx), st = dataplane.switch_allreduce_sparse(
            a, m, AXES, ks, density_threshold=thr, with_stats=True)
        return [red, val, idx, st["collisions"], st["spill_bytes"]]
    want = run(RankMesh(mshape), x)
    if cross == "root":
        assert int(want[3].max()) > 0
    jw = _nested(lambda a: jdp.switch_allreduce_sparse(
        a, AXES, ks, density_threshold=thr, with_stats=True))(jnp.asarray(xn))
    assert _same(want[0], _t(np.asarray(jw[0])))
    for name, i in (("collisions", 3), ("spill_bytes", 4)):
        assert _same(want[i], _t(np.asarray(jw[2][name])))
    _check_slices(_ranks(mshape, lambda m: run(m, m.own(x))), want, mshape,
                  cross)


#: the wire's sparse transport: lists to the root, and lists densifying
SPARSE_WIRE = {"lists": dict(sparse_k_frac=0.1),
               "densify": dict(sparse_k_frac=0.45, density_threshold=0.5)}


@pytest.mark.parametrize("config", sorted(SPARSE_WIRE))
@pytest.mark.parametrize("mshape", [(2, 4), (1, 8)])
def test_sparse_transport_on_ranks(mshape, config):
    """``from_config`` on the wire, batched and per bucket, from a
    non-zero state (``ppermute`` staged through the host, the dense
    outer hop on the process groups): results and states bitwise the
    emulated slices and the JAX transport's."""
    rng = np.random.default_rng(21 + mshape[0])
    b, s = 4, 64
    extents = (s, s, s, 40)
    xn = rng.normal(size=mshape + (b, s)).astype(np.float32)
    en = (rng.normal(size=mshape + (b, s)) * 0.01).astype(np.float32)
    fc = dict(axes=AXES, **SPARSE_WIRE[config])

    def jf(a, e):
        out = []
        for batched in (True, False):
            t = jtransports.from_config(jengine.FlareConfig(**fc),
                                        jnp.float32, batched=batched)
            out += list(t(a, e, jnp.arange(b), extents))
        return out
    jw = _nested(jf)(xn, en)
    x, ef = _t(xn), _t(en)

    def run(m, a, e):
        out = []
        for batched in (True, False):
            t = transports.from_config(FlareConfig(**fc), m, torch.float32,
                                       batched=batched)
            assert isinstance(t, transports.SparseTransport)
            out += list(t(a.clone(), e, torch.arange(b), extents))
        return out
    want = run(RankMesh(mshape), x, ef)
    for w, j in zip(want, jw):
        assert _same(w, _t(np.asarray(j)))
    _check_slices(_ranks(mshape, lambda m: run(m, m.own(x), m.own(ef))),
                  want, mshape, config)


# ---------------------------------------------------------------------------
# GradReducer and the launcher.
# ---------------------------------------------------------------------------

LOSSY = {"int8 innetwork": dict(transport="innetwork", compression="int8"),
         "int8 wire": dict(compression="int8"),
         "sparse innetwork": dict(transport="innetwork", sparse_k_frac=0.01),
         "sparse wire": dict(sparse_k_frac=0.01)}


@pytest.mark.parametrize("config", sorted(LOSSY))
def test_grad_reducer_lossy_on_ranks(config):
    """Two calls on ``(2, 4)``, buckets of 2 KiB a dtype, the state
    carried: every rank's results and error-feedback state are its
    slices of the emulated reducer's (int32 leaves ride dense)."""
    mshape = (2, 4)
    g1, g2 = ({**_smoke_and_mixed(mshape, seed)["mixed"],
               "big": np.random.default_rng(seed).normal(
                   size=mshape + (40, 30)).astype(np.float32)}
              for seed in (7, 8))
    g1, g2 = params_from_jax(g1, "cpu"), params_from_jax(g2, "cpu")
    cfg = FlareConfig(axes=AXES, bucket_bytes=2048, **LOSSY[config])

    def run(m, own):
        red = GradReducer(cfg, m)
        p1, s1 = red(tree.map_leaves(own, g1))
        s1 = tree.map_leaves(torch.clone, s1)
        p2, s2 = red(tree.map_leaves(own, g2), s1)
        return [l for a in (p1, s1, p2, s2) for l in tree.flatten(a)[0]]
    want = run(RankMesh(mshape), lambda x: x)
    _check_slices(_ranks(mshape, lambda m: run(m, m.own)), want, mshape,
                  config)


@pytest.mark.parametrize("flag", [["--compression", "int8"],
                                  ["--sparse-k", "0.01"]])
def test_lossy_launcher_on_processes_matches_emulated_launcher(flag,
                                                               tmp_path):
    """``launch.train --ranks processes --transport innetwork`` with the
    int8 or the sparse transport in 8 processes of its own
    (``procs.spawn``): every rank's losses are the emulated
    launcher's."""
    argv = ["--smoke", "--steps", "2", "--mesh", "2x4x1", "--batch", "8",
            "--seq", "32", "--device", "cpu", "--transport", "innetwork",
            *flag]
    want = launch_train.main(argv)
    got = procs.spawn(launch_train.main, 8, "gloo",
                      str(tmp_path / "store"),
                      (argv + ["--ranks", "processes"],), timeout=120)
    assert got == [want] * 8
