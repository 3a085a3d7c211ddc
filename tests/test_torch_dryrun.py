"""The port's production-mesh dry-run against the JAX package's.

``configs.all_cells``, ``pipeline.batch_structs`` and ``launch.analytic``
equal the reference's for every cell (the port's parameter tree from
``FakeTensorMode``, the reference's from ``jax.eval_shape``);
``launch.step_analysis`` counts what ``launch.hlo_analysis`` counts on
``tests/test_hlo_and_infra.py``'s functions, the wire bytes of the
collectives what ``collectives.wire_bytes_per_rank`` models, and the
same on ``meta`` tensors as on CPU tensors; ``launch.dryrun.run_cell``
writes a train record and serve records (a prefill, a decode against a
sequence-split cache, mamba2's 500k decode) at published widths.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import collectives as jcoll
from repro.data import pipeline as jpipeline
from repro.launch import analytic as janalytic
from repro.launch import hlo_analysis
from repro.models import get_model as jget_model
from repro_torch import configs, mesh as mesh_mod
from repro_torch.core import collectives as coll
from repro_torch.data import pipeline
from repro_torch.launch import analytic, dryrun, step_analysis
from repro_torch.launch import train as launch_train
from repro_torch.mesh import RankMesh
from repro_torch.models.registry import get_model

torch.set_num_threads(1)

_DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
           jnp.float32: torch.float32}


def test_all_cells_equal_the_reference():
    got, want = configs.all_cells(), jconfigs.all_cells()
    assert len(got) == 32
    assert [(a, dataclasses.astuple(c)) for a, c in got] == \
        [(a, dataclasses.astuple(c)) for a, c in want]


def test_production_meshes():
    for multi in (False, True):
        mc = mesh_mod.mesh_cfg(multi_pod=multi)
        assert mc.world == (512 if multi else 256) and mc.tp == 16
        assert mc.rank_mesh().shape == (mesh_mod.MULTI_POD if multi
                                        else mesh_mod.SINGLE_POD)


def test_batch_structs_equal_the_reference_for_every_cell():
    for arch, cell in configs.all_cells():
        cfg = configs.load(arch).CONFIG
        got = pipeline.batch_structs(cfg, cell)
        want = jpipeline.batch_structs(jconfigs.load(arch).CONFIG, cell)
        assert sorted(got) == sorted(want), (arch, cell.name)
        for k, w in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(w.shape), (arch, k)
            assert got[k].dtype == _DTYPES[jnp.dtype(w.dtype).type], (arch, k)


@functools.cache
def _shapes(arch: str):
    """Both packages' global parameter shapes of ``arch``'s published
    config: the port's from ``FakeTensorMode``, the reference's from
    ``jax.eval_shape``."""
    got = dryrun.abstract_params(get_model(configs.load(arch).CONFIG))
    jm = jget_model(jconfigs.load(arch).CONFIG)
    return got, jax.eval_shape(jm.init, jax.random.PRNGKey(0))


def test_analytic_flops_equal_the_reference_for_every_cell():
    for arch, cell in configs.all_cells():
        got, want = _shapes(arch)
        cfg, jcfg = configs.load(arch).CONFIG, jconfigs.load(arch).CONFIG
        a, b = analytic.active_params(cfg, got), janalytic.active_params(
            jcfg, want)
        assert abs(a - b) <= 1e-12 * abs(b), (arch, a, b)
        a, b = analytic.model_flops(cfg, got, cell), janalytic.model_flops(
            jcfg, want, cell)
        assert abs(a - b) <= 1e-12 * abs(b), (arch, cell.name, a, b)


def _hlo(f, *structs, **jit):
    return hlo_analysis.analyze(jax.jit(f, **jit).lower(*structs)
                                .compile().as_text())


def test_step_analysis_counts_what_hlo_analysis_counts():
    """``tests/test_hlo_and_infra.py``'s functions, eagerly."""
    # six chained matmuls (the reference's scan)
    def f(x, ws):
        def body(x, w):
            return jnp.tanh(x @ w), None
        return jax.lax.scan(body, x, ws)[0].sum()
    want = _hlo(f, jax.ShapeDtypeStruct((128, 256), jnp.float32),
                jax.ShapeDtypeStruct((6, 256, 256), jnp.float32))

    def g(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x.sum()
    got, _ = step_analysis.analyze(g, torch.empty(128, 256, device="meta"),
                                   torch.empty(6, 256, 256, device="meta"))
    assert got.flops == want.flops == 6 * 2 * 128 * 256 * 256

    # a nested 3 × 4 loop
    def f2(x, ws):
        def outer(x, wgroup):
            return jax.lax.scan(lambda x, w: (x @ w, None), x, wgroup)[0], \
                None
        return jax.lax.scan(outer, x, ws)[0].sum()
    want = _hlo(f2, jax.ShapeDtypeStruct((64, 64), jnp.float32),
                jax.ShapeDtypeStruct((3, 4, 64, 64), jnp.float32))

    def g2(x, ws):
        for group in ws:
            for w in group:
                x = x @ w
        return x.sum()
    got, _ = step_analysis.analyze(g2, torch.randn(64, 64),
                                   torch.randn(3, 4, 64, 64))
    assert got.flops == want.flops == 12 * 2 * 64 ** 3

    # an in-place write into a slice counts the slice
    want = _hlo(lambda c, t: jax.lax.dynamic_update_slice_in_dim(c, t, 5, 0),
                jax.ShapeDtypeStruct((1024, 128), jnp.float32),
                jax.ShapeDtypeStruct((1, 128), jnp.float32),
                donate_argnums=(0,))

    def g3(cache, tok):
        cache[5:6] = tok
        return cache
    got, out = step_analysis.analyze(g3, torch.zeros(1024, 128),
                                     torch.ones(1, 128))
    assert got.bytes_written == 128 * 4 and want.bytes_written <= 4 * 128 * 4
    assert got.bytes_accessed == 2 * got.bytes_written
    assert got.peak_bytes == got.argument_bytes == (1024 + 1) * 128 * 4

    t = step_analysis.roofline_terms(989e12, 0.0, 0.0, 256)
    assert t["compute_s"] == 1.0 and t["dominant"] == "compute"


@pytest.mark.parametrize("shape", [(1, 8), (2, 4)])
@pytest.mark.parametrize("algorithm", ["ring", "rhd", "fixed_tree"])
def test_collective_wire_bytes_equal_the_reference_model(shape, algorithm):
    """Each algorithm's counted wire bytes a rank, over ``("pod",
    "data")``: the reference's ``wire_bytes_per_rank`` of the inner level
    plus that of the outer (the port reduces the whole vector at each
    level, as the reference's collectives do).  For the fixed tree that
    is the reference's two-level figure itself; its ring and rhd figures
    for two levels model a second ring as large as the first and none."""
    z = 1 << 14
    mesh = RankMesh(shape, ("pod", "data"))
    x = torch.empty(*shape, z, device="meta")
    stats, out = step_analysis.analyze(
        lambda t: coll.allreduce(t, mesh, ("pod", "data"),
                                 algorithm=algorithm), x)
    got = stats.per_rank(8).total_wire_bytes
    pod, data = shape
    want = jcoll.wire_bytes_per_rank(4 * z, data, algorithm=algorithm)
    if pod > 1:
        want += jcoll.wire_bytes_per_rank(4 * z, pod, algorithm=algorithm)
    assert got == want
    if algorithm == "fixed_tree" or pod == 1:
        assert got == jcoll.wire_bytes_per_rank(4 * z, data, pod,
                                                algorithm=algorithm)
    assert tuple(out.shape) == (*shape, z)


def test_mamba2_step_counts_the_same_on_meta_and_on_cpu():
    """The launcher's job traced on ``meta`` (``dryrun.trace_flags``)
    against the same job's step on CPU tensors: the same operations,
    bytes, collectives and peak of live bytes (mamba2 has no attention,
    so no kernel's ``meta`` branch stands in for a plain version)."""
    flags = ["--arch", "mamba2-370m", "--smoke", "--mesh", "2x2",
             "--batch", "4", "--seq", "32", "--device", "cpu"]
    run = launch_train.setup(flags)
    cpu, _ = step_analysis.analyze(run.step, run.params, run.opt,
                                   run.next_batch())
    meta, _, mc = dryrun.trace_flags(flags)
    assert mc == run.mesh
    assert cpu.flops == meta.flops > 0
    assert cpu.bytes_written == meta.bytes_written > 0
    assert cpu.counts == meta.counts and cpu.counts
    assert cpu.wire_bytes == meta.wire_bytes
    assert cpu.operand_bytes == meta.operand_bytes
    assert cpu.argument_bytes == meta.argument_bytes
    assert cpu.peak_bytes == meta.peak_bytes > cpu.argument_bytes


_RECORD_KEYS = {"arch", "shape", "kind", "mesh", "chips", "seq_len",
                "global_batch", "flare_algorithm", "gather_algorithm",
                "trace_s", "flops_per_rank", "bytes_per_rank",
                "model_flops_global", "useful_flops_ratio", "memory",
                "collectives", "roofline"}


def _reference_model_flops(arch, cell):
    jcfg = dataclasses.replace(jconfigs.load(arch).CONFIG, n_layers=2)
    return janalytic.model_flops(jcfg, jax.eval_shape(
        jget_model(jcfg).init, jax.random.PRNGKey(0)), cell)


def test_run_cell_tinyllama_at_published_widths(tmp_path):
    rec = dryrun.run_cell("tinyllama-1.1b", configs.TRAIN_4K,
                          multi_pod=False, out_dir=str(tmp_path),
                          overrides={"n_layers": 2})
    assert _RECORD_KEYS <= set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "peak_bytes"}
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    want = _reference_model_flops("tinyllama-1.1b", configs.TRAIN_4K)
    assert abs(rec["model_flops_global"] - want) <= 1e-12 * want
    assert 0.4 < rec["useful_flops_ratio"] <= 1.0
    # a launch a layer forward, and again in the remat recompute
    assert rec["collectives"]["kernels"]["flash_attention"]["launches"] == 4
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    path = tmp_path / "tinyllama_1_1b.train_4k.16x16.json"
    assert json.loads(path.read_text()) == rec


@pytest.mark.parametrize("arch,cell,multi,launches", [
    ("tinyllama-1.1b", configs.PREFILL_32K, False, 2),
    ("tinyllama-1.1b", configs.DECODE_32K, True, 2),
    ("mamba2-370m", configs.LONG_500K, False, 0)],
    ids=["tinyllama-prefill_32k", "tinyllama-decode_32k-2x16x16",
         "mamba2-long_500k"])
def test_run_cell_serve_cells_at_published_widths(tmp_path, arch, cell,
                                                  multi, launches):
    """A serve cell's record at published widths and 2 layers
    (``trace_serve``: ``make_serve_fns`` on ``meta``): the train record's
    keys, the reference's analytic ``model_flops``, and the flash
    launches counted, one a layer (at decode the partial launch over
    TinyLlama's sequence-split cache, 4 KV heads on 16 ``model`` ranks);
    mamba2 has none.  The decode's cache is an argument: a rank's block
    of TinyLlama's is 2 layers × 4 rows × 2048 positions of 4 KV heads of
    64, K and V in bf16."""
    rec = dryrun.run_cell(arch, cell, multi_pod=multi,
                          out_dir=str(tmp_path), overrides={"n_layers": 2})
    assert _RECORD_KEYS <= set(rec)
    assert rec["kind"] == cell.kind and rec["n_layers"] == 2
    assert rec["chips"] == (512 if multi else 256)
    want = _reference_model_flops(arch, cell)
    assert abs(rec["model_flops_global"] - want) <= 1e-12 * want
    kernels = rec["collectives"]["kernels"]
    assert kernels.get("flash_attention", {}).get("launches", 0) == launches
    assert rec["flops_per_rank"] > 0 and rec["bytes_per_rank"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    if cell.kind == "decode" and launches:
        assert rec["memory"]["argument_bytes"] > 2 * 2 * 4 * 2048 * 4 * 64 * 2
        assert kernels["flash_attention"]["bytes_moved"] > 0
    name = configs.ALIASES.get(arch, arch)
    path = tmp_path / f"{name}.{cell.name}.{rec['mesh']}.json"
    assert json.loads(path.read_text()) == rec


def test_flash_meta_branch_counts_the_kernel_and_refuses_its_refusals():
    q = torch.empty(2, 256, 8, 64, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(2, 256, 2, 64, dtype=torch.bfloat16, device="meta")
    from repro_torch.kernels import flash_attn as fa, ops
    st, o = step_analysis.analyze(lambda a, b, c: ops.attention(a, b, c),
                                  q, kv, kv)
    assert o.shape == q.shape and o.device.type == "meta"
    k = st.kernels["flash_attention"]
    assert k["launches"] == 1
    assert k["flops"] == st.flops == fa.flops(2, 8, 256, 256, 64,
                                              causal=True)
    assert k["bytes_moved"] == fa.bytes_moved(q, kv, kv)
    with pytest.raises(ValueError, match="flash_attention kernel"):
        ops.attention(q.float(), kv.float()[..., :48], kv.float()[..., :48])
    before = fa.launches
    ops.attention(q, kv, kv)
    assert fa.launches == before        # the card's counter never moves
    np.testing.assert_equal(st.per_rank(2).flops, st.flops / 2)
