#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

1. Builds the ``tree_reduce`` CUDA kernel from ``src/repro_torch/kernels/
   csrc`` (``nvcc``, ``sm_90a``) and holds it against its plain PyTorch
   version on the card, bitwise: f32, bf16, f16 and int32; P = 1, 2, 3
   (padded), 4, 8 and 64; G > 1; a ragged row length (the scalar path);
   a strided stack; rows holding -0.0.
2. Reduces the gradient tree of TinyLlama-1.1B at its published widths
   (depth cut to ``LAYERS``; fp32; random per-rank gradients from a
   seeded ``torch.Generator`` on the card) over 8 emulated ranks on the
   ``(2, 4)`` mesh through ``GradReducer(FlareConfig(axes=("pod",
   "data"), transport="innetwork", reproducible=True))``: arena → switch
   data plane → fixed-tree fold kernel on every tree level.  The launch
   counter is set to 0 just before and read just after.  The result must
   be bitwise equal to the same reduction with the plain fold and to the
   wire ``fixed_tree`` transport, and within a tree's rounding of an fp64
   sum.  Then the flat ``(1, 8)`` mesh, the same way.
3. Times the whole reduction (median of a few runs), and the kernel, its
   plain version and ``torch.sum`` at the shapes the main path gave the
   kernel, beside the kernel's memory bound.

Prints the card's name and power limit (``nvidia-smi``), one JSON line
of kernel figures, and as its last line ``{"ok": true, "device": ...}``.
Exits non-zero without a result when no GPU is present or any check
fails; there is no fallback.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM HBM3 bandwidth (NVIDIA data sheet), the kernel's bound
HBM_BYTES_PER_S = 3.35e12
REPLACES = "src/repro/kernels/tree_reduce.py:101"
#: TinyLlama depth, cut from the published 22: the reduction's peak is
#: several times the 8 ranks' gradient bytes, and 22 layers of fp32
#: gradients for 8 ranks alone are 35 GB of the card's 80
LAYERS = 4
SOURCE = "src/repro_torch/kernels/csrc/tree_reduce.cu"
#: the informative part of a templated kernel name in a profile
KERNEL_NAME = re.compile(r"tree_reduce_kernel<[^>]*>|CatArrayBatchedCopy\w*|"
                         r"\w+_kernel_cuda|\w+Functor(<\w+>)?")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def same_bits(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    return torch.equal(a.view(ints[a.element_size()]),
                       b.view(ints[b.element_size()]))


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events around ``iters``."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build(tr) -> None:
    t0 = time.perf_counter()
    lib = tr.build()
    log = lib.with_suffix(".log").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s; "
          f"{len(regs)} kernels, registers max {max(regs)}, "
          f"spill stores max {max(spills, default=0)} bytes")


def phase_kernel_vs_plain(torch, ops) -> None:
    """Bitwise kernel vs plain version over dtypes, P, G, layouts."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.int32):
        for p in (1, 2, 3, 4, 8, 64):
            for s, e in ((5, 256), (3, 100)):
                shape = (3, p, s, e)
                if dtype == torch.int32:
                    x = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                                      device="cuda", dtype=dtype)
                else:
                    x = (torch.randn(shape, generator=gen, device="cuda")
                         * 100).to(dtype)
                    x[0, :, 0, :8] = -0.0       # a row of -0.0 for every P
                got = ops.tree_reduce_slots(x)
                want = ops.tree_reduce_slots_plain(x)
                torch.cuda.synchronize()
                check(same_bits(got, want), f"kernel != plain {dtype} {shape}")
                cases += 1
        if dtype.is_floating_point:
            # a (G=4, P=2) stack gathered along the leading rank axis
            x = torch.randn((2, 4, 6, 256), generator=gen,
                            device="cuda").to(dtype).movedim(0, 1)
            check(same_bits(ops.tree_reduce_slots(x),
                            ops.tree_reduce_slots_plain(x)),
                  f"kernel != plain on a strided stack {dtype}")
            cases += 1
    torch.cuda.synchronize()
    print(f"kernel vs plain: {cases} cases bitwise equal "
          "(f32 bf16 f16 int32; P 1 2 3 4 8 64; G=3; ragged; strided; -0.0)")


def phase_profile(torch, run, card: str) -> None:
    """Where one reduction's device time goes: ``torch.profiler`` over a
    warm run, device time by operator, largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # device-side events only (the kernels); an operator's row would
    # count its kernels' time a second time
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    total = sum(r[0] for r in rows)
    if total == 0:
        print("profile: the profiler saw no device time (not measured)")
        return
    print(f"profile of one reduction [{card}]: device time "
          f"{total / 1e3:.3f} ms by kernel:")
    for us, key, count in sorted(rows, reverse=True)[:10]:
        m = KERNEL_NAME.search(key)
        print(f"  {us / 1e3:9.3f} ms {us / total:6.1%}  x{count}  "
              f"{m.group(0) if m else key[:70]}")


def make_grads(torch, tree, transformer, cfg, mesh_shape, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = transformer.init_params(cfg, gen)
    return tree.map_leaves(
        lambda p: torch.randn((*mesh_shape, *p.shape), generator=gen,
                              device="cuda"), params)


def check_against_fp64(torch, grads, out, lead) -> float:
    """Every leaf within a 3-level tree's rounding of the fp64 sum:
    |r - s| <= 3 · 2^-24 · Σ|x| elementwise.  Returns the worst ratio."""
    worst = 0.0
    for g, r in zip(grads, out):
        x = g.double()
        exact = x.sum(dim=tuple(range(lead)))
        bound = 3 * 2.0**-24 * x.abs().sum(dim=tuple(range(lead)))
        err = (r[(0,) * lead].double() - exact).abs()
        check(bool((err <= bound).all()), "result outside fp64 bound")
        worst = max(worst, float((err / bound.clamp_min(1e-300)).max()))
        del x, exact, bound, err
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port is not at {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import tree
    from repro_torch.configs import tinyllama_1_1b as tl
    from repro_torch.core.engine import FlareConfig, GradReducer
    from repro_torch.kernels import ops
    from repro_torch.kernels import tree_reduce as tr
    from repro_torch.mesh import AXES, FLAT, TWO_LEVEL, RankMesh
    from repro_torch.models import transformer

    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    phase_build(tr)
    phase_kernel_vs_plain(torch, ops)

    # -- the main path: (2, 4) mesh, full width ------------------------------
    cfg = tl.CONFIG.scaled(n_layers=LAYERS)
    mesh = RankMesh(TWO_LEVEL, AXES)
    innet = GradReducer(FlareConfig(axes=AXES, transport="innetwork",
                                    reproducible=True), mesh)
    wire = GradReducer(FlareConfig(axes=AXES, algorithm="fixed_tree",
                                   reproducible=True), mesh)
    grads = make_grads(torch, tree, transformer, cfg, mesh.shape, args.seed)
    leaves = tree.flatten(grads)[0]
    n_params = sum(l[0, 0].numel() for l in leaves)
    print(f"model: {cfg.name} at published widths, {LAYERS} of "
          f"{tl.CONFIG.n_layers} layers, {n_params} fp32 parameters "
          f"({n_params * 4 / 1e9:.3f} GB per rank), mesh {mesh.shape}")

    launch_shapes = []
    kernel = tr.tree_reduce_slots

    def recording(x):
        launch_shapes.append((tuple(x.shape), x.stride(), x.dtype))
        return kernel(x)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr.launches = 0
    with mock.patch.object(tr, "tree_reduce_slots", recording):
        out, _ = innet(grads)
    torch.cuda.synchronize()
    launches = tr.launches
    peak = torch.cuda.max_memory_allocated()
    check(launches > 0, "the main path launched no tree_reduce kernel")
    out_leaves = tree.flatten(out)[0]
    print(f"main path: GradReducer innetwork reproducible on {mesh.shape}: "
          f"tree_reduce_slots launches {launches}, shapes "
          f"{[s for s, _, _ in launch_shapes]}")

    with mock.patch.object(ops, "tree_reduce_slots",
                           ops.tree_reduce_slots_plain):
        before = tr.launches
        plain, _ = innet(grads)
        check(tr.launches == before, "the plain-fold run launched the kernel")
    plain_leaves = tree.flatten(plain)[0]
    check(all(same_bits(a, b) for a, b in zip(out_leaves, plain_leaves)),
          "kernel reduction != plain-fold reduction")
    del plain, plain_leaves
    wired, _ = wire(grads)
    check(all(same_bits(a, b) for a, b in zip(out_leaves,
                                               tree.flatten(wired)[0])),
          "in-network fixed tree != wire fixed tree")
    del wired
    worst = check_against_fp64(torch, leaves, out_leaves, 2)
    print("main path checks: bitwise == plain fold, bitwise == wire "
          f"fixed_tree, every rank identical; fp64 error <= "
          f"{worst:.3f} of the 3-level bound")

    # -- whole-reduction time (host clock around synchronised runs) ---------
    def timed(fn, n):
        ts = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts), ts

    del out, out_leaves
    red_ms, red_all = timed(lambda: innet(grads), 5)
    with mock.patch.object(ops, "tree_reduce_slots",
                           ops.tree_reduce_slots_plain):
        plain_red_ms, _ = timed(lambda: innet(grads), 3)
    wire_ms, _ = timed(lambda: wire(grads), 3)
    print(f"reduction ms (median of 5, {card}): innetwork kernel "
          f"{red_ms:.3f} (runs {[round(t, 3) for t in red_all]}); same with "
          f"plain fold {plain_red_ms:.3f}; wire fixed_tree {wire_ms:.3f}; "
          f"peak device memory {peak / 2**30:.2f} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}")

    phase_profile(torch, lambda: innet(grads), card)

    # -- the flat (1, 8) mesh ---------------------------------------------
    flat = RankMesh(FLAT, AXES)
    fgrads = tree.map_leaves(lambda g: g.reshape(1, 8, *g.shape[2:]), grads)
    tr.launches = 0
    fout, _ = GradReducer(FlareConfig(axes=AXES, transport="innetwork",
                                      reproducible=True), flat)(fgrads)
    torch.cuda.synchronize()
    flat_launches = tr.launches
    check(flat_launches > 0, "the flat mesh launched no kernel")
    fwire, _ = GradReducer(FlareConfig(axes=AXES, algorithm="fixed_tree",
                                       reproducible=True), flat)(fgrads)
    check(all(same_bits(a, b) for a, b in zip(tree.flatten(fout)[0],
                                               tree.flatten(fwire)[0])),
          "flat mesh: in-network != wire fixed tree")
    print(f"flat mesh {flat.shape}: launches {flat_launches}, bitwise == "
          "wire fixed_tree")
    del fout, fwire, fgrads, grads, leaves
    torch.cuda.empty_cache()

    # -- the kernel at the main path's shapes ---------------------------------
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    max_err = 0.0
    for shape, stride, dtype in launch_shapes:
        span = 1 + sum((n - 1) * s for n, s in zip(shape, stride))
        x = torch.randn(span, generator=gen, device="cuda").to(
            dtype).as_strided(shape, stride)
        got, want = ops.tree_reduce_slots(x), ops.tree_reduce_slots_plain(x)
        check(same_bits(got, want), f"kernel != plain at {shape}")
        max_err = max(max_err, float((got.double() - want.double()).abs()
                                     .max()))
        del got, want
        nbytes = tr.bytes_moved(x)
        k_ms = cuda_ms(lambda: ops.tree_reduce_slots(x), 10)
        p_ms = cuda_ms(lambda: ops.tree_reduce_slots_plain(x), 5)
        l_ms = cuda_ms(lambda: x.sum(1, dtype=torch.float32), 5)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"kernel {shape} stride {stride}: {k_ms:.3f} ms, {nbytes} "
              f"bytes, bound {b_ms:.3f} ms ({b_ms / k_ms:.1%} of the "
              f"bound), {nbytes / k_ms / 1e6:.0f} GB/s; plain {p_ms:.3f} "
              f"ms; torch.sum {l_ms:.3f} ms  [{card}]")
        for k, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", b_ms),
                     ("library_ms", l_ms)):
            tot[k] += v
        del x
    print("kernel figures are per reduction: the sum over its "
          f"{len(launch_shapes)} launches")
    print(json.dumps({"kernels": [{
        "name": "tree_reduce_slots", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"], "bound_by": "bytes",
        "library_ms": tot["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
