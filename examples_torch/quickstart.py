"""Quickstart: the Flare collective family on 8 emulated ranks (the port
of ``examples/quickstart.py``).

The ranks of a ``(pod, data)`` = ``(2, 4)`` mesh are the leading axes of
one tensor on one device (``repro_torch.mesh.RankMesh``).  On the card
the int8 transport runs the ``quantize`` / ``dequantize`` kernels and the
sparse one the ``sparse_accum`` kernels.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import collectives as coll, compression, reproducible
from repro_torch.core import sparse
from repro_torch.mesh import RankMesh
from repro_torch.obs import HealthMonitor, Telemetry, counting_clock
from repro_torch.switch import dataplane

Z = 1 << 16


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (use --device cpu)")
    dev = torch.device(args.device)

    mesh = RankMesh((2, 4), ("pod", "data"))
    rng = np.random.default_rng(0)
    contrib = rng.normal(size=(8, Z)).astype(np.float32)
    oracle = contrib.sum(0)
    x = torch.from_numpy(contrib).reshape(2, 4, Z).to(dev)
    out = {}

    def rank0(t: torch.Tensor) -> np.ndarray:
        return t[0, 0].cpu().numpy()

    print(f"allreduce of {Z} floats across a 2-pod x 4-chip mesh\n")
    for alg in ["ring", "rhd", "fixed_tree", "two_level", "psum", "auto"]:
        got = coll.allreduce(x, mesh, ("pod", "data"), algorithm=alg)
        err = float(np.abs(got.cpu().numpy() - oracle).max())
        wire = coll.wire_bytes_per_rank(
            Z * 4, 4, 2, algorithm=alg if alg not in ("auto", "psum")
            else "ring")
        out[alg] = err
        print(f"  {alg:12s} max_err={err:.2e} wire/rank={wire/2**10:.0f} KiB")

    print("\nreproducible (F3): bitwise-stable fixed-tree reduction")
    a = rank0(reproducible.reproducible_allreduce(x, mesh, ("pod", "data")))
    b = rank0(reproducible.reproducible_allreduce(x, mesh, ("pod", "data")))
    out["f3_bitwise"] = a.tobytes() == b.tobytes()
    print(f"  run1 == run2 bitwise: {out['f3_bitwise']}")

    print("\nsparse §7: top-1% with densify-on-overflow")
    got = rank0(sparse.sparse_allreduce(x, mesh, "data", k=Z // 100)[0])
    out["nnz"] = int((got != 0).sum())
    print(f"  nnz(result) = {out['nnz']} of {Z}")

    print("\nint8 transport (F1) with fp32 accumulation")
    got = rank0(coll.allreduce_rhd(
        compression.quantized_allreduce(x, mesh, "data"), mesh, "pod"))
    out["int8_rel_err"] = float(np.abs(got - oracle).max()
                                / np.abs(oracle).max())
    print(f"  rel_err = {out['int8_rel_err']:.4f} (wire = 1/4 of fp32)")

    print("\nflight recorder (DESIGN.md §16): counters without touching the "
          "trace")
    tm = Telemetry.create()
    tm.record_switch_counters(
        "demo", dataplane.plan_counters(("pod", "data"), (2, 4), 4, Z // 4,
                                        torch.float32))
    pkts = tm.registry.value("switch.demo.l1.ingress_packets")
    out["ingress_packets"] = pkts
    print(f"  switch.demo.l1.ingress_packets = {pkts:.0f} "
          f"(static plan counters; full runs: "
          f"launch/train.py --trace-out/--metrics-out "
          f"+ python -m repro_torch.obs.report)")

    print("\nhealth plane (DESIGN.md §17): detectors over the recorder")
    tm.registry.gauge("congestion.l1s0.hotness").set(0.8)   # a hot leaf slot
    hm = HealthMonitor(tm, clock=counting_clock())
    out["incidents"] = hm.poll()
    for inc in out["incidents"]:
        print(f"  [{inc.severity}] {inc.detector}: {inc.summary} "
              f"(action: {inc.action})")
    print("  (full runs: launch/train.py --tenants 2 --health-policy auto "
          "--incidents-out inc.json + python -m repro_torch.obs.report "
          "--incidents inc.json --fail-on critical)")
    return out


if __name__ == "__main__":
    main()
