"""Time variants of the bf16 decode kernel on one card, in one run, to see
what its ring's shape and its grid's order buy.

    python3 tools/decode_variants.py [--out FILE] [--iters N] [--reps N]

Each variant is a copy of ``src/repro_torch`` in a temporary directory
with a few text replacements (``VARIANTS``) in ``csrc/flash_attn.cu``
and ``flash_attn.py``: the keys a tile (as built 32 up to hd 128, 16
above; 16 at hd 128; 64 up to hd 64), the ring's stages (8 as built, 4,
12), and the grid with KV heads fastest (a split's blocks of neighbouring
heads dispatched together, the cluster along the grid's second
dimension) in place of splits fastest, and the tiles loaded in boxes of
8 rows, each row group's 64-wide chunks of a key one after another (a
key's 256-512 bytes requested together at hd 128 and 256), and a tile's
boxes issued by one producer lane each in place of one lane in turn,
and the tensor maps' L2 promotion at 256 bytes in place of 128.  ``--variant``
keeps the variants whose names hold the texts given.  Every variant's
kernel is built at once (one ``nvcc``
each, into its copy's ``build/``), then ``tools/flash_ab.py --sweep``
times each copy's bf16 decode cases at forced split counts and both
joins, in a process of its own.  Prints one JSON object a line (the
card's name and power limit first, then each variant's sweep) and writes
them to ``--out``.  Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = "kernels/csrc/flash_attn.cu"
PY = "kernels/flash_attn.py"
_KT = ("static constexpr int KT = 2 * (HDP + VDP) <= 512 ? 32 : 16;",
       "return 32 if 2 * (max(hd, 64) + max(vd, 64)) <= 512 else 16")
_STAGES = ("constexpr int STAGES = 2 * CONSUMERS;", "DECODE_STAGES = 8")
#: name → the (file, old, new) replacements that make it
VARIANTS = {
    "8 stages, 32-key tiles to hd 128 (as built)": [],
    "8 KB stages (16 keys at hd 128)": [
        (CU, _KT[0], "static constexpr int KT = 2 * (HDP + VDP) <= 256 ? "
                     "32 : 16;"),
        (PY, _KT[1], "return 32 if 2 * (max(hd, 64) + max(vd, 64)) <= 256 "
                     "else 16")],
    "16 KB stages (64 keys to hd 64)": [
        (CU, _KT[0], "static constexpr int KT = 2 * (HDP + VDP) <= 256 ? 64 "
                     ": 2 * (HDP + VDP) <= 512 ? 32 : 16;"),
        (PY, _KT[1], "return (64 if 2 * (max(hd, 64) + max(vd, 64)) <= 256 "
                     "else 32 if 2 * (max(hd, 64) + max(vd, 64)) <= 512 "
                     "else 16)")],
    "4 stages": [
        (CU, _STAGES[0], "constexpr int STAGES = CONSUMERS;"),
        (PY, _STAGES[1], "DECODE_STAGES = 4")],
    "12 stages": [
        (CU, _STAGES[0], "constexpr int STAGES = 3 * CONSUMERS;"),
        (PY, _STAGES[1], "DECODE_STAGES = 12")],
    "8-row boxes, a key's chunks together": [
        (CU, """#pragma unroll 1
        for (int c = 0; c < S::HC; ++c)
          tma_load(kst + c * KT * 128, &tk, full + 8 * st, 64 * c, kvh, t0, b, n);
#pragma unroll 1
        for (int c = 0; c < S::VC; ++c)
          tma_load(vst + c * KT * 128, &tv, full + 8 * st, 64 * c, kvh, t0, b, n);""",
         """#pragma unroll 1
        for (int r = 0; r < KT; r += 8) {
#pragma unroll 1
          for (int c = 0; c < S::HC; ++c)
            tma_load(kst + (c * KT + r) * 128, &tk, full + 8 * st, 64 * c, kvh,
                     t0 + r, b, n);
#pragma unroll 1
          for (int c = 0; c < S::VC; ++c)
            tma_load(vst + (c * KT + r) * 128, &tv, full + 8 * st, 64 * c, kvh,
                     t0 + r, b, n);
        }"""),
        (CU, """  if (!make_map(&mk, k, N, a.B, a.Sk, a.KV, HD, strides + 4, Sh::KT) ||
      !make_map(&mv, v, N, a.B, a.Sk, a.KV, VD, strides + 8, Sh::KT))
    return cudaErrorInvalidValue;
  if (a.R <= 16)""",
         """  if (!make_map(&mk, k, N, a.B, a.Sk, a.KV, HD, strides + 4, 8) ||
      !make_map(&mv, v, N, a.B, a.Sk, a.KV, VD, strides + 8, 8))
    return cudaErrorInvalidValue;
  if (a.R <= 16)""")],
    "a tile's boxes issued by one lane each": [
        (CU, """    if (lane == 0) {
#pragma unroll 1
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + 8 * st, (it / STAGES + 1) & 1);
        mbar_expect_tx(full + 8 * st, S::STAGE);
        const uint32_t kst = base + st * S::STAGE, vst = kst + S::K_BYTES;
        const int t0 = s_lo + it * KT;
#pragma unroll 1
        for (int c = 0; c < S::HC; ++c)
          tma_load(kst + c * KT * 128, &tk, full + 8 * st, 64 * c, kvh, t0, b, n);
#pragma unroll 1
        for (int c = 0; c < S::VC; ++c)
          tma_load(vst + c * KT * 128, &tv, full + 8 * st, 64 * c, kvh, t0, b, n);
      }
    }""", """#pragma unroll 1
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % STAGES;
      if (lane == 0) {
        if (it >= STAGES) mbar_wait(empty + 8 * st, (it / STAGES + 1) & 1);
        mbar_expect_tx(full + 8 * st, S::STAGE);
      }
      __syncwarp();
      const uint32_t kst = base + st * S::STAGE, vst = kst + S::K_BYTES;
      const int t0 = s_lo + it * KT;
      if (lane < S::HC)
        tma_load(kst + lane * KT * 128, &tk, full + 8 * st, 64 * lane, kvh, t0, b, n);
      else if (lane < S::HC + S::VC)
        tma_load(vst + (lane - S::HC) * KT * 128, &tv, full + 8 * st,
                 64 * (lane - S::HC), kvh, t0, b, n);
    }""")],
    "L2 promotion 256 B": [
        ("kernels/csrc/hopper.cuh", "CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
         "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")],
    "KV heads fastest": [
        (CU, "  const int split = blockIdx.x;\n  int blk = blockIdx.y;",
         "  const int split = blockIdx.y;\n  int blk = blockIdx.x;"),
        (CU, "cfg.gridDim = dim3(a.splits, N * a.B * a.KV, 1);",
         "cfg.gridDim = dim3(N * a.B * a.KV, a.splits, 1);"),
        (CU, "attr[0].val.clusterDim.x = a.cluster ? a.splits : 1;\n"
             "  attr[0].val.clusterDim.y = 1;",
         "attr[0].val.clusterDim.x = 1;\n"
         "  attr[0].val.clusterDim.y = a.cluster ? a.splits : 1;")],
}


def make(tmp: Path, i: int, edits: list) -> Path:
    """Variant ``i``'s copy of the package, edited; returns its ``src``."""
    src = tmp / f"v{i}" / "src"
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for name, old, new in edits:
        path = src / "repro_torch" / name
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"decode_variants: {old!r} not in {name}")
        path.write_text(text.replace(old, new))
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/decode_variants.jsonl")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variant", action="append", default=[],
                    help="only the variants whose name holds this text "
                         "(repeatable; all by default)")
    args = ap.parse_args()
    chosen = {name: edits for name, edits in VARIANTS.items()
              if not args.variant or any(v in name for v in args.variant)}
    import torch
    if not torch.cuda.is_available():
        print("decode_variants: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lines = [dict(card=card, variants=list(chosen))]
    with tempfile.TemporaryDirectory() as tmp:
        trees = [make(Path(tmp), i, edits)
                 for i, edits in enumerate(chosen.values())]
        builds = [subprocess.Popen(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, sys.argv[1]); "
             "from repro_torch.kernels import build, flash_attn as fa; "
             "build.build(fa.SOURCE)", str(tree)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for tree in trees]
        for name, proc in zip(chosen, builds):
            out, _ = proc.communicate()
            if proc.returncode:
                print(f"decode_variants: {name} did not build:\n{out[-3000:]}",
                      file=sys.stderr)
                return 1
        for name, tree in zip(chosen, trees):
            out = Path(tmp) / "sweep.jsonl"
            res = subprocess.run(
                [sys.executable, str(ROOT / "tools" / "flash_ab.py"),
                 "--sweep", "--tree", str(tree), "--iters", str(args.iters),
                 "--reps", str(args.reps), "--out", str(out)],
                capture_output=True, text=True)
            if res.returncode:
                print(res.stdout[-2000:], res.stderr[-3000:], file=sys.stderr)
                return 1
            rows = [json.loads(x) for x in out.read_text().splitlines()][1:]
            lines.append(dict(variant=name, sweep=rows))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        for line in lines:
            print(json.dumps(line))
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
