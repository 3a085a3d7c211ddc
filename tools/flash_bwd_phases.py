"""Where the fp32 backward's wide dQ kernel spends its cycles, on one card.

    python3 tools/flash_bwd_phases.py [--out FILE]

Copies ``csrc/flash_bwd.cu`` (with ``hopper.cuh`` beside it) into
``results/flash_bwd_phases/`` with ``clock64()`` counters added to
``dq_wide`` by text replacements (``PATCHES``; an anchor that no longer
matches stops the tool and names it), builds the copy and launches the
backward at phase 31's two fp32 launches at the wide pairs: gemma2-2b's
``(4, 4096, 8, 256)`` over 4 KV heads, cap 50, and deepseek's ``(4, 4096,
16, 192)`` with ``v`` the strided (192, 128) view.  Each consumer
warpgroup's first thread adds the cycles of its phases a block (the wait
for Q and dO, for each stage, the S or dP chain, P or dS and the
hand-overs, the wait for the other consumer, the dQᵀ tiles, the whole
loop), the producer's first splitter the cycles it waits for a stage and
splits it; the tool prints them a 16-key tile (the sums over the
launch's blocks divided by its tiles), one JSON object a line, the
card's name and power limit first, and writes them to ``--out``.  The
counters cost time of their own: read the phases against each other,
not against ``tools/flash_bwd_ab.py``.  Needs a CUDA card; exits 1
without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/csrc"
#: the phases of a consumer, in the order of its counters
PHASES = ("wait_q_do", "wait_stage", "scores", "p_or_ds", "hand_over",
          "wait_other", "tiles", "loop")
#: (anchor, replacement): the counters and their read-out
PATCHES = (
    ("namespace {\n\nusing bf16 = __nv_bfloat16;",
     "__device__ unsigned long long g_phase[64];\n"
     "extern \"C\" int flash_bwd_phases(unsigned long long* out, int reset) {\n"
     "  if (reset) {\n"
     "    unsigned long long z[64] = {0};\n"
     "    return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));\n"
     "  }\n"
     "  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(unsigned long long) * 64);\n"
     "}\n"
     "#define LAP(slot, t) do { long long _n = clock64(); "
     "ph[slot] += _n - (t); t = _n; } while (0)\n\n"
     "namespace {\n\nusing bf16 = __nv_bfloat16;"),
    ("  if (ntiles > 0) mbar_wait(qbar, 0);\n"
     "  int n = 0;  // tiles taken (both consumers take the same)",
     "  unsigned long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  long long tt = clock64(), tstart = tt;\n"
     "  if (ntiles > 0) mbar_wait(qbar, 0);\n"
     "  LAP(0, tt);\n"
     "  int n = 0;  // tiles taken (both consumers take the same)"),
    ("    if (wgi == 1) mbar_wait(ready2 + 8 * st, (it / RING) & 1);\n"
     "    if (none_visible(a, q0, q0 + QT - 1, t0, t0 + KB - 1)) {",
     "    if (wgi == 1) mbar_wait(ready2 + 8 * st, (it / RING) & 1);\n"
     "    LAP(1, tt);\n"
     "    if (none_visible(a, q0, q0 + QT - 1, t0, t0 + KB - 1)) {"),
    ("      scores<KB, HD / 8, QT, S::CH>(s, gb + QR, rl, t, sb + S::AB, "
     "sb + S::AS);",
     "      scores<KB, HD / 8, QT, S::CH>(s, gb + QR, rl, t, sb + S::AB, "
     "sb + S::AS);\n      LAP(2, tt);"),
    ("      if (n >= 2) mbar_wait(pempty + 8 * (n & 1), ((n >> 1) + 1) & 1);",
     "      LAP(3, tt);\n"
     "      if (n >= 2) mbar_wait(pempty + 8 * (n & 1), ((n >> 1) + 1) & 1);"),
    ("      mbar_arrive(pfull + 8 * (n & 1));\n"
     "      mbar_wait(dsfull + 8 * (n & 1), (n >> 1) & 1);\n"
     "      tiles_t<H0, 0, KB>(acc, sg + S::AB, sg + S::AS, w, g, t, dsb);",
     "      mbar_arrive(pfull + 8 * (n & 1));\n"
     "      LAP(4, tt);\n"
     "      mbar_wait(dsfull + 8 * (n & 1), (n >> 1) & 1);\n"
     "      LAP(5, tt);\n"
     "      tiles_t<H0, 0, KB>(acc, sg + S::AB, sg + S::AS, w, g, t, dsb);\n"
     "      LAP(6, tt);"),
    ("      scores<KB, VD / 8, QT, S::CH>(dp, gb + OR, rl, t, sb + S::BB, "
     "sb + S::BS);",
     "      scores<KB, VD / 8, QT, S::CH>(dp, gb + OR, rl, t, sb + S::BB, "
     "sb + S::BS);\n      LAP(2, tt);"),
    ("      mbar_wait(pfull + 8 * (n & 1), (n >> 1) & 1);\n",
     "      mbar_wait(pfull + 8 * (n & 1), (n >> 1) & 1);\n      LAP(3, tt);\n"),
    ("      mbar_arrive(dsfull + 8 * (n & 1));\n"
     "      mbar_wait(dsfull + 8 * (n & 1), (n >> 1) & 1);\n"
     "      tiles_t<H1, H0, KB>(acc, sg + S::AB, sg + S::AS, w, g, t, dsb);",
     "      mbar_arrive(dsfull + 8 * (n & 1));\n"
     "      LAP(4, tt);\n"
     "      mbar_wait(dsfull + 8 * (n & 1), (n >> 1) & 1);\n"
     "      LAP(5, tt);\n"
     "      tiles_t<H1, H0, KB>(acc, sg + S::AB, sg + S::AS, w, g, t, dsb);\n"
     "      LAP(6, tt);"),
    ("  // dQ = scale · Σ dS·K; value i of tile c",
     "  ph[7] += clock64() - tstart;\n"
     "  if (threadIdx.x % 128 == 0) {\n"
     "    for (int j = 0; j < 8; ++j) atomicAdd(&g_phase[8 * wgi + j], ph[j]);\n"
     "    atomicAdd(&g_phase[16 + wgi], (unsigned long long)n);\n"
     "  }\n"
     "  // dQ = scale · Σ dS·K; value i of tile c"),
    ("        mbar_wait(full + 8 * st, (it / RING) & 1);\n"
     "        uint8_t* sg = gb + S::RING_OFF + st * S::STAGE;\n"
     "        split_tile<false>(sg + S::AB, sg + S::AS, nullptr, nullptr, KB, "
     "HD, i, SPLITTERS);\n"
     "        split_done(ready + 8 * st);\n"
     "        split_tile<false>(sg + S::BB, sg + S::BS, nullptr, nullptr, KB, "
     "VD, i, SPLITTERS);\n"
     "        split_done(ready2 + 8 * st);",
     "        const long long tf = clock64();\n"
     "        mbar_wait(full + 8 * st, (it / RING) & 1);\n"
     "        const long long ts = clock64();\n"
     "        uint8_t* sg = gb + S::RING_OFF + st * S::STAGE;\n"
     "        split_tile<false>(sg + S::AB, sg + S::AS, nullptr, nullptr, KB, "
     "HD, i, SPLITTERS);\n"
     "        split_done(ready + 8 * st);\n"
     "        split_tile<false>(sg + S::BB, sg + S::BS, nullptr, nullptr, KB, "
     "VD, i, SPLITTERS);\n"
     "        split_done(ready2 + 8 * st);\n"
     "        if (i == 0) {\n"
     "          atomicAdd(&g_phase[20], (unsigned long long)(ts - tf));\n"
     "          atomicAdd(&g_phase[21], (unsigned long long)(clock64() - ts));\n"
     "        }"),
)
#: name, q (B, Sq, H, hd), k (B, Sk, KV, hd), vd, cap, the width of the
#: tensor ``v`` is a view of (None: contiguous)
CASES = (("gemma2-2b fp32", (4, 4096, 8, 256), (4, 4096, 4, 256), 256, 50.0,
          None),
         ("deepseek fp32", (4, 4096, 16, 192), (4, 4096, 16, 192), 128, 0.0,
          256))


def instrumented(out_dir: Path) -> Path:
    """``csrc/flash_bwd.cu`` with ``PATCHES`` applied, and ``hopper.cuh``,
    written into ``out_dir``; returns the source's path."""
    src = (CSRC / "flash_bwd.cu").read_text()
    # only dq_wide's body takes the consumer and splitter patches
    head, sep, rest = src.partition("__device__ __forceinline__ void dq_wide(")
    body, sep2, tail = rest.partition(
        "// dK and dV: one block a (b, KV head, 64 keys).\ntemplate")
    if not (sep and sep2):
        raise SystemExit("flash_bwd_phases: dq_wide not found")
    for i, (old, new) in enumerate(PATCHES):
        part = head if i == 0 else body
        if part.count(old) != 1:
            raise SystemExit(f"flash_bwd_phases: anchor {i} not found once: "
                             f"{old[:70]!r}")
        if i == 0:
            head = head.replace(old, new)
        else:
            body = body.replace(old, new)
    out_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy(CSRC / "hopper.cuh", out_dir / "hopper.cuh")
    path = out_dir / "flash_bwd.cu"
    path.write_text(head + sep + body + sep2 + tail)
    return path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="results/flash_bwd_phases.jsonl")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import flash_attn as fa

    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    lines = [json.dumps({"card": card})]
    print(lines[0], flush=True)
    fa.BWD_SOURCE = instrumented(ROOT / "results/flash_bwd_phases")
    read = ctypes.CDLL(str(kb.build(fa.BWD_SOURCE)[0])).flash_bwd_phases
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for name, qs, ks, vd, cap, v_in in CASES:
        gen = torch.Generator(device="cuda").manual_seed(1)
        q = torch.randn(qs, generator=gen, device="cuda")
        k = torch.randn(ks, generator=gen, device="cuda")
        v = (torch.randn((*ks[:3], v_in), generator=gen,
                         device="cuda")[..., -vd:] if v_in else
             torch.randn((*ks[:3], vd), generator=gen, device="cuda"))
        do = torch.randn((*qs[:3], vd), generator=gen, device="cuda")
        kw = dict(causal=True, scale=qs[-1] ** -0.5, attn_cap=cap, window=0)
        o, lse = fa.attention_fwd(q, k, v, **kw)
        fa.attention_bwd(q, k, v, o, lse, do, **kw)   # warm
        torch.cuda.synchronize()
        counts = (ctypes.c_ulonglong * 64)()
        read(None, 1)
        fa.attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        read(ctypes.addressof(counts), 0)
        tiles = max(counts[16], 1)
        res = {"case": name, "tiles": counts[16]}
        for w in (0, 1):
            res[f"consumer {w} cycles a tile"] = {
                p: round(counts[8 * w + j] / tiles, 1)
                for j, p in enumerate(PHASES)}
        res["splitter: wait for a stage, cycles a tile"] = round(
            counts[20] / tiles, 1)
        res["splitter: split, cycles a tile"] = round(counts[21] / tiles, 1)
        lines.append(json.dumps(res))
        print(lines[-1], flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
