"""Time variants of the fp32 flash kernel on one card, in one process, to
see what each of its design choices buys.

    python3 tools/flash_fp32_variants.py [--out FILE]

Each variant is ``csrc/flash_attn.cu`` with a few text replacements
(``VARIANTS``): the TF32 rounding by ``cvt.rna.tf32.f32`` in place of
the two integer operations; the products added straight into the
running scores and outputs; one or four 8-wide chunks a tensor-core sum
in place of two; hd 256 on 4 warps and 16-key tiles in place of 8 and 8;
the score loop unrolled in full.  Every variant is built at once (one
``nvcc`` each, into the package's ``build/``), then loaded in turn in
place of the kernel's library.  For each: the ptxas spills of its fp32
instances; its worst ``|o - plain|`` and ``|lse - plain|`` on inputs
that stress the sums (q = k at hd 256 with the cap, so that a row's
own score is about 16; q = k at hd 128 over one KV head; the VLM's
cross prefill, and with q times 4; hd 64 over 16384 keys; MLA's (192,
128)), beside SDPA's fp32 ``|sdpa - plain|`` on the uncapped ones; and
its time by CUDA events (``chip_smoke.cuda_ms``) at four launches (the
VLM's fp32 cross prefill, ``tools/flash_ab.py``'s "train fp32", hd 256
causal over 4096 keys, MLA's (192, 128) over 2048), in the order given
and then reversed, beside SDPA's fp32 time and the launch's bound on
the tensor cores (three times its flops at TF32's rate, or its bytes)
and on the CUDA cores (its flops at fp32's rate, or its bytes).  Prints
one JSON object a line, the card's name and power limit first, and
writes them to ``--out``.  Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_INT = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
_CVT = ("  uint32_t r;\n"
        "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : \"f\"(x));\n"
        "  return r;")
_S_SUM = ("prod3(c, ab[u], as[u]", "prod3(s[nb], ab[u], as[u]")
_S_ADD = ("        for (int j = 0; j < 4; ++j) s[nb][j] += c[j];\n",
          "        for (int j = 0; j < 4; ++j) {}\n")
_PV_SUM = ("prod3(d, pb[u], ps[u]", "prod3(acc[c], pb[u], ps[u]")
_PV_ADD = ("        for (int j = 0; j < 4; ++j) acc[c][j] += d[j];\n",
           "        for (int j = 0; j < 4; ++j) {}\n")
_CHUNKS = "constexpr int CHUNKS = 2;"
#: name → the (old, new) replacements that make it
VARIANTS = {
    "as built": [],
    "cvt.rna rounding": [(_INT, _CVT)],
    "sums in place": [_S_SUM, _S_ADD, _PV_SUM, _PV_ADD],
    "1 chunk a sum": [(_CHUNKS, "constexpr int CHUNKS = 1;")],
    "4 chunks a sum": [(_CHUNKS, "constexpr int CHUNKS = 4;")],
    "hd 256 on 4 warps, 16-key tiles": [
        ("static constexpr int WARPS = 8;",
         "static constexpr int WARPS = HD == 256 ? 4 : 8;"),
        ("static constexpr int KT = HD == 256 ? 8 : 32;",
         "static constexpr int KT = HD == 256 ? 16 : 32;")],
    "score loop unrolled in full": [
        ("#pragma unroll 4  // in full, the loads run ahead and spill",
         "#pragma unroll")],
}
#: name, q, k, vd, causal, cap, q = k (k is q's first KV heads), q's scale
ACCURACY = (
    ("q = k hd 256 cap 50", (1, 65, 2, 256), (1, 65, 2, 256), 256, True,
     50.0, True, 1.0),
    ("q = k hd 128 G 8", (1, 300, 8, 128), (1, 300, 1, 128), 128, True,
     0.0, True, 1.0),
    ("vlm cross prefill", (2, 1024, 64, 128), (2, 1600, 8, 128), 128,
     False, 0.0, False, 1.0),
    ("vlm cross prefill, q x 4", (2, 256, 64, 128), (2, 1600, 8, 128), 128,
     False, 0.0, False, 4.0),
    ("hd 64 over 16384 keys", (1, 256, 8, 64), (1, 16384, 2, 64), 64, False,
     0.0, False, 1.0),
    ("mla (192, 128)", (2, 700, 16, 192), (2, 700, 16, 192), 128, True, 0.0,
     False, 1.0),
)
#: name, q, k, vd, causal
TIMED = (
    ("vlm cross prefill", (2, 1024, 64, 128), (2, 1600, 8, 128), 128, False),
    ("train fp32", (4, 1024, 8, 64), (4, 1024, 8, 64), 64, True),
    ("hd 256 causal", (1, 4096, 8, 256), (1, 4096, 4, 256), 256, True),
    ("mla (192, 128)", (2, 2048, 16, 192), (2, 2048, 16, 192), 128, True),
)


def variant_sources(fa) -> dict:
    """Each variant's source, written under the package's build directory
    (one directory a variant, the file named as the kernel's)."""
    src = fa.SOURCE.read_text()
    out = {}
    for i, (name, reps) in enumerate(VARIANTS.items()):
        text = src
        for old, new in reps:
            if text.count(old) < 1:
                raise SystemExit(f"variant {name!r}: {old[:60]!r} not found")
            text = text.replace(old, new)
        path = fa._build.BUILD_DIR / "variants" / str(i) / fa.SOURCE.name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        out[name] = path
    return out


def spills(log: str) -> dict:
    """(hd, vd) → spill store bytes of each fp32 instance in a ptxas log."""
    out, dims = {}, None
    for line in log.splitlines():
        m = re.search(r"flash_fwd_tf32_kernelILi(\d+)ELi(\d+)E", line)
        if m and "Compiling entry" in line:
            dims = f"({m.group(1)}, {m.group(2)})"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and dims:
            out[dims] = int(m.group(1))
            dims = None
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="results/flash_fp32_variants.jsonl")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_fp32_variants: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import ref

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lines = [dict(card=card, variants=list(VARIANTS))]
    paths = variant_sources(fa)
    libs = fa._build.build(*paths.values())
    for name, lib in zip(paths, libs):
        lines.append(dict(variant=name, spill_store_bytes=spills(
            lib.with_suffix(".log").read_text())))

    gen = torch.Generator(device="cuda").manual_seed(31)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def use(name):
        fa.SOURCE = paths[name]
        fa._entry.cache_clear()

    def sdpa(q, k, v, causal, scale):
        return F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in (q, k, v)), is_causal=causal,
            scale=scale, enable_gqa=True).transpose(1, 2)

    cases = []
    for label, qs, ks, vd, causal, cap, same, mult in ACCURACY:
        q = randn(*qs) * mult
        k = q[:, :, :ks[2]].contiguous() if same else randn(*ks)
        v = randn(*ks[:-1], vd)
        kw = dict(causal=causal, scale=qs[-1] ** -0.5, attn_cap=cap,
                  window=0)
        cases.append((label, (q, k, v), kw,
                      ref.flash_attention_bshd(q, k, v, **kw)))
        if not cap:
            lines.append(dict(case=label, sdpa_err=float(
                (sdpa(q, k, v, causal, kw["scale"]) - cases[-1][3][0])
                .abs().max())))
    for name in paths:
        use(name)
        for label, t, kw, (po, plse) in cases:
            o, lse = fa.attention_fwd(*t, **kw)
            torch.cuda.synchronize()
            lines.append(dict(variant=name, case=label,
                              o_err=float((o - po).abs().max()),
                              lse_err=float((lse - plse).abs().max())))
    del cases
    torch.cuda.empty_cache()

    timed = []
    for label, qs, ks, vd, causal in TIMED:
        timed.append((label, (randn(*qs), randn(*ks), randn(*ks[:-1], vd)),
                      dict(causal=causal, scale=qs[-1] ** -0.5,
                           attn_cap=0.0, window=0)))
    ms = {}
    for name in list(paths) + list(reversed(paths)):
        use(name)
        for label, t, kw in timed:
            ms.setdefault((name, label), []).append(chip_smoke.cuda_ms(
                lambda: fa.attention_fwd(*t, **kw), 10))
    for (label, qs, ks, vd, causal), (_, t, kw) in zip(TIMED, timed):
        flops = fa.flops(qs[0], qs[2], qs[1], ks[1], qs[3], causal=causal,
                         vd=vd)
        nbytes = fa.bytes_moved(*t) / chip_smoke.HBM_BYTES_PER_S
        lines.append(dict(
            case=label, floor_ms=max(
                3 * flops / chip_smoke.TF32_FLOPS_PER_S, nbytes) * 1e3,
            cuda_core_bound_ms=max(
                flops / chip_smoke.FP32_FLOPS_PER_S, nbytes) * 1e3,
            sdpa_ms=chip_smoke.cuda_ms(
                lambda: sdpa(*t, causal, kw["scale"]), 10),
            ms={name: ms[(name, label)] for name in paths}))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        for line in lines:
            print(json.dumps(line))
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
