"""Serving launcher: batched decode with the slot server.

The port of ``repro/launch/serve.py``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --smoke --requests 8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve   # full width, the card

It runs on the card (``--device cuda``, the default; it stops when there
is none) or, for tests, on the CPU (``--device cpu``).  The weights are
random from ``torch.Generator(device).manual_seed(--seed)``, the prompts
(2 to 7 tokens) from ``numpy.random.default_rng(--seed)``; the layers
are drawn one at a time and cast as they are drawn, so that a model
whose fp32 weights would not fit beside their cast (deepseek-v2-lite at
27 layers) is served.  Parameters are held in the model's compute dtype (bf16 at full width, fp32 with
``--smoke``) but for the ``KEEP_F32`` leaves (the MoE router), as
``sharding.rules.cast_params`` casts them: the reference's launcher
hands its fp32 parameters to a bf16 model, whose decode then fails on a
mixed-dtype layer carry, so it serves only ``--smoke``.  ``--arch`` takes
every ported config: tinyllama-1.1b, gemma2-2b, gemma2-27b, granite-20b,
qwen3-moe-235b-a22b, deepseek-v2-lite-16b (the MLA cache),
llama-3.2-vision-90b and whisper-medium (both decoding against the zero
cross-attention cache, as the reference's server does: it passes no
vision embeddings or frames) and mamba2-370m (its conv and SSM state,
every lane stepped in lockstep, as the reference's server steps it).  ``--fake-devices`` has no counterpart: the
server runs on one device.
"""
from __future__ import annotations

import argparse
import time


def _parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", type=str, default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--device", type=str, default="cuda",
                    choices=("cuda", "cpu"),
                    help="where the server runs (cpu: tests and bring-up)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and the prompts")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Serve ``--requests`` random prompts; prints the reference's lines
    and returns the requests (their ``out`` tokens)."""
    args = _parse(argv)

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models.registry import get_model
    from repro_torch.serve import BatchedServer
    from repro_torch.sharding import rules

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (use --device cpu "
                           "to serve on the CPU)")
    mod = configs.load(args.arch)
    cfg = mod.SMOKE if args.smoke else mod.CONFIG
    if args.smoke:
        cfg = cfg.scaled(dtype=torch.float32)
    model = get_model(cfg)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = model.init(gen, cast=lambda t: rules.cast_params(t, cfg.dtype))

    srv = BatchedServer(model, params, slots=args.slots,
                        max_len=args.max_len)
    rng = np.random.default_rng(args.seed)
    reqs = [srv.submit(rng.integers(0, cfg.vocab, size=rng.integers(2, 8)),
                       max_new=args.max_new)
            for _ in range(args.requests)]
    t0 = time.time()
    steps = srv.run()
    if args.device == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    toks = sum(len(r.out) for r in reqs)
    print(f"served {len(reqs)} requests, {toks} tokens, "
          f"{steps} batch steps, {toks / dt:.1f} tok/s")
    for r in reqs[:4]:
        print(f"  req {r.rid}: prompt={r.prompt.tolist()} -> {r.out[:8]}...")
    return reqs


if __name__ == "__main__":
    main()
