"""Synthetic data pipeline.

The port of ``repro/data/pipeline.py``.  ``batch_structs`` gives
``meta`` stand-ins for every model input of an (arch, shape-cell): the
dry-run's inputs, no allocation.  ``synthetic_batches`` is a
deterministic Zipf-ish token stream drawn with numpy from
``numpy.random.default_rng(seed)``, the same draws in the same order as
the reference, so both packages see the same tokens.  Generation is
numpy on the host with a one-slot prefetch thread; the tensors are
moved to ``device``.
"""
from __future__ import annotations

import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs import ShapeCell
from repro_torch.models.base import ModelConfig


def batch_structs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """``meta`` tensors of the shapes and dtypes of the model inputs of
    one (arch × shape) cell (the reference's ``jax.ShapeDtypeStruct``
    stand-ins): the audio and VLM frames except at decode."""
    b, s = cell.global_batch, cell.seq_len

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    if cell.kind == "train":
        batch = {"tokens": meta((b, s), torch.int32),
                 "labels": meta((b, s), torch.int32)}
    elif cell.kind == "prefill":
        batch = {"tokens": meta((b, s), torch.int32)}
    else:  # decode: one new token against a seq_len cache
        batch = {"tokens": meta((b, 1), torch.int32)}
    if cfg.family == "audio" and cell.kind != "decode":
        batch["enc_frames"] = meta((b, cfg.encoder_tokens, cfg.d_model),
                                   cfg.dtype)
    if cfg.family == "vlm" and cell.kind != "decode":
        batch["vision_embeds"] = meta((b, cfg.vision_tokens, cfg.d_model),
                                      cfg.dtype)
    return batch


def _make_batch(cfg: ModelConfig, b: int, s: int, rng: np.random.Generator,
                train: bool) -> dict:
    # Zipf-distributed tokens: realistic rank-frequency for LM loss curves
    toks = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64) % cfg.vocab
    batch = {"tokens": toks[:, :s].astype(np.int32)}
    if train:
        batch["labels"] = toks[:, 1:].astype(np.int32)
    if cfg.family == "audio":
        batch["enc_frames"] = rng.standard_normal(
            (b, cfg.encoder_tokens, cfg.d_model)).astype(np.float32) * 0.1
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32) * 0.1
    return batch


def synthetic_batches(cfg: ModelConfig, batch_size: int, seq_len: int, *,
                      seed: int = 0, train: bool = True,
                      device: str | torch.device = "cpu",
                      prefetch: bool = True) -> Iterator[dict]:
    """Endless deterministic batch stream (numpy arrays → tensors on
    ``device``) with one-slot prefetch."""
    rng = np.random.default_rng(seed)

    def produce():
        batch = _make_batch(cfg, batch_size, seq_len, rng, train)
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    if not prefetch:
        while True:
            yield produce()

    nxt: list = [None]

    def fill():
        nxt[0] = produce()

    t = threading.Thread(target=fill)
    t.start()
    while True:
        t.join()
        cur = nxt[0]
        t = threading.Thread(target=fill)
        t.start()
        yield cur
