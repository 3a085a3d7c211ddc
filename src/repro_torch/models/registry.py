"""Family → model-function dispatch.

The port of ``repro/models/registry.py``: the ``"dense"``, ``"moe"`` and
``"vlm"`` families through ``transformer``, ``"audio"`` through
``whisper``, ``"ssm"`` through ``mamba2`` and ``"hybrid"`` through
``zamba2`` (training and serving); ``abstract_params``, the parameters'
shapes without storage.  ``init`` takes
a ``torch.Generator`` (on the device the parameters should live on) where
the reference takes a ``jax.random`` key, and ``init_cache`` also takes
the ``device`` its cache should live on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import tree
from repro_torch.models import mamba2, transformer, whisper, zamba2
from repro_torch.models.base import ModelConfig

@dataclasses.dataclass(frozen=True)
class Model:
    """Functional model bundle for one architecture."""

    cfg: ModelConfig
    init: Callable          # (generator, cast=None) -> params
    loss: Callable          # (params, batch, *, gather=None) -> per-rank loss
    prefill: Callable       # (params, batch, *, gather=None) -> (logits, cache)
    decode: Callable        # (params, token, cache, *, gather=None) -> (logits, cache)
    init_cache: Callable    # (batch_size, max_seq, *, dtype=, device=) -> cache


_FAMILIES: dict[str, Any] = {"dense": transformer, "moe": transformer,
                             "vlm": transformer, "ssm": mamba2,
                             "audio": whisper, "hybrid": zamba2}


def get_model(cfg: ModelConfig) -> Model:
    mod = _FAMILIES.get(cfg.family)
    if mod is None:
        raise ValueError(f"unknown model family {cfg.family!r} ({cfg.name})")
    return Model(
        cfg=cfg,
        init=lambda gen, **kw: mod.init_params(cfg, gen, **kw),
        loss=lambda params, batch, **kw: mod.loss_fn(cfg, params, batch, **kw),
        prefill=lambda params, batch, **kw: mod.prefill(cfg, params, batch,
                                                        **kw),
        decode=lambda params, token, cache, **kw: mod.decode_step(
            cfg, params, token, cache, **kw),
        init_cache=lambda bs, max_seq, **kw: mod.init_cache(cfg, bs, max_seq,
                                                            **kw),
    )


def abstract_params(model: Model) -> dict:
    """The global parameters' shapes and dtypes as ``meta`` tensors:
    ``model.init`` under ``FakeTensorMode`` (the counterpart of
    ``jax.eval_shape``; a ``meta`` device has no ``torch.Generator``,
    which the init draws from)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = model.init(torch.Generator().manual_seed(0))
    return tree.map_leaves(lambda t: torch.empty(
        t.shape, dtype=t.dtype, device="meta"), fake)
