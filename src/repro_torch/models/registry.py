"""Family → model-function dispatch.

The port of ``repro/models/registry.py`` for the ``"dense"`` family, the
only one whose forward is ported; the others raise.  ``init`` takes a
``torch.Generator`` (on the device the parameters should live on) where
the reference takes a ``jax.random`` key.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.models import transformer
from repro_torch.models.base import ModelConfig

_TODO = "ROADMAP queue 1 item 14 (serving, decode and the other families)"


def _not_ported(what: str) -> Callable:
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{what} is not ported: {_TODO}")
    return fn


@dataclasses.dataclass(frozen=True)
class Model:
    """Functional model bundle for one architecture."""

    cfg: ModelConfig
    init: Callable          # (generator) -> params
    loss: Callable          # (params, batch, *, gather=None) -> per-rank loss
    prefill: Callable       # not ported
    decode: Callable        # not ported
    init_cache: Callable    # not ported


_FAMILIES: dict[str, Any] = {"dense": transformer}


def get_model(cfg: ModelConfig) -> Model:
    mod = _FAMILIES.get(cfg.family)
    if mod is None:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported: {_TODO}")
    return Model(
        cfg=cfg,
        init=lambda gen: mod.init_params(cfg, gen),
        loss=lambda params, batch, **kw: mod.loss_fn(cfg, params, batch, **kw),
        prefill=_not_ported("prefill"),
        decode=_not_ported("decode"),
        init_cache=_not_ported("init_cache"),
    )
