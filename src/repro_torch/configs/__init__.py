"""Architecture configs (``--arch <id>``) the port has.

The port of ``repro/configs/__init__.py`` for the configs whose model is
ported: each module exports ``CONFIG`` (the published configuration),
``SMOKE`` (a reduced same-family config for CPU smoke tests) and
``SHAPES`` (its shape cells).
"""
from __future__ import annotations

import dataclasses
import importlib

ARCHS = ["qwen3_moe_235b_a22b", "deepseek_v2_lite_16b", "mamba2_370m",
         "whisper_medium", "llama32_vision_90b", "gemma2_27b",
         "tinyllama_1_1b", "granite_20b", "gemma2_2b", "zamba2_1_2b"]

#: canonical ids → module names (the reference's, for the ported archs)
ALIASES = {"qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
           "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
           "mamba2-370m": "mamba2_370m",
           "whisper-medium": "whisper_medium",
           "llama-3.2-vision-90b": "llama32_vision_90b",
           "gemma2-27b": "gemma2_27b",
           "tinyllama-1.1b": "tinyllama_1_1b",
           "granite-20b": "granite_20b",
           "gemma2-2b": "gemma2_2b",
           "zamba2-1.2b": "zamba2_1_2b"}


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (shape) cell for an architecture."""

    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeCell("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeCell("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeCell("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeCell("long_500k", "decode", 524288, 1)

FULL_ATTN_SHAPES = [TRAIN_4K, PREFILL_32K, DECODE_32K]
SUBQUADRATIC_SHAPES = [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]


def load(arch: str):
    """Return the config module for an arch id (canonical or module name)."""
    name = ALIASES.get(arch, arch)
    if name not in ARCHS:
        raise NotImplementedError(f"unknown arch {arch!r} (have {ARCHS})")
    return importlib.import_module(f"repro_torch.configs.{name}")


def all_cells():
    """Every (arch × shape) cell: the 32-cell dry-run matrix (8 archs × 3
    shapes, the 2 subquadratic ones × 4)."""
    return [(a, s) for a in ARCHS for s in load(a).SHAPES]
