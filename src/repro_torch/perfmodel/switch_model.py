"""The §6.4 aggregation-design switchover of the analytic switch model.

The port's copy of ``select_design`` from
``repro/perfmodel/switch_model.py``; the rest of that model (service
times, buffers, the sparse and lossy models) comes in a later slice.
"""
from __future__ import annotations


def select_design(data_bytes: int) -> tuple[str, int]:
    """§6.4 switchover: (design, B). Reproducible mode always uses tree."""
    if data_bytes > 512 << 10:
        return "single", 1
    if data_bytes > 256 << 10:
        return "multi", 4
    if data_bytes > 128 << 10:
        return "multi", 2
    return "tree", 1
