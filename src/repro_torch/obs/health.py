"""The fabric health plane's severity scale.

Only ``SEVERITIES`` and ``severity_rank`` of ``repro/obs/health.py`` are
ported, for the report CLI's ``--fail-on`` gate; the detectors,
``Incident`` and ``HealthMonitor`` are ROADMAP queue 1 item 13.
"""
from __future__ import annotations

SEVERITIES = ("info", "warning", "critical")


def severity_rank(severity: str) -> int:
    """Position on the severity scale; unknown severities are an error
    (a typo'd SLO rule must fail loudly, not silently never match)."""
    try:
        return SEVERITIES.index(severity)
    except ValueError:
        raise ValueError(f"unknown severity {severity!r}; one of "
                         f"{SEVERITIES}") from None
