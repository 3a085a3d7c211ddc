"""Fault tolerance: the session-scoped recovery of the multi-tenant switch.

Only ``coordinator.recover_session_failure`` is ported; checkpoints,
failure detection and elastic re-meshing are ROADMAP queue 1 item 12.
"""
from repro_torch.ft.coordinator import recover_session_failure

__all__ = ["recover_session_failure"]
