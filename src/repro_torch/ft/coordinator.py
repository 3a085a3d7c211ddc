"""Session-scoped failure recovery for the shared switch.

The port of ``recover_session_failure`` from ``repro/ft/coordinator.py``.
The rest of the coordinator (``plan_remesh``, ``recover_switch_failure``,
the heartbeat ``Coordinator``) is ROADMAP queue 1 item 12.
"""
from __future__ import annotations


def recover_session_failure(runtime, tenant: str | None, *,
                            reason: str = "retry budget exhausted") -> bool:
    """Degrade one *session* to the host-based wire fallback.

    When the reliability layer's retry budget cannot recover a tenant's
    packets (a lossy fabric, not a dead switch), only that tenant drains
    from the shared runtime (``SessionManager.evict``); the switch, its
    tree and every other session are untouched.  The caller
    (``transports.SwitchTransport``) then reduces the affected arenas
    over the wire transports.  Idempotent; returns whether a session was
    drained.
    """
    if runtime is None or tenant is None:
        return False
    return runtime.evict(tenant, reason=reason)
