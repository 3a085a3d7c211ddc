"""Paper §4–§7 performance models and simulators (plain Python).

The port's copies of the reference's three modules, equal outputs for
equal arguments:

  * ``switch_model`` — analytic τ / bandwidth / queue (Eq. 1) / working
    memory models of §4–§6, the shared-switch model, the §7 sparse and
    hash-spill terms and the lossy-fabric terms;
  * ``switch_sim``   — the discrete-event PsPIN switch simulator;
  * ``network_sim``  — the flow-level fat-tree simulator (Figure 15).

The emulated data plane's static counters (``switch.dataplane.
plan_counters``) and fault schedules are these models' inputs.
"""
from repro_torch.perfmodel import network_sim, switch_model, switch_sim

__all__ = ["network_sim", "switch_model", "switch_sim"]
