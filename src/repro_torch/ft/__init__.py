"""Fault tolerance: sharded checkpoints, failure detection, elastic
re-mesh, and the switch's and the sessions' failure recovery."""
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.ft.coordinator import (Coordinator, RemeshPlan,
                                        recover_switch_failure)

__all__ = ["CheckpointManager", "Coordinator", "RemeshPlan",
           "recover_switch_failure"]
