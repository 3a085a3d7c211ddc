"""Serving: prefill and decode steps and a slot-based batched server."""
from repro_torch.serve.engine import BatchedServer, Request

__all__ = ["BatchedServer", "Request"]
