"""Serving (counterpart of ``repro.serve``): the contiguous greedy engine."""
from repro_torch.serve.engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
