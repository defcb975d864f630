"""Speculative decoding on the paged engine (counterpart of
``repro.spec``)."""
from repro_torch.spec.engine import SpecEngine, make_draft_config

__all__ = ["SpecEngine", "make_draft_config"]
