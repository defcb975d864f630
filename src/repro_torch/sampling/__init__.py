"""Seeded sampling (counterpart of ``repro.sampling``): logits processors
and keyed per-row draws on the device for the serving steps."""
from repro_torch.sampling.base import (ROLE_ACCEPT, ROLE_DRAFT,
                                       ROLE_RESIDUAL, ROLE_SAMPLE,
                                       SamplingConfig, available_samplers,
                                       get_sampler, process_logits,
                                       register_sampler, row_key,
                                       sample_rows, uniform_rows)

__all__ = [
    "SamplingConfig", "register_sampler", "get_sampler",
    "available_samplers", "process_logits", "sample_rows", "uniform_rows",
    "row_key", "ROLE_SAMPLE", "ROLE_DRAFT", "ROLE_ACCEPT", "ROLE_RESIDUAL",
]
