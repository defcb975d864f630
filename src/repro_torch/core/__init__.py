"""MoE dispatch entry points (counterpart of ``repro.core``)."""
