"""Hand-written CUDA kernels for the MoE dispatch path (``csrc/``), each
with its plain PyTorch version beside it (counterpart of
``repro.kernels``)."""
