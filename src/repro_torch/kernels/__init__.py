"""Hand-written CUDA kernels for the MoE dispatch path and the paged
decode attention (``csrc/``), each with its plain PyTorch version beside it
(counterpart of ``repro.kernels``)."""
