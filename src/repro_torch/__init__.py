"""PyTorch/CUDA port of the fused MoE dispatch system.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``repro_torch.kernels.grouped_gemm`` <-> ``repro.kernels.grouped_gemm``)
and imports nothing of it, nor of JAX.  The MoE dispatch kernels and the
paged decode-attention kernel are hand-written CUDA C++ for Hopper
(``csrc/``), built with nvcc at first use
and bound through ctypes (``kernels/_build.py``).  Each kernel wrapper runs
its plain PyTorch version only for tensors on the CPU; on a CUDA tensor it
launches the kernel or raises.
"""
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (every entry point's
    default) raises when CUDA is absent rather than running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' explicitly to run the "
            "plain PyTorch versions on the CPU")
    return dev
