"""Build and bind the CUDA kernels in ``repro_torch/csrc``.

At first use the ``.cu`` sources are compiled for Hopper (``sm_90a``) with
one ``nvcc`` process per source, all started together, and linked into one
shared library with a plain C interface under ``build/kernels/`` at the
root of the checkout.  The library's name carries a hash of the sources, so
an edited source is never served by a stale build.  It is loaded with
ctypes; every pointer and the stream are passed as ``c_void_p``.

Each C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises if that is not 0.  ``LAUNCHES`` counts launches per kernel:
each wrapper adds one where it launches its kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
# -fvisibility=hidden: only the C entry points (MOE_API) are exported, so
# two builds loaded into one process (chip_gemm_ab.py) keep their own
# template statics, such as each launcher's cudaFuncSetAttribute, which
# the dynamic linker would otherwise share between them
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xcompiler", "-fvisibility=hidden",
              "-Xptxas", "-v"]

KERNELS = ("router_topk", "permute", "unpermute", "grouped_gemm",
           "fused_gate_up", "paged_attention", "paged_attention_mla",
           "grouped_gemm_t", "grouped_wgrad")
# the kernels that only training's backward launches (B1 with the weight
# read transposed, and B7)
BACKWARD_KERNELS = ("grouped_gemm_t", "grouped_wgrad")
# B1 and B2 compile once per weight format; each format counts on its own
QUANT_KERNELS = ("grouped_gemm_int8", "grouped_gemm_int4",
                 "fused_gate_up_int8", "fused_gate_up_int4")
LAUNCHES = {name: 0 for name in KERNELS + QUANT_KERNELS}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "moe_router_topk": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "moe_permute": [_P, _P, _P, _I, _I, _P],
    "moe_unpermute": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "moe_grouped_gemm": [_P] * 9 + [_I] * 9 + [_P, _I, _I],
    "moe_fused_gate_up": [_P] * 10 + [_I] * 9 + [_P, _I, _I],
    "moe_grouped_gemm_t": [_P] * 7 + [_I] * 6 + [_P],
    "moe_grouped_wgrad": [_P] * 7 + [_I] * 7 + [_P],
    "moe_expert_tiles": [_P] * 4 + [_I] * 3 + [_P, _I],
    "moe_paged_attention": [_P] * 9 + [_F] + [_I] * 13 + [_F, _I, _P],
    "moe_paged_attention_mla": [_P] * 10 + [_F] + [_I] * 13 + [_F, _I, _P],
    "moe_launch_floor": [_P],
}

_lock = threading.Lock()
_lib = None
build_log = ""          # nvcc's output (register and shared-memory use)
build_seconds = {}      # source name -> seconds its nvcc took


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the sources (in parallel) and link the library; returns its
    path.  A library already built from identical sources is reused."""
    global build_log
    target = BUILD_DIR / f"libmoe_kernels-{_digest()}.so"
    if target.exists():
        return target
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        t0 = time.perf_counter()
        for src in cu:
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            log = open(pathlib.Path(tmp) / (src.stem + ".log"), "w+")
            procs.append((src, log, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=log, stderr=subprocess.STDOUT, text=True)))
        running = list(procs)
        while running:                  # each source's own build time
            for item in list(running):
                if item[2].poll() is not None:
                    build_seconds[item[0].name] = time.perf_counter() - t0
                    running.remove(item)
            time.sleep(0.05)
        logs, failed = [], []
        for src, log, p in procs:
            log.seek(0)
            logs.append(f"== {src.name}\n{log.read()}")
            log.close()
            if p.returncode != 0:
                failed.append(src.name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp_lib = pathlib.Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in _SIGNATURES.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch_floor(device) -> None:
    """Launch the empty kernel (``csrc/launch_floor.cu``) on ``device``'s
    current stream: the cost of a launch with no work, to time beside the
    small kernels.  No path of the port launches it."""
    check(library().moe_launch_floor(stream_ptr(device)), "launch_floor")


def check(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel!r} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(device) -> int:
    """The current stream of ``device``, which must be the current device
    (the C entry points launch on the calling thread's device)."""
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {device}, current device "
                         f"cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype) -> int:
    """The C interface's dtype code (csrc/common.cuh MoeDtype)."""
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"the CUDA kernels take float32 or bfloat16, not {dtype}")


def require(cond: bool, msg: str) -> None:
    """Raise on an input the kernel does not take."""
    if not cond:
        raise ValueError(msg)


def aligned(*tensors) -> bool:
    """True when every tensor starts on a 16-byte boundary (what TMA
    takes)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def on_cuda(*tensors) -> bool:
    """True when the tensors lie on a CUDA device (the kernel runs); False
    when they lie on the CPU (the plain version runs).  Anything else, or a
    mix, raises."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on devices {sorted(kinds)}: the kernels take "
                     "CUDA tensors and the plain versions CPU tensors")
