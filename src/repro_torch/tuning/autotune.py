"""Sweeps that fill the tune cache (counterpart of ``repro.tuning.autotune``).

A sweep times every tile shape a kernel takes (``kernels/grouped_gemm.py``
``TILE_SHAPES``: ``block_m`` the row tile, ``block_n`` the output columns
an item, ``block_k`` the fixed 64-deep K stage) at one shape key, on the
operands a real call at that key gets: routing drawn from a seeded numpy
generator at the T the key stands for, and the schedule that the
configured policy (``fixed``, ``dynamic``) builds from it, so that each
expert's active blocks form one run from ``seg_start[e] // block_m``, the
contract the Hopper kernels' work lists read (``kernels/expert_tiles.py``).
The reference's round-robin schedule would break it.

Every candidate list holds the default tile, and the winner is the argmin
over the same measurement, so ``winner <= default`` holds on the recorded
numbers.  On CUDA ``bench`` times device work: CUDA-graph replays between
CUDA events, the candidates in turns, the minimum over reps.  On the CPU
the kernels' plain versions run: that exercises the machinery (the tests),
but the timings mean nothing, and ``tuning.build`` refuses to write a
cache from them unless forced.

fp32 runs one tile (``csrc/grouped_gemm.cuh``): its keys have the default
as their only candidate, and the sweep says so without timing it."""
from __future__ import annotations

import time
from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import fused_gate_up as _fgu
from repro_torch.kernels import grouped_gemm as _gg
from repro_torch.scheduling import (build_schedule, combine_scale_rows,
                                    policy_config_kwargs)
from repro_torch.scheduling.dynamic import sub_block
from repro_torch.tuning.cache import TuneCache, dtype_name, make_key

BLOCK_K = 64                      # hopper_gemm.cuh BK: one K stage
KERNELS = ("grouped_gemm", "fused_gate_up")
# bench on CUDA: calls captured a graph, replays timed a round
PER_GRAPH, REPLAYS = 5, 4


def candidate_configs(kernel: str, fmt: str = "dense",
                      dtype=torch.bfloat16
                      ) -> Tuple[List[Tuple[int, int, int]],
                                 Tuple[int, int, int]]:
    """Every (block_m, block_n, block_k) tile ``kernel`` takes in ``fmt``
    and ``dtype``, and the default (always a member)."""
    shapes = _gg.tile_shapes(kernel, fmt, dtype)
    cands = [(tr, bn, BLOCK_K) for tr, bn in shapes]
    return cands, cands[0]


def bench(fns: Sequence, *, device="cuda",
          reps: int = 3) -> List[List[float]]:
    """Seconds per call of each of ``fns`` in each of ``reps`` rounds (each
    fn timed once a round, in turns); the statistic is the minimum.  CUDA:
    each fn's calls captured ``PER_GRAPH`` to a CUDA graph and replayed
    ``REPLAYS`` times between CUDA events (device time; the host's cost per
    call drops out).  CPU: one call between ``time.perf_counter``
    readings."""
    times = [[] for _ in fns]
    if torch.device(device).type != "cuda":
        for f in fns:
            f()                                   # warm
        for _ in range(reps):
            for i, f in enumerate(fns):
                t0 = time.perf_counter()
                f()
                times[i].append(time.perf_counter() - t0)
        return times
    graphs = []
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for f in fns:
            for _ in range(3):
                f()
    torch.cuda.current_stream().wait_stream(stream)
    for f in fns:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(PER_GRAPH):
                f()
        g.replay()
        graphs.append(g)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(reps):
        for i, g in enumerate(graphs):
            start.record()
            for _ in range(REPLAYS):
                g.replay()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end) * 1e-3
                            / (REPLAYS * PER_GRAPH))
    del graphs
    torch.cuda.empty_cache()
    return times


def _timed(samples: List[float]) -> dict:
    """``us`` (the minimum) and ``spread`` ((max - min) / min) of one
    candidate's rounds."""
    lo = min(samples)
    return {"us": lo * 1e6, "spread": (max(samples) - lo) / lo}


def routing(E: int, top_k: int, tokens: int, seed: int):
    """Seeded uniform routing: (T, k) int32 distinct experts per token and
    (T, k) float32 combine weights summing to 1 per token."""
    rng = np.random.default_rng(seed)
    idx = np.argsort(rng.random((tokens, E)), axis=1)[:, :top_k]
    w = rng.random((tokens, top_k)).astype(np.float32) + 0.1
    return idx.astype(np.int32), w / w.sum(axis=1, keepdims=True)


def sweep_schedule(E: int, top_k: int, tokens: int, *, block_m: int = 128,
                   policy: str = "fixed", block_m_min: int = 8, seed: int = 0,
                   device="cuda"):
    """(schedule, combine rows) of the seeded routing under ``policy``
    (``block_m_min`` the dynamic floor; ``capacity_factor`` at its default
    2.0): the schedule a real call at ``tokens`` tokens gets."""
    idx, w = routing(E, top_k, tokens, seed)
    dev = torch.device(device)
    kw = policy_config_kwargs(policy, SimpleNamespace(
        block_m_min=block_m_min, capacity_factor=2.0))
    sched = build_schedule(torch.as_tensor(idx, device=dev), E, block_m,
                           policy=policy, **kw)
    return sched, combine_scale_rows(sched, torch.as_tensor(w, device=dev))


def _weights(E: int, K: int, N: int, fmt: str, dtype, gen, device):
    """(payload (E, K, N) or (E, K/2, N), (E, N) f32 scales or None)."""
    if fmt == "dense":
        return (torch.randn((E, K, N), generator=gen, device=device,
                            dtype=torch.float32).to(dtype), None)
    rows = K // 2 if fmt == "int4" else K
    q = torch.randint(-128, 128, (E, rows, N), generator=gen, device=device,
                      dtype=torch.int32).to(torch.int8)
    s = torch.rand((E, N), generator=gen, device=device) * 0.01 + 0.005
    return q, s


def _operands(kernel: str, sched, E: int, K: int, N: int, fmt: str, dtype,
              seed: int, device):
    """x (capacity, K) and the weight operands of ``kernel`` at ``sched``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((sched.capacity, K), generator=gen, device=device,
                    dtype=torch.float32).to(dtype)
    ws = [_weights(E, K, N, fmt, dtype, gen, device)
          for _ in range(2 if kernel == "fused_gate_up" else 1)]
    return x, ws


def _call(kernel: str, x, ws, sched, fmt: str, row_scale, tile):
    """One call of ``kernel`` at tile shape ``tile`` (tile_rows, block_n)."""
    if kernel == "grouped_gemm":
        (w, s), = ws
        return _gg.grouped_gemm(
            x, w, sched.block_expert, sched.block_active,
            block_m=sched.block_m, row_scale=row_scale, w_scale=s,
            w_format=fmt, seg_start=sched.seg_start, tile_rows=tile[0],
            block_n=tile[1])
    (wg, sg), (wu, su) = ws
    return _fgu.fused_gate_up(
        x, wg, wu, sched.block_expert, sched.block_active,
        block_m=sched.block_m, wg_scale=sg, wu_scale=su, w_format=fmt,
        seg_start=sched.seg_start, tile_rows=tile[0], block_n=tile[1])


def sweep_kernel(kernel: str, *, E: int, top_k: int, tokens: int, K: int,
                 N: int, scheme: str = "dense", dtype=torch.bfloat16,
                 policy: str = "fixed", block_m: int = 128, reps: int = 3,
                 seed: int = 0, device="cuda") -> dict:
    """Time every tile of ``kernel`` at the shape key of ``tokens`` routed
    tokens (M = tokens * top_k).  Returns ``{"key", "kernel", "shape",
    "records", "winner", "default"}``; each record carries (block_m,
    block_n, block_k, us, tok_per_s, is_default) and whether its output is
    bitwise the default tile's (``bitwise``, ``max_abs_diff``).  fp32:
    one record, the default, untimed, and a ``note``."""
    if kernel not in KERNELS:
        raise ValueError(f"only {KERNELS} take a tile shape, not {kernel!r}")
    dev = torch.device(device)
    cands, default = candidate_configs(kernel, scheme, dtype)
    dt = dtype_name(dtype)
    M = tokens * top_k
    out = {"key": make_key(kernel, M=M, K=K, N=N, E=E, dtype=dt,
                           scheme=scheme),
           "kernel": kernel, "executor": "cuda",
           "shape": {"E": E, "M": M, "K": K, "N": N, "T": tokens,
                     "top_k": top_k, "dtype": dt, "scheme": scheme,
                     "policy": policy, "schedule_block_m": block_m}}
    if len(cands) == 1:
        rec = {"block_m": default[0], "block_n": default[1],
               "block_k": default[2], "us": None, "spread": None,
               "tok_per_s": None,
               "is_default": True, "bitwise": True, "max_abs_diff": 0.0}
        out.update(records=[rec], winner=rec, default=rec,
                   note=f"{dt} runs one tile (csrc/grouped_gemm.cuh): the "
                        "default is the only candidate; not timed")
        return out
    sched, rows = sweep_schedule(E, top_k, tokens, block_m=block_m,
                                 policy=policy, seed=seed, device=dev)
    x, ws = _operands(kernel, sched, E, K, N, scheme, dtype, seed + 1, dev)
    row_scale = rows if kernel == "grouped_gemm" else None
    fns = [lambda t=(bm, bn): _call(kernel, x, ws, sched, scheme, row_scale,
                                    t)
           for bm, bn, _ in cands]
    ref = fns[0]()
    diffs = []
    for f in fns:
        y = f()
        diffs.append((bool(torch.equal(y, ref)),
                      float((y.float() - ref.float()).abs().max())
                      if y.numel() else 0.0))
    samples = bench(fns, device=dev, reps=reps)
    records = [{"block_m": bm, "block_n": bn, "block_k": bk, **_timed(s),
                "tok_per_s": tokens / min(s),
                "is_default": (bm, bn, bk) == default,
                "bitwise": eq, "max_abs_diff": d}
               for (bm, bn, bk), s, (eq, d) in zip(cands, samples, diffs)]
    out.update(records=records,
               winner=min(records, key=lambda r: r["us"]),
               default=next(r for r in records if r["is_default"]))
    return out


# candidate sub-block floors for the dynamic schedule policy sweep
SUB_BLOCK_FLOORS = (8, 16, 32, 64)


def sweep_sub_block(*, E: int, top_k: int, d_model: int, d_ffn: int,
                    block_m: int, tokens: int = 256, dtype=torch.bfloat16,
                    reps: int = 3, seed: int = 0,
                    floors: Sequence[int] = SUB_BLOCK_FLOORS,
                    device="cuda") -> dict:
    """Sweep the dynamic policy's sub-block floor (``block_m_min``) for one
    routing shape.  On the Hopper kernels the floor sets how many rows each
    light expert's run pads to (its sub-block ``q = sub_block(block_m,
    floor)``), not a grid: so each distinct q times the layer's two GEMMs,
    B2 (x @ gate, up) then B1 (h @ down, with the combine rows), each with
    its work-list build, on the ``dynamic`` schedule built at that floor.
    The default floor 8 is always a candidate.  The winner goes under the
    reference's ``sub_block`` key (``K`` = block_m, ``N`` = 0), which
    ``plan_schedule`` reads under ``autotune=True``."""
    dev = torch.device(device)
    qs = {}
    for floor in sorted(set(floors) | {8}):
        if floor <= block_m:
            qs.setdefault(sub_block(block_m, floor), floor)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    wg, wu, wd = (_weights(E, k, n, "dense", dtype, gen, dev)
                  for k, n in ((d_model, d_ffn), (d_model, d_ffn),
                               (d_ffn, d_model)))
    fns, cands = [], []
    for q, floor in sorted(qs.items()):
        sched, rows = sweep_schedule(E, top_k, tokens, block_m=block_m,
                                     policy="dynamic", block_m_min=floor,
                                     seed=seed, device=dev)
        x = torch.randn((sched.capacity, d_model), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            seed + 1)).to(dtype)

        def layer(x=x, sched=sched, rows=rows):
            h = _call("fused_gate_up", x, [wg, wu], sched, "dense", None,
                      (None, None))
            return _call("grouped_gemm", h, [wd], sched, "dense", rows,
                         (None, None))
        fns.append(layer)
        cands.append((q, floor))
    samples = bench(fns, device=dev, reps=reps)
    M = tokens * top_k
    records = [{"block_m_min": floor, "sub_block": q, **_timed(s),
                "tok_per_s": tokens / min(s), "is_default": floor == 8}
               for (q, floor), s in zip(cands, samples)]
    dt = dtype_name(dtype)
    return {"key": make_key("sub_block", M=M, K=block_m, N=0, E=E,
                            dtype=dt),
            "kernel": "sub_block", "executor": "cuda",
            "shape": {"E": E, "M": M, "K": d_ffn, "N": d_model, "T": tokens,
                      "dtype": dt, "block_m": block_m},
            "records": records,
            "winner": min(records, key=lambda r: r["us"]),
            "default": next(r for r in records if r["is_default"])}


# kernel -> (K, N) as a function of (d_model, d_ffn): the two grouped GEMM
# shapes one MoE layer issues (the unfused form's gate and up products
# share fused_gate_up's geometry)
LAYER_SHAPES = {
    "fused_gate_up": lambda d, f: (d, f),       # (E, d, f) x2 -> silu*up
    "grouped_gemm": lambda d, f: (f, d),        # down: (E, f, d)
}


def tune_moe_layer(*, E: int, top_k: int, d_model: int, d_ffn: int,
                   tokens: int = 256, scheme: str = "dense",
                   dtype=torch.bfloat16, reps: int = 3,
                   cache: Optional[TuneCache] = None, seed: int = 0,
                   policy: str = "fixed", schedule_block_m: int = 128,
                   block_m: Optional[int] = None,
                   device="cuda") -> List[dict]:
    """Sweep every GEMM shape one MoE layer dispatches at ``tokens``
    routed tokens, on ``policy``'s schedule of ``schedule_block_m``-row
    blocks, recording the timed winners into ``cache`` when given.  With
    ``block_m`` set, also sweep the dynamic policy's sub-block floor at
    this routing shape (the ``sub_block`` key)."""
    out = []
    for kernel, shape_fn in LAYER_SHAPES.items():
        K, N = shape_fn(d_model, d_ffn)
        res = sweep_kernel(kernel, E=E, top_k=top_k, tokens=tokens, K=K,
                           N=N, scheme=scheme, dtype=dtype, policy=policy,
                           block_m=schedule_block_m, reps=reps, seed=seed,
                           device=device)
        win = res["winner"]
        if cache is not None and win["us"] is not None:
            cache.put(res["key"], block_m=win["block_m"],
                      block_n=win["block_n"], block_k=win["block_k"],
                      us=win["us"], default_us=res["default"]["us"],
                      spread=max(win["spread"], res["default"]["spread"]))
        out.append(res)
    if block_m is not None:
        res = sweep_sub_block(E=E, top_k=top_k, d_model=d_model,
                              d_ffn=d_ffn, block_m=block_m, tokens=tokens,
                              dtype=dtype, reps=reps, seed=seed,
                              device=device)
        if cache is not None:
            win = res["winner"]
            cache.put(res["key"], block_m=win["sub_block"], block_n=0,
                      block_k=0, us=win["us"],
                      default_us=res["default"]["us"],
                      spread=max(win["spread"], res["default"]["spread"]),
                      block_m_min=win["block_m_min"])
        out.append(res)
    return out
