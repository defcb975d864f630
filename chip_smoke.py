"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--layers N]

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. device: CUDA must be present; prints the card's name and power limit;
2. build: compiles the five MoE kernels from src/repro_torch/csrc with nvcc
   for sm_90a (into build/kernels/) and prints the build time;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   bf16 and fp32, at moonshot-v1-16b-a3b's full width (decode T=2 and T=4,
   prefill T=64) and mixtral-8x7b's (T=512): router indices and permute
   exactly equal, GEMMs and unpermute within fp32 1e-4 / bf16 2e-2, rows of
   inactive blocks exactly zero and no NaN (the allocator is poisoned with
   NaN just before each call); then times each kernel, its plain version
   and a one-call PyTorch yardstick where one exists, at the serving
   shapes: device time from CUDA-graph replays between CUDA events, and the
   eager per-call time beside it;
4. MoE layer: ``moe_ffn`` on the ``cuda`` executor at moonshot width under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync in the layer);
5. serving: moonshot-v1-16b-a3b at full width, depth cut to 4 layers (1
   dense + 3 MoE; ``--layers 48`` serves the whole depth), random bf16
   weights from a seeded generator; 4 requests of 16-64 prompt tokens, 16
   new tokens each, on 2 slots, after one warm-up request.  Every kernel's
   launch count over the run must equal MoE layers x forwards, and the first
   prompt's prefill logits (through the first 4 layers) must match the
   same forward through the plain versions on the card.  Then two prefills and five decode steps run under
   torch.profiler: wall time, device busy share, top kernels and host ops.

The last lines are the kernel report ``{"kernels": [...]}``, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""
import copy
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12           # dense bf16 tensor-core peak
MOONSHOT = dict(E=64, k=6, d=2048, f=1408, M=128, gating="sigmoid",
                norm_topk=True, routed_scale=2.446)
MIXTRAL = dict(E=8, k=2, d=4096, f=14336, M=128, gating="softmax",
               norm_topk=False, routed_scale=1.0)
SERVE_SLOTS, SERVE_REQUESTS, SERVE_MAX_NEW = 2, 4, 16
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
LOGIT_TOL = dict(rtol=5e-2, atol=5e-2)   # bf16 through CHECK_LAYERS layers
CHECK_LAYERS = 4
SOURCES = {
    "router_topk": ("src/repro_torch/csrc/router_topk.cu",
                    "src/repro/kernels/router_topk.py:60"),
    "permute": ("src/repro_torch/csrc/permute.cu",
                "src/repro/kernels/permute.py:30"),
    "fused_gate_up": ("src/repro_torch/csrc/fused_gate_up.cu",
                      "src/repro/kernels/fused_gate_up.py:73"),
    "grouped_gemm": ("src/repro_torch/csrc/grouped_gemm.cu",
                     "src/repro/kernels/grouped_gemm.py:83"),
    "unpermute": ("src/repro_torch/csrc/unpermute.cu",
                  "src/repro/kernels/unpermute.py:45"),
}


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(code)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` over ``iters`` eager calls (CUDA events, after 3
    warm-up calls).  Where the device finishes before the host has issued
    the next call, this is the host's time per call."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, per_graph: int, replays: int = 10) -> float:
    """Mean device time of ``fn``: ``per_graph`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    per-call cost drops out."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * per_graph)
    del graph
    torch.cuda.empty_cache()
    return ms


def poisoned(fn, numel: int, dtype):
    """Run ``fn`` right after filling and freeing a buffer of the output's
    size with NaN, so that an output the kernel fails to write shows up."""
    import torch
    junk = torch.empty(numel, dtype=dtype, device="cuda")
    junk.fill_(float("nan"))
    del junk
    return fn()


def profile_window(fn, top: int = 8) -> dict:
    """Host wall time of ``fn`` (ending in a synchronise) under
    torch.profiler, the device's busy time in it (sum of kernel self
    times), and the top entries by device and by host self time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) / 1e3

    device_ms = sum(dev(e) for e in avgs)
    by_dev = sorted(avgs, key=dev, reverse=True)[:top]
    by_cpu = sorted(avgs, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:top]
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "busy_share": device_ms / (wall * 1e3),
            "top_device": [(e.key[:90], e.count, dev(e)) for e in by_dev],
            "top_cpu": [(e.key[:90], e.count, e.self_cpu_time_total / 1e3)
                        for e in by_cpu]}


def bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Case:
    """One layer's inputs at one shape and dtype, and its schedule."""

    def __init__(self, shape: dict, T: int, dtype, seed: int):
        import torch
        from repro_torch.kernels import ref
        from repro_torch.scheduling import build_fixed_schedule
        from repro_torch.execution import combine_scale_rows
        g = torch.Generator(device="cuda").manual_seed(seed)
        E, d, f = shape["E"], shape["d"], shape["f"]
        self.shape, self.T, self.dtype = shape, T, dtype
        self.route_kw = dict(gating=shape["gating"],
                             norm_topk=shape["norm_topk"],
                             routed_scale=shape["routed_scale"])

        def randn(*s, scale=1.0):
            return (torch.randn(s, generator=g, device="cuda") * scale
                    ).to(dtype)
        self.logits = torch.randn((T, E), generator=g, device="cuda")
        self.x = randn(T, d)
        self.wg = randn(E, d, f, scale=d ** -0.5)
        self.wu = randn(E, d, f, scale=d ** -0.5)
        self.wd = randn(E, f, d, scale=f ** -0.5)
        self.w, self.idx = ref.router_ref(self.logits, shape["k"],
                                          **self.route_kw)
        self.sched = build_fixed_schedule(self.idx, E, shape["M"])
        self.scale = combine_scale_rows(self.sched, self.w)
        self.xp = ref.permute_ref(self.x, self.sched)
        self.h = ref.fused_gate_up_ref(self.xp, self.wg, self.wu, self.sched)
        self.y = ref.grouped_gemm_ref(self.h, self.wd, self.sched,
                                      self.scale)
        active = self.sched.block_active.bool().cpu()
        self.inactive_rows = (~active).repeat_interleave(shape["M"]).cuda()
        self.n_active_blocks = int(active.sum())
        self.n_experts_used = int((self.sched.counts > 0).sum())

    def label(self) -> str:
        dt = str(self.dtype).replace("torch.", "")
        return f"E={self.shape['E']} d={self.shape['d']} T={self.T} {dt}"

    # -- work each function must do (data-dependent: this routing) --------
    def work(self, name: str):
        """(bytes, flops): each input read once, each output written once;
        the GEMMs read only the experts this routing uses and compute only
        the active blocks' rows."""
        s, T = self.shape, self.T
        E, k, d, f, M = s["E"], s["k"], s["d"], s["f"], s["M"]
        es = self.x.element_size()
        cap = self.sched.capacity
        rows = self.n_active_blocks * M
        used = self.n_experts_used
        nb = cap // M
        if name == "router_topk":
            return T * E * 4 + T * k * 8, T * E * (k + 4)
        if name == "permute":
            return T * d * es + cap * 4 + cap * d * es, 0
        if name == "fused_gate_up":
            return (rows * d * es + 2 * used * d * f * es + nb * 8
                    + cap * f * es, 2 * 2 * rows * d * f)
        if name == "grouped_gemm":
            return (rows * f * es + used * f * d * es + nb * 8 + cap * 4
                    + cap * d * es, 2 * rows * f * d)
        if name == "unpermute":
            return T * k * d * es + T * k * 4 + T * d * es, T * k * d
        raise KeyError(name)


def kernel_calls(c: Case):
    """name -> (kernel call, plain call, output numel, output dtype)."""
    import torch
    from repro_torch.kernels import ops, ref
    s, sched = c.shape, c.sched
    return {
        "router_topk": (
            lambda: ops.router_topk(c.logits, top_k=s["k"], **c.route_kw),
            lambda: ref.router_ref(c.logits, s["k"], **c.route_kw),
            c.T * s["k"], torch.float32),
        "permute": (lambda: ops.permute(c.x, sched),
                    lambda: ref.permute_ref(c.x, sched),
                    sched.capacity * s["d"], c.dtype),
        "fused_gate_up": (
            lambda: ops.fused_gate_up(c.xp, c.wg, c.wu, sched),
            lambda: ref.fused_gate_up_ref(c.xp, c.wg, c.wu, sched),
            sched.capacity * s["f"], c.dtype),
        "grouped_gemm": (
            lambda: ops.grouped_gemm(c.h, c.wd, sched, row_scale=c.scale),
            lambda: ref.grouped_gemm_ref(c.h, c.wd, sched, c.scale),
            sched.capacity * s["d"], c.dtype),
        "unpermute": (lambda: ops.unpermute(c.y, sched, None),
                      lambda: ref.unpermute_ref(c.y, sched, None),
                      c.T * s["d"], c.dtype),
    }


def library_call(name: str, c: Case):
    """One PyTorch call computing the same function, or (None, reason)."""
    import torch
    if name == "unpermute":
        # scatter-add of the padded rows back to their tokens; padding rows
        # are zero, so clamping their -1 source to row 0 adds nothing
        src = torch.clamp(c.sched.src_tok, min=0).long()
        out = torch.zeros((c.T, c.shape["d"]), dtype=c.dtype, device="cuda")
        return (lambda: out.index_add_(0, src, c.y)), "index_add_"
    if name == "grouped_gemm" and c.dtype == torch.bfloat16 \
            and hasattr(torch, "_grouped_mm"):
        offs = c.sched.group_offsets[1:].contiguous()

        def call():
            return torch._grouped_mm(c.h, c.wd, offs=offs)
        try:
            call()
            torch.cuda.synchronize()
        except (RuntimeError, TypeError, ValueError) as e:
            return None, f"torch._grouped_mm refused: {str(e)[:80]}"
        return call, "torch._grouped_mm (no row_scale epilogue)"
    reasons = {
        "router_topk": "no single PyTorch call gates, selects by iterative "
                       "argmax and renormalises",
        "permute": "no single PyTorch call gathers rows and zero-fills -1",
        "fused_gate_up": "no single PyTorch call fuses two grouped products "
                         "with a SiLU product",
        "grouped_gemm": "torch._grouped_mm absent or not bf16",
    }
    return None, reasons[name]


def check_case(c: Case, errs: dict) -> None:
    """Every kernel against its plain version on this case's inputs."""
    import torch
    tol = TOL[str(c.dtype).replace("torch.", "")]
    for name, (kern, plain, numel, odt) in kernel_calls(c).items():
        got = poisoned(kern, numel, odt)
        want = plain()
        torch.cuda.synchronize()
        if name == "router_topk":
            (w, i), (w_p, i_p) = got, want
            if not torch.equal(i, i_p):
                raise AssertionError(f"router indices differ ({c.label()})")
            torch.testing.assert_close(w, w_p, rtol=1e-5, atol=1e-6)
            err = (w - w_p).abs().max().item()
        else:
            if torch.isnan(got).any():
                raise AssertionError(f"{name}: NaN in output ({c.label()})")
            if name == "permute" and not torch.equal(got, want):
                raise AssertionError(f"permute not bitwise ({c.label()})")
            if name in ("permute", "fused_gate_up", "grouped_gemm"):
                dead = got[c.inactive_rows]
                if dead.numel() and not torch.equal(dead,
                                                    torch.zeros_like(dead)):
                    raise AssertionError(
                        f"{name}: inactive rows not zero ({c.label()})")
            torch.testing.assert_close(got.float(), want.float(), **tol)
            err = (got.float() - want.float()).abs().max().item()
        errs[name] = max(errs.get(name, 0.0), err)
        print(f"  {name:14s} {c.label():28s} max_abs_err {err:.3e}")


def time_case(c: Case) -> dict:
    """Kernel, plain and library times with the bound, per kernel."""
    import torch
    out = {}
    for name, (kern, plain, _, _) in kernel_calls(c).items():
        gemm = name in ("fused_gate_up", "grouped_gemm")
        n = 10 if gemm else 50
        n_bytes, flops = c.work(name)
        b_ms, b_by = bound_ms(n_bytes, flops)
        lib, lib_name = library_call(name, c)
        out[name] = {
            "ms": device_ms(kern, n),
            "eager_ms": time_ms(kern, 5 * n),
            "plain_ms": device_ms(plain, 3 if gemm else 10),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": device_ms(lib, n) if lib is not None else None,
            "library": lib_name if lib is not None else None,
            "library_null_reason": None if lib is not None else lib_name,
            "bytes": n_bytes, "flops": flops,
        }
        torch.cuda.synchronize()
    return out


def padding_share(c: Case) -> dict:
    """Bytes the fixed schedule makes permute / fused_gate_up /
    grouped_gemm write per layer-step, and how many are padding rows."""
    s, es = c.shape, c.x.element_size()
    cap, useful = c.sched.capacity, c.T * s["k"]
    written = {"permute": cap * s["d"] * es, "fused_gate_up": cap * s["f"] * es,
               "grouped_gemm": cap * s["d"] * es}
    pad = {k: v * (cap - useful) / cap for k, v in written.items()}
    return {"T": c.T, "capacity": cap, "blocks": cap // s["M"],
            "active_blocks": c.n_active_blocks,
            "written_MB": {k: v / 1e6 for k, v in written.items()},
            "padding_MB": {k: v / 1e6 for k, v in pad.items()},
            "padding_share": (cap - useful) / cap,
            "expert_weight_MB_read": c.n_experts_used * 3 * s["d"] * s["f"]
            * es / 1e6}


def register_plain_executor():
    """An executor made of the plain versions, for holding the served
    forward against them on the card (this script's own; the port's main
    path never routes to it)."""
    from repro_torch.execution import Executor, register_executor
    from repro_torch.kernels import ref

    class PlainExecutor(Executor):
        def route(self, logits, cfg):
            return ref.router_ref(logits, cfg.top_k, gating=cfg.gating,
                                  norm_topk=cfg.norm_topk,
                                  routed_scale=cfg.routed_scale)

        def permute(self, x, sched, cfg):
            return ref.permute_ref(x, sched)

        def expert_ffn(self, xp, w, sched, cfg, row_scale=None):
            h = ref.fused_gate_up_ref(xp, w["w_gate"], w["w_up"], sched)
            return ref.grouped_gemm_ref(h, w["w_down"], sched, row_scale)

        def unpermute(self, y, sched, weights, cfg):
            return ref.unpermute_ref(y, sched, weights)

    register_executor("plain")(PlainExecutor)


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4,
                    help="served depth (1 dense + layers-1 MoE); default 4")
    layers = ap.parse_args().layers
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail("src/repro_torch is not beside this script: run it from a "
             "checkout of the repository", code=2)
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script runs on the GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device ------------------------------------------------------------
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(smi)

    # 2. build -------------------------------------------------------------
    from repro_torch.kernels import _build, ops
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc, sm_90a) into {_build.BUILD_DIR.relative_to(ROOT)}")
    entry = None
    for line in _build.build_log.splitlines():      # ptxas -v, per kernel
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line and entry is not None:
            print(f"  ptxas {entry[:64]}: {line.split(':', 1)[1].strip()}")
            entry = None

    # 3. kernels against plain versions, then times ---------------------------
    print("[kernels] CUDA kernel vs plain PyTorch version on the card")
    errs: dict = {}
    timings = {}
    padding = []
    for shape, Ts in ((MOONSHOT, (2, 4, 64)), (MIXTRAL, (512,))):
        for dtype in (torch.bfloat16, torch.float32):
            for T in Ts:
                c = Case(shape, T, dtype, seed=T)
                check_case(c, errs)
                if shape is MOONSHOT and dtype == torch.bfloat16:
                    if T in (SERVE_SLOTS, 64):
                        timings[T] = time_case(c)
                    if T in (2, 4):
                        padding.append(padding_share(c))
                del c
                torch.cuda.empty_cache()
    for p in padding:
        print(f"[padding] moonshot bf16 decode T={p['T']}: capacity "
              f"{p['capacity']} rows ({p['blocks']} blocks, "
              f"{p['active_blocks']} active); written MB "
              f"{json.dumps(p['written_MB'])}, of which padding MB "
              f"{json.dumps(p['padding_MB'])} (share "
              f"{p['padding_share']:.4f}); expert weights read "
              f"{p['expert_weight_MB_read']:.1f} MB")

    # 4. MoE layer without a host sync -----------------------------------
    from repro_torch.core.dispatch import MoEDispatchConfig, moe_ffn
    register_plain_executor()
    for T in (4, 64):
        c = Case(MOONSHOT, T, torch.bfloat16, seed=100 + T)
        router = torch.randn((MOONSHOT["d"], MOONSHOT["E"]), device="cuda")
        kw = dict(n_experts=MOONSHOT["E"], top_k=MOONSHOT["k"],
                  block_m=MOONSHOT["M"], gating=MOONSHOT["gating"],
                  norm_topk=True, routed_scale=MOONSHOT["routed_scale"])
        cfg = MoEDispatchConfig(executor="cuda", **kw)
        moe_ffn(c.x, router, c.wg, c.wu, c.wd, cfg)     # warm
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, _ = moe_ffn(c.x, router, c.wg, c.wu, c.wd, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        y_p, _ = moe_ffn(c.x, router, c.wg, c.wu, c.wd,
                         cfg._replace(executor="plain"))
        torch.testing.assert_close(y.float(), y_p.float(), **TOL["bfloat16"])
        print(f"[moe_ffn] moonshot T={T} bf16: no host sync under "
              f"set_sync_debug_mode('error'); max_abs_err vs plain "
              f"{(y.float() - y_p.float()).abs().max().item():.3e}")
        del c
    torch.cuda.empty_cache()

    # 5. serving ---------------------------------------------------------
    from repro_torch.configs import get_config
    from repro_torch.models.lm import (RunConfig, forward, init_params,
                                       n_moe_layers)
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config("moonshot-v1-16b-a3b")
    cfg = cfg.replace(n_layers=layers)
    print(f"[serve] {cfg.name} at full width (d_model={cfg.d_model}, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, "
          f"d_ff_expert={cfg.moe.d_ff_expert}, vocab={cfg.vocab_size}); "
          f"reduced: n_layers 48 -> {layers} (1 dense + "
          f"{n_moe_layers(cfg)} MoE); random bf16 weights, seed 0")
    t0 = time.perf_counter()
    model = init_params(cfg, 0, param_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serve] {n_params / 1e9:.3f} B parameters "
          f"({n_params * 2 / 1e9:.2f} GB bf16) initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, int(rng.integers(16, 65))).astype(np.int32),
                    max_new=SERVE_MAX_NEW) for i in range(SERVE_REQUESTS)]
    capacity = max(len(r.prompt) for r in reqs) + SERVE_MAX_NEW + 1
    rc = RunConfig(compute_dtype=torch.bfloat16)
    engine = ServeEngine(cfg, model, slots=SERVE_SLOTS, capacity=capacity,
                         rc=rc)
    # warm-up request: first-use costs (module loading, library handles)
    # stay out of the measured run
    engine.run([Request(rid=-1, prompt=rng.integers(
        0, cfg.vocab_size, 32).astype(np.int32), max_new=3)])
    forwards0 = engine.n_forwards
    pending = list(reqs)
    prefill_s, decode_s, decode_tokens = [], [], 0
    torch.cuda.synchronize()
    ops.reset_launches()
    t_run = time.perf_counter()
    while pending or engine.n_active:
        while pending and engine.n_active < engine.slots:
            t0 = time.perf_counter()
            engine.admit(pending.pop(0))     # ends in the host transfer
            prefill_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        decode_tokens += engine.step()       # ends in the host transfer
        decode_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t_run
    launches = dict(ops.LAUNCHES)
    forwards = engine.n_forwards - forwards0
    expect = n_moe_layers(cfg) * forwards
    print(f"[serve] {forwards} forwards ({len(prefill_s)} prefills, "
          f"{len(decode_s)} decode steps) in {t_run:.3f} s; launches "
          f"{json.dumps(launches)}; expected {expect} each")
    for name, n in launches.items():
        if n != expect:
            raise AssertionError(f"{name}: {n} launches, expected {expect}")
    for r in reqs:
        if not r.done or len(r.out) != SERVE_MAX_NEW \
                or not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"request {r.rid} incomplete: {r.out}")
        print(f"  req {r.rid}: {len(r.prompt)} prompt tokens -> {r.out}")
    prefill_ms = 1e3 * sum(prefill_s) / len(prefill_s)
    decode_ms = 1e3 * sum(decode_s) / len(decode_s)
    decode_p50 = 1e3 * float(np.median(decode_s))
    tok_s = decode_tokens / sum(decode_s)
    print(f"[serve] prefill {prefill_ms:.2f} ms per request (mean of "
          f"{len(prefill_s)}, prompts 16-64 tokens); decode "
          f"{decode_ms:.2f} ms per step (mean of {len(decode_s)}, median "
          f"{decode_p50:.2f}, <= {SERVE_SLOTS} slots); {tok_s:.1f} decode "
          f"tokens/s (host clock, each step ends in its host transfer)")

    # the first prompt's prefill logits through the kernels and through the
    # plain versions, over the first CHECK_LAYERS layers (the same weights)
    # and the head: deeper random-weight stacks amplify bf16 rounding into
    # different top-k picks, so the check stops at the default depth
    first = torch.as_tensor(reqs[0].prompt.astype(np.int64),
                            device="cuda")[None]
    n_check = min(layers, CHECK_LAYERS)
    head = copy.copy(model)
    head._modules = dict(model._modules)          # not shared with model
    head.layers = torch.nn.ModuleList(model.layers[:n_check])
    cfg_check = cfg.replace(n_layers=n_check)
    logits, _, _ = forward(head, cfg_check, rc, {"tokens": first},
                           mode="prefill")
    logits_p, _, _ = forward(head, cfg_check, rc._replace(executor="plain"),
                             {"tokens": first}, mode="prefill")
    torch.cuda.synchronize()
    torch.testing.assert_close(logits, logits_p, **LOGIT_TOL)
    print(f"[serve] first prefill logits ({n_check} layers) vs plain "
          f"versions on the card: max_abs_err "
          f"{(logits - logits_p).abs().max().item():.3e} (|logits| max "
          f"{logits_p.abs().max().item():.2f}; tolerance rtol=atol=5e-2); "
          f"argmax equal: "
          f"{bool((logits.argmax(-1) == logits_p.argmax(-1)).all())}")
    print(json.dumps({"serve": {
        "layers": layers, "slots": SERVE_SLOTS,
        "requests": SERVE_REQUESTS, "max_new": SERVE_MAX_NEW,
        "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "decode_ms_per_step_p50": decode_p50,
        "decode_tokens_per_s": tok_s, "forwards": forwards}}))

    # where the time goes: two prefills, then five decode steps, profiled
    extra = [Request(rid=100 + i, prompt=rng.integers(
        0, cfg.vocab_size, 48).astype(np.int32), max_new=16)
        for i in range(SERVE_SLOTS)]
    prof_prefill = profile_window(
        lambda: [engine.admit(r) for r in extra])
    prof_decode = profile_window(
        lambda: [engine.step() for _ in range(5)])
    for label, p in (("prefill x2, 48 tokens", prof_prefill),
                     ("decode x5, 2 slots", prof_decode)):
        print(f"[profile] {label}: wall {p['wall_ms']:.2f} ms, device busy "
              f"{p['device_ms']:.2f} ms (share {p['busy_share']:.3f})")
        for name, calls, ms in p["top_device"]:
            print(f"    device {ms:9.3f} ms {calls:5d}x  {name[:70]}")
        for name, calls, ms in p["top_cpu"]:
            print(f"    host   {ms:9.3f} ms {calls:5d}x  {name[:70]}")
    print(json.dumps({"profile": {"prefill": prof_prefill,
                                  "decode": prof_decode}}))
    del model, engine
    torch.cuda.empty_cache()

    # 6. report ------------------------------------------------------------
    report = []
    for name, (source, replaces) in SOURCES.items():
        d, p = timings[SERVE_SLOTS][name], timings[64][name]
        report.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": d["ms"],
            "eager_ms": d["eager_ms"],
            "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": d["library_ms"],
            "library": d["library"],
            "library_null_reason": d["library_null_reason"],
            "shape": f"moonshot-v1-16b-a3b bf16 decode T={SERVE_SLOTS}",
            "prefill_T64": {k: p[k] for k in ("ms", "eager_ms", "plain_ms",
                                              "bound_ms", "bound_by",
                                              "library_ms")},
        })
    print(json.dumps({"kernels": report}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
