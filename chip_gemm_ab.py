"""A/B of the grouped-GEMM kernels (B1 and B2), and of the router (B5)
and the combine (B4), of this checkout against those of another source
tree, on one NVIDIA GPU.

    python3 chip_gemm_ab.py --other DIR [--replays N] [--arms dense,quant,route]
        [--bf16-bitwise]

DIR is the root of another checkout whose ``src/repro_torch/csrc`` has the
weight-format C interface of the GEMMs (``moe_grouped_gemm`` and
``moe_fused_gate_up``, as since the int8 and int4 formats came in), with or
without the schedule's ``seg_start`` and the work lists' scratch, and with
or without the tile shape (``tile_rows``, ``block_n``; the other tree is
called at its default), each read from DIR's ``grouped_gemm.cu``, e.g. the
parent commit unpacked with ``git archive``.  Both trees' sources are
compiled with the same nvcc flags, and each tree's nvcc seconds (in all,
and per source: one process each, in parallel) are printed.  This tree
runs at its default tiles (``autotune`` off).

Arms.  ``dense``: moonshot-v1-16b-a3b's MoE layer (E=64, k=6, d=2048,
f=1408) at decode T=2 (dynamic and fixed), prefill T=64 (dynamic) and
training's T=4096 (both), on bf16 stacks.  ``quant``: the same layer's
stacks quantized under int8_expert, int8_channel and int4_packed at T=2
(dynamic and fixed) and T=64 (dynamic), and deepseek-v2-236b's (E=160,
k=6, d=5120, f=1536) under int8_expert at T=2 and T=64 (dynamic).  Each
runs ``fused_gate_up`` and ``grouped_gemm`` (with the folded combine rows)
of both trees in fp32 and bf16.  ``route``: ``router_topk`` at moonshot's,
deepseek-v2's, mixtral-8x7b's (E=8) and deepseek-v3's (E=256, k=8,
sigmoid) routers, on random rows and on rows ordered by (e % 32, e //
32), the most candidates of this tree's ranking, and ``unpermute`` (folded,
bf16 and fp32; weighted, bf16) at moonshot's and deepseek-v2's widths on
the ``dynamic`` schedule (of the random rows' picks), at T=2, 64 and 4096:
the router's indices must equal the other tree's and
the plain version's and its weights be within 1e-5 / 1e-6 of the plain
version's (the max difference from the other tree is printed);
``unpermute`` must be bitwise equal to the other tree's and to the plain
version.  Both are timed in turns as below.  fp32 (the CUDA-core kernels, every
format): the two trees must be bitwise equal.  bf16: each tree's kernel
may sum in its own order, so the script prints the max abs difference
between the trees and holds this tree within the bf16 tolerance of the
plain version; then it times both in turns (other, this, this, other):
device time per call from CUDA-graph replays between CUDA events.  Prints
one JSON line per shape and a last line ``{"ok": true, ...}``; exits
non-zero on an fp32 difference or a bf16 output out of tolerance, and with
``--bf16-bitwise`` on any bf16 difference between the trees (for a change
that leaves the default bf16 kernels' arithmetic as it was)."""
import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
MOONSHOT = dict(E=64, k=6, d=2048, f=1408, M=128, gating="sigmoid",
                norm_topk=True, routed_scale=2.446)
DEEPSEEK = dict(E=160, k=6, d=5120, f=1536, M=128, gating="softmax",
                norm_topk=False, routed_scale=16.0)
# (arch, scheme or None, policy, T) per arm
ARMS = {
    "dense": tuple(("moonshot", None, policy, T) for policy, T in (
        ("dynamic", 2), ("fixed", 2), ("dynamic", 64), ("fixed", 4096),
        ("dynamic", 4096))),
    "quant": tuple(("moonshot", scheme, policy, T)
                   for scheme in ("int8_expert", "int8_channel",
                                  "int4_packed")
                   for policy, T in (("dynamic", 2), ("fixed", 2),
                                     ("dynamic", 64)))
    + (("deepseek", "int8_expert", "dynamic", 2),
       ("deepseek", "int8_expert", "dynamic", 64)),
}
SHAPES = {"moonshot": MOONSHOT, "deepseek": DEEPSEEK}
# the route arm: routers and combine widths, at ROUTE_TS tokens
ROUTERS = {"moonshot": MOONSHOT, "deepseek": DEEPSEEK,
           "mixtral": dict(E=8, k=2, gating="softmax", norm_topk=False,
                           routed_scale=1.0),
           "deepseek-v3": dict(E=256, k=8, gating="sigmoid", norm_topk=True,
                               routed_scale=2.5)}
ROUTE_TS = (2, 64, 4096)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)     # chip_smoke.py's bf16 TOL
def build_other(csrc: pathlib.Path, flags):
    """Compile the other tree's kernels (one nvcc per source, in parallel)
    into a shared library under build/ab/ and load it; returns it, whether
    its GEMMs take seg_start and the work lists' scratch, whether they take
    a tile shape, and each source's nvcc seconds."""
    from repro_torch.kernels import _build
    nvcc = _build._nvcc()
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    seconds = {}
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs, objs = [], []
        t0 = time.perf_counter()
        for src in sorted(csrc.glob("*.cu")):
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            log = open(pathlib.Path(tmp) / (src.stem + ".log"), "w+")
            procs.append((src.name, log, subprocess.Popen(
                [nvcc, *flags, "-c", str(src), "-o", str(obj)],
                stdout=log, stderr=subprocess.STDOUT, text=True)))
        running = list(procs)
        while running:
            for item in list(running):
                if item[2].poll() is not None:
                    seconds[item[0]] = time.perf_counter() - t0
                    running.remove(item)
            time.sleep(0.05)
        for name, log, p in procs:
            log.seek(0)
            out = log.read()
            log.close()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on the other tree:\n{out}")
        lib_path = out_dir / "libmoe_kernels_other.so"
        subprocess.run([nvcc, "-shared", *map(str, objs), "-o",
                        str(lib_path)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    src = (csrc / "grouped_gemm.cu").read_text()
    src = src[src.index("MOE_API int moe_grouped_gemm("):]
    lists, tiles = "seg_start" in src, "tile_rows" in src
    if lists:
        extra = [I, I] if tiles else []
        lib.moe_grouped_gemm.argtypes = [P] * 9 + [I] * 9 + [P] + extra
        lib.moe_fused_gate_up.argtypes = [P] * 10 + [I] * 9 + [P] + extra
    else:
        lib.moe_grouped_gemm.argtypes = [P] * 7 + [I] * 8 + [P]
        lib.moe_fused_gate_up.argtypes = [P] * 8 + [I] * 8 + [P]
    F = ctypes.c_float
    lib.moe_router_topk.argtypes = [P, P, P] + [I] * 5 + [F, P]
    lib.moe_unpermute.argtypes = [P] * 4 + [I] * 4 + [P]
    for fn in (lib.moe_grouped_gemm, lib.moe_fused_gate_up,
               lib.moe_router_topk, lib.moe_unpermute):
        fn.restype = ctypes.c_int
    return lib, lists, tiles, seconds


def device_ms(fn, per_graph: int = 10, replays: int = 20) -> float:
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
    return start.elapsed_time(end) / (replays * per_graph)


def turns(a, b, replays: int) -> dict:
    """Device µs of a and b in turns: other, this, this, other."""
    t = [device_ms(f, replays=replays) for f in (a, b, b, a)]
    return {"other": [t[0] * 1e3, t[3] * 1e3],
            "this": [t[1] * 1e3, t[2] * 1e3]}


def route_ab(other, arch, s, kw, T, rows, logits, stream, smi, replays):
    """B5 of both trees on ``logits``: held and timed in turns, one JSON
    line; returns the plain version's (weights, indices)."""
    import torch
    from repro_torch.kernels import _build, ops, ref
    w_o = torch.empty((T, s["k"]), dtype=torch.float32, device="cuda")
    i_o = torch.empty((T, s["k"]), dtype=torch.int32, device="cuda")

    def other_route():
        _build.check(other.moe_router_topk(
            logits.data_ptr(), w_o.data_ptr(), i_o.data_ptr(), T, s["E"],
            s["k"], int(s["gating"] == "sigmoid"), int(s["norm_topk"]),
            float(s["routed_scale"]), stream()), "other router_topk")
        return w_o, i_o

    def this_route():
        return ops.router_topk(logits, top_k=s["k"], **kw)
    w_b, i_b = this_route()
    w_a, i_a = other_route()
    w_p, i_p = ref.router_ref(logits, s["k"], **kw)
    torch.cuda.synchronize()
    if not (torch.equal(i_b, i_a) and torch.equal(i_b, i_p)):
        sys.exit(f"chip_gemm_ab: router indices differ ({arch} T={T} "
                 f"{rows})")
    torch.testing.assert_close(w_b, w_p, rtol=1e-5, atol=1e-6)
    row = {"arm": "route", "kernel": "router_topk", "arch": arch,
           "E": s["E"], "k": s["k"], "T": T, "rows": rows, "card": smi,
           "max_abs_diff": (w_b - w_a).abs().max().item(),
           "bitwise_equal": bool(torch.equal(w_b, w_a)),
           "us": turns(other_route, this_route, replays)}
    print(json.dumps(row), flush=True)
    return w_p, i_p


def route_arm(other, smi: str, replays: int) -> None:
    """B5 and B4 of both trees: held (see the module's note) and timed in
    turns; one JSON line per shape."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import unpermute as unperm
    from repro_torch.scheduling import build_schedule

    def stream():
        return torch.cuda.current_stream().cuda_stream
    for arch, s in ROUTERS.items():
        kw = dict(gating=s["gating"], norm_topk=s["norm_topk"],
                  routed_scale=s["routed_scale"])
        for T in ROUTE_TS:
            g = torch.Generator(device="cuda").manual_seed(T)
            e = torch.arange(s["E"], device="cuda")
            worst = (3.0 - 0.1 * (e % 32) - 0.001 * (e // 32)).expand(T, -1)
            route_ab(other, arch, s, kw, T, "most_candidates",
                     worst.contiguous(), stream, smi, replays)
            w_p, i_p = route_ab(other, arch, s, kw, T, "random",
                                torch.randn((T, s["E"]), generator=g,
                                            device="cuda"),
                                stream, smi, replays)
            if arch not in SHAPES:
                continue
            sched = build_schedule(i_p, s["E"], s["M"], policy="dynamic")
            pos = sched.pos.contiguous()
            for dtype, weighted in ((torch.bfloat16, False),
                                    (torch.float32, False),
                                    (torch.bfloat16, True)):
                y = torch.randn((sched.capacity, s["d"]), generator=g,
                                device="cuda").to(dtype)
                w = w_p if weighted else None
                out = torch.empty((T, s["d"]), dtype=dtype, device="cuda")
                code = _build.dtype_code(dtype)

                def other_unperm():
                    _build.check(other.moe_unpermute(
                        y.data_ptr(), pos.data_ptr(),
                        None if w is None else w.data_ptr(), out.data_ptr(),
                        T, s["k"], s["d"], code, stream()), "other unpermute")
                    return out

                def this_unperm():
                    return unperm.unpermute(y, pos, w)
                got = this_unperm()
                theirs = other_unperm().clone()
                want = unperm.unpermute_plain(y, pos, w)
                torch.cuda.synchronize()
                if not (torch.equal(got, theirs) and torch.equal(got, want)):
                    sys.exit(f"chip_gemm_ab: unpermute not bitwise ({arch} "
                             f"T={T} {dtype} weighted={weighted})")
                row = {"arm": "route", "kernel": "unpermute", "arch": arch,
                       "d": s["d"], "k": s["k"], "T": T,
                       "dtype": str(dtype).replace("torch.", ""),
                       "weighted": weighted, "card": smi,
                       "bitwise_equal": True,
                       "us": turns(other_unperm, this_unperm, replays)}
                print(json.dumps(row), flush=True)
                del y, out, got, theirs, want
            torch.cuda.empty_cache()


def layer(arch: str, scheme, policy: str, T: int, dtype, seed: int):
    """The layer's routed rows xp, the gate+up output h (the plain version's,
    which feeds B1), the stacks (quantized under ``scheme`` unless None),
    the schedule and the folded combine rows."""
    import torch
    from repro_torch.execution import combine_scale_rows
    from repro_torch.kernels import ref
    from repro_torch.quantization import get_scheme
    from repro_torch.scheduling import build_schedule
    s = SHAPES[arch]
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(dtype)
    logits = torch.randn((T, s["E"]), generator=g, device="cuda")
    x = randn(T, s["d"])
    wg = randn(s["E"], s["d"], s["f"], scale=s["d"] ** -0.5)
    wu = randn(s["E"], s["d"], s["f"], scale=s["d"] ** -0.5)
    wd = randn(s["E"], s["f"], s["d"], scale=s["f"] ** -0.5)
    if scheme is not None:
        wg, wu, wd = (get_scheme(scheme).quantize(t) for t in (wg, wu, wd))
    w, idx = ref.router_ref(logits, s["k"], gating=s["gating"],
                            norm_topk=s["norm_topk"],
                            routed_scale=s["routed_scale"])
    sched = build_schedule(idx, s["E"], s["M"], policy=policy)
    xp = ref.permute_ref(x, sched)
    h = ref.fused_gate_up_ref(xp, wg, wu, sched)
    return xp, h, wg, wu, wd, sched, combine_scale_rows(sched, w)


def c_operands(w):
    """(weights, scales or None, format code, s_e, s_n) of an expert stack
    for the C interface; the caller keeps the tensors alive while their
    pointers are in use (the scales may be a fresh view)."""
    from repro_torch.kernels.grouped_gemm import W_FORMATS
    from repro_torch.kernels.ops import _weight_operands
    q, sc, fmt = _weight_operands(w)
    if sc is None:
        return q, None, 0, 0, 0
    return q, sc, W_FORMATS.index(fmt), sc.stride(0), sc.stride(1)


def ptr(t):
    return None if t is None else t.data_ptr()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=pathlib.Path)
    ap.add_argument("--replays", type=int, default=20)
    ap.add_argument("--arms", default="dense,quant",
                    help="comma-separated arms: dense, quant, route")
    ap.add_argument("--bf16-bitwise", action="store_true",
                    help="exit on any bf16 difference between the trees")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_gemm_ab: CUDA is not available")
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import expert_tiles as _tiles
    from repro_torch.kernels.grouped_gemm import TILE_SHAPES, W_FORMATS
    t0 = time.perf_counter()
    this = _build.library()
    this_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    other, other_lists, other_tiles, other_seconds = build_other(
        args.other / "src" / "repro_torch" / "csrc", _build.NVCC_FLAGS)
    other_s = time.perf_counter() - t0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"nvcc_s": {
        "this": {"all": this_s, **_build.build_seconds},
        "other": {"all": other_s, **other_seconds}}}), flush=True)
    arms = args.arms.split(",")
    if "route" in arms:
        route_arm(other, smi, args.replays)
    shapes = [sh for arm in arms if arm != "route" for sh in ARMS[arm]]
    for arch, scheme, policy, T in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            xp, h, wg, wu, wd, sched, scale = layer(arch, scheme, policy, T,
                                                    dtype, seed=T)
            cap, code = sched.capacity, _build.dtype_code(dtype)
            K, F, D = xp.shape[1], h.shape[1], xp.shape[1]
            be, ba, M = sched.block_expert, sched.block_active, sched.block_m
            o_fgu = torch.empty((cap, F), dtype=dtype, device="cuda")
            o_gg = torch.empty((cap, D), dtype=dtype, device="cuda")
            E = SHAPES[arch]["E"]
            buf = _tiles.scratch(cap, E, "cuda")
            gq, gs, fmt, s_e, s_n = c_operands(wg)
            uq, us, _, _, _ = c_operands(wu)
            dq, ds, _, d_e, d_n = c_operands(wd)
            # the other tree at its default tile shape, if it takes one
            t_fgu = list(TILE_SHAPES["fused_gate_up", W_FORMATS[fmt]][0]) \
                if other_tiles else []
            t_gg = list(TILE_SHAPES["grouped_gemm", W_FORMATS[fmt]][0]) \
                if other_tiles else []

            def other_fgu():
                stream = torch.cuda.current_stream().cuda_stream
                if other_lists:
                    err = other.moe_fused_gate_up(
                        xp.data_ptr(), gq.data_ptr(), uq.data_ptr(),
                        ptr(gs), ptr(us), sched.seg_start.data_ptr(),
                        be.data_ptr(), ba.data_ptr(), buf.data_ptr(),
                        o_fgu.data_ptr(), cap, K, F, E, M, code, fmt, s_e,
                        s_n, stream, *t_fgu)
                else:
                    err = other.moe_fused_gate_up(
                        xp.data_ptr(), gq.data_ptr(), uq.data_ptr(),
                        ptr(gs), ptr(us), be.data_ptr(), ba.data_ptr(),
                        o_fgu.data_ptr(), cap, K, F, M, code, fmt, s_e, s_n,
                        stream)
                _build.check(err, "other fused_gate_up")
                return o_fgu

            def other_gg():
                stream = torch.cuda.current_stream().cuda_stream
                if other_lists:
                    err = other.moe_grouped_gemm(
                        h.data_ptr(), dq.data_ptr(), ptr(ds),
                        sched.seg_start.data_ptr(), be.data_ptr(),
                        ba.data_ptr(), scale.data_ptr(), buf.data_ptr(),
                        o_gg.data_ptr(), cap, F, D, E, M, code, fmt, d_e,
                        d_n, stream, *t_gg)
                else:
                    err = other.moe_grouped_gemm(
                        h.data_ptr(), dq.data_ptr(), ptr(ds), be.data_ptr(),
                        ba.data_ptr(), scale.data_ptr(), o_gg.data_ptr(),
                        cap, F, D, M, code, fmt, d_e, d_n, stream)
                _build.check(err, "other grouped_gemm")
                return o_gg

            def this_fgu():
                return ops.fused_gate_up(xp, wg, wu, sched)

            def this_gg():
                return ops.grouped_gemm(h, wd, sched, row_scale=scale)
            row = {"arch": arch, "scheme": scheme or "none",
                   "policy": policy, "T": T,
                   "dtype": str(dtype).replace("torch.", ""),
                   "block_m": M, "card": smi}
            plains = {"fused_gate_up":
                      lambda: ref.fused_gate_up_ref(xp, wg, wu, sched),
                      "grouped_gemm":
                      lambda: ref.grouped_gemm_ref(h, wd, sched, scale)}
            for name, a, b in (("fused_gate_up", other_fgu, this_fgu),
                               ("grouped_gemm", other_gg, this_gg)):
                out_b = b()
                out_a = a()
                torch.cuda.synchronize()
                diff = (out_a.float() - out_b.float()).abs().max().item()
                row[f"{name}_max_abs_diff"] = diff
                row[f"{name}_bitwise_equal"] = bool(torch.equal(out_a, out_b))
                if dtype == torch.float32 and diff != 0:
                    sys.exit(f"chip_gemm_ab: {name} {row} differs in fp32: "
                             f"max abs {diff}")
                if args.bf16_bitwise and diff != 0:
                    sys.exit(f"chip_gemm_ab: {name} {row} differs in bf16: "
                             f"max abs {diff}")
                if dtype == torch.bfloat16:
                    want = plains[name]().float()
                    try:
                        torch.testing.assert_close(out_b.float(), want,
                                                   **TOL_BF16)
                    except AssertionError as e:
                        sys.exit(f"chip_gemm_ab: {name} {row} out of the "
                                 f"bf16 tolerance of the plain version: {e}")
                    row[f"{name}_max_abs_err_vs_plain"] = \
                        (out_b.float() - want).abs().max().item()
                    del want
                    t = [device_ms(f, replays=args.replays)
                         for f in (a, b, b, a)]
                    row[f"{name}_us"] = {
                        "other": [t[0] * 1e3, t[3] * 1e3],
                        "this": [t[1] * 1e3, t[2] * 1e3]}
            print(json.dumps(row), flush=True)
            del xp, h, wg, wu, wd
            torch.cuda.empty_cache()
    del this
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
