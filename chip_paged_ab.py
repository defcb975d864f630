"""A/B of the paged decode-attention kernels of this checkout against those
of another source tree, on one NVIDIA GPU.

    python3 chip_paged_ab.py --other DIR [--no-time] [--sweep] [--replays 10]

DIR is the root of another checkout whose ``src/repro_torch/csrc`` has the
paged-attention C interface (``moe_paged_attention``, and
``moe_paged_attention_mla``), e.g. the parent commit unpacked with ``git
archive``.  Both trees' sources are compiled with the same nvcc flags.  The
other tree's entry points are called with the parameters its source
declares, read from ``paged_attention.cu``: with PR 18's split arguments
(partials, ``per_split``, ``n_split``, ``warps``) where it has them, with q
already scaled where it takes no ``scale``, with this tree's split plans
where it has split arguments.

1. prints ptxas's registers and spills of this tree's paged-attention
   kernels;
2. the MLA kernels (deepseek-v2's absorbed decode: 128 heads, latent 512 +
   rope key 64, blocks of 16) at each of ``chip_smoke.MLA_SHAPES`` and at
   decode with 120 heads: fp32 must be bitwise equal to the other tree's
   (exits otherwise); bf16 is held within chip_smoke's ``TOL`` of the plain
   version and bitwise equal across two calls (exits otherwise), and its
   max abs difference from the other tree's is printed (a tensor-core
   kernel sums in another order than a CUDA-core one); then (unless
   ``--no-time``) in bf16 both trees are timed in turns (other, this, this,
   other): device time per call from CUDA-graph replays between CUDA
   events, beside the bound and this tree's split plan;
3. the GQA kernel at each of ``chip_smoke.PAGED_SHAPES`` (moonshot decode,
   chunk, long context and batched; mixtral's GQA decode), bf16 and fp32:
   this tree is held within ``TOL`` of the plain version and must be
   bitwise equal across two calls; the max abs difference between the
   trees is printed; then timed in turns in bf16 as above;
4. with ``--sweep``, this tree's GQA and bf16 MLA kernels at each of their
   shapes under split plans other than the wrapper's: the C entry called
   directly with n_split from a fixed list (MLA: whole tiles a split), each
   timed as above, beside the plan the wrapper takes.

Prints one JSON line per shape and a last line ``{"ok": true, ...}``;
exits non-zero on an fp32 MLA difference or a kernel output out of
tolerance or not repeatable."""
import argparse
import ctypes
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent
_CTYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
           "float": ctypes.c_float}


def c_params(src: str, fn: str) -> list:
    """[(name, ctype)] of C entry ``fn`` as the source declares it."""
    head = src[src.index(f"MOE_API int {fn}("):]
    args = head[head.index("(") + 1:head.index(")")]
    out = []
    for arg in args.split(","):
        words = arg.replace("*", " * ").replace("const", " ").split()
        kind = "void*" if "*" in words else words[0]
        out.append((words[-1], _CTYPES[kind]))
    return out


class Entry:
    """A C entry of a loaded library, called with values by parameter name
    (names the entry does not declare are ignored)."""

    def __init__(self, lib, src: str, fn: str):
        self.params = c_params(src, fn)
        self.names = {n for n, _ in self.params}
        self.fn = getattr(lib, fn)
        self.fn.argtypes = [t for _, t in self.params]
        self.fn.restype = ctypes.c_int

    def __call__(self, **values) -> int:
        return self.fn(*(values[n] for n, _ in self.params))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=pathlib.Path)
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--replays", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_paged_ab: CUDA is not available")
    import chip_gemm_ab
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import (
        _scale_value, gqa_warps, mla_split_plan,
        paged_decode_attention as kern, paged_decode_attention_plain as plain,
        scale_q, split_plan)
    _build.library()
    entry, spill = None, ""
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            entry, spill = line.split("'")[1], ""
        elif "spill stores" in line and entry is not None:
            spill = "; " + line.strip()
        elif "Used" in line and entry is not None:
            if "paged_attention" in entry or "mla" in entry:
                print(f"ptxas {cs.kernel_name(entry)}: "
                      f"{line.split(':', 1)[1].strip()}{spill}")
            entry = None
    other_csrc = args.other / "src" / "repro_torch" / "csrc"
    other, _ = chip_gemm_ab.build_other(other_csrc, _build.NVCC_FLAGS)
    src = (other_csrc / "paged_attention.cu").read_text()
    o_gqa = Entry(other, src, "moe_paged_attention")
    o_mla = Entry(other, src, "moe_paged_attention_mla")
    print(f"other tree: moe_paged_attention({', '.join(o_gqa.names)}); "
          f"moe_paged_attention_mla({', '.join(o_mla.names)})")
    smi = cs.smi_line()
    print(smi)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def ptr(t):
        return None if t is None else t.data_ptr()

    # the MLA kernels: fp32 bitwise the other tree's; bf16 held against
    # plain and timed beside the other tree's
    mla_shapes = [(kind, *v) for kind, v in cs.MLA_SHAPES.items()]
    mla_shapes.append(("decode_G120", dict(cs.MLA_ATTN, G=120),
                       cs.paged_rows("decode"), 8, 2))
    for kind, attn, rows, nb, slots in mla_shapes:
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).replace("torch.", "")
            c = cs.MLACase(attn, rows, dtype, seed=17 + attn["G"], nb=nb,
                           slots=slots)
            B, _, G, D = c.q.shape
            D2 = c.q2.shape[-1]
            bs = attn["bs"]
            # fp32 kernels take q and q2 scaled; bf16 ones that declare a
            # scale scale them themselves
            scaled = "scale" not in o_mla.names or dtype == torch.float32
            qs = scale_q(c.q, c.scale).contiguous() if scaled else c.q
            q2s = scale_q(c.q2, c.scale).contiguous() if scaled else c.q2
            k_scale = 1.0 if scaled else _scale_value(c.q, c.scale)
            n_split, per = (mla_split_plan(B, 1, G, nb, bs, D, D2, sms)
                            if dtype == torch.bfloat16 else (1, nb))
            pml = torch.empty((B, 1, G, n_split, 2), dtype=torch.float32,
                              device=dev)
            pac = torch.empty((B, 1, G, n_split, D), dtype=torch.float32,
                              device=dev)

            def this():
                return c.run(kern)

            def that():
                out = torch.empty_like(c.q)
                _build.check(o_mla(
                    q=ptr(qs), q2=ptr(q2s), kv_pool=ptr(c.k),
                    k2_pool=ptr(c.k2), tables=ptr(c.tables),
                    kv_limit=ptr(c.lim), q_pos=None, out=ptr(out),
                    part_ml=ptr(pml), part_acc=ptr(pac),
                    scale=k_scale, B=B, Hkv=1, G=G, D=D,
                    D2=D2, bs=bs, nb=nb, n_blocks=c.k.shape[0], per_split=per,
                    n_split=n_split, causal=0, has_window=0, window=0,
                    softcap=0.0, dtype=_build.dtype_code(dtype),
                    stream=_build.stream_ptr(dev)), "other mla")
                return out
            got, again, was = this(), this(), that()
            torch.cuda.synchronize()
            row = {"kernel": "paged_attention_mla", "kind": kind, "G": G,
                   "dtype": dt, "B": B, "nb": nb,
                   "max_abs_diff_vs_other":
                       (got.float() - was.float()).abs().max().item(),
                   "card": smi}
            if dtype == torch.float32:
                same = bool(torch.equal(got, was))
                row["bitwise_equal_to_other"] = same
                print(json.dumps(row))
                if not same:
                    sys.exit(f"chip_paged_ab: the fp32 MLA kernel differs "
                             f"from the other tree's ({kind})")
                del c, got, again, was
                continue
            want = c.run(plain)
            try:
                torch.testing.assert_close(got.float(), want.float(),
                                           **cs.TOL[dt])
            except AssertionError as e:
                sys.exit(f"chip_paged_ab: MLA {kind} {dt} out of tolerance "
                         f"of the plain version: {e}")
            if not torch.equal(got, again):
                sys.exit(f"chip_paged_ab: MLA {kind} {dt}: two calls differ")
            row.update({"n_split": n_split, "per_split": per,
                        "max_abs_err_vs_plain":
                            (got.float() - want.float()).abs().max().item()})
            if not args.no_time and kind in cs.MLA_SHAPES:
                n_bytes, flops = c.work()
                per_graph = 20 if B * (max(c.lims) + 1) > 4096 else 50
                t = [cs.device_ms(f, per_graph, args.replays)
                     for f in (that, this, this, that)]
                row.update({"us": {"other": [t[0] * 1e3, t[3] * 1e3],
                                   "this": [t[1] * 1e3, t[2] * 1e3]},
                            "bound_us": cs.bound_ms(n_bytes, flops)[0] * 1e3,
                            "bytes": n_bytes})
            print(json.dumps(row))
            del c, got, again, was, want
            torch.cuda.empty_cache()

    # the GQA kernel: held against plain; times beside the other tree's
    for kind, (attn, rows, nb, slots) in cs.PAGED_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).replace("torch.", "")
            c = cs.PagedCase(attn, rows, dtype, seed=11, nb=nb, slots=slots)
            B, Hkv, G, D = c.q.shape
            scaled = "scale" not in o_gqa.names
            qs = scale_q(c.q, None).contiguous() if scaled else c.q
            n_split, per = split_plan(B, Hkv, nb, sms)
            pml = torch.empty((B, Hkv, G, n_split, 2), dtype=torch.float32,
                              device=dev)
            pac = torch.empty((B, Hkv, G, n_split, D), dtype=torch.float32,
                              device=dev)

            def this():
                return c.run(kern)

            def that():
                out = torch.empty_like(c.q)
                _build.check(o_gqa(
                    q=ptr(qs), k_pool=ptr(c.k), v_pool=ptr(c.v),
                    tables=ptr(c.tables), kv_limit=ptr(c.lim), q_pos=None,
                    out=ptr(out), part_ml=ptr(pml), part_acc=ptr(pac),
                    scale=_scale_value(c.q, None), B=B, Hkv=Hkv, G=G, D=D,
                    Dv=D, bs=attn["bs"], nb=nb, per_split=per,
                    n_split=n_split,
                    warps=min(Hkv, gqa_warps(attn["bs"], D, D,
                                             c.q.element_size())),
                    causal=0, has_window=0, window=0, softcap=0.0,
                    dtype=_build.dtype_code(dtype),
                    stream=_build.stream_ptr(dev)), "other gqa")
                return out
            got, again, was = this(), this(), that()
            want = c.run(plain)
            torch.cuda.synchronize()
            try:
                torch.testing.assert_close(got.float(), want.float(),
                                           **cs.TOL[dt])
            except AssertionError as e:
                sys.exit(f"chip_paged_ab: GQA {kind} {dt} out of tolerance "
                         f"of the plain version: {e}")
            if not torch.equal(got, again):
                sys.exit(f"chip_paged_ab: GQA {kind} {dt}: two calls differ")
            row = {"kernel": "paged_attention", "kind": kind, "dtype": dt,
                   "B": B, "Hkv": Hkv, "G": G, "nb": nb, "n_split": n_split,
                   "per_split": per,
                   "max_abs_err_vs_plain":
                       (got.float() - want.float()).abs().max().item(),
                   "max_abs_diff_vs_other":
                       (got.float() - was.float()).abs().max().item(),
                   "card": smi}
            if dtype == torch.bfloat16 and not args.no_time:
                n_bytes, flops = c.work()
                per_graph = 20 if B * (max(c.lims) + 1) > 4096 else 50
                t = [cs.device_ms(f, per_graph, args.replays)
                     for f in (that, this, this, that)]
                row.update({"us": {"other": [t[0] * 1e3, t[3] * 1e3],
                                   "this": [t[1] * 1e3, t[2] * 1e3]},
                            "bound_us": cs.bound_ms(n_bytes, flops)[0] * 1e3,
                            "bytes": n_bytes})
            print(json.dumps(row))
            del c, qs, got, again, was, want
            torch.cuda.empty_cache()
    if args.sweep:
        sweep(cs, plain, sms, smi)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))


SWEEP_SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 20, 24, 28, 32, 36, 40, 48, 64)


def sweep(cs, plain, sms: int, smi: str) -> None:
    """Device µs of this tree's GQA kernel and bf16 MLA kernel at each of
    chip_smoke.PAGED_SHAPES and MLA_SHAPES under n_split from SWEEP_SPLITS
    (at most the table width; per_split = ceil(nb / n_split), for MLA
    rounded up to whole tiles), beside the wrapper's plan."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import (
        _scale_value, gqa_warps, mla_split_plan, mla_tile, split_plan)
    lib = _build.library()
    stream = lambda: _build.stream_ptr(torch.device("cuda", 0))  # noqa: E731
    for kind, (attn, rows, nb, slots) in cs.PAGED_SHAPES.items():
        c = cs.PagedCase(attn, rows, torch.bfloat16, seed=11, nb=nb,
                         slots=slots)
        B, Hkv, G, D = c.q.shape
        warps = min(Hkv, gqa_warps(attn["bs"], D, D, 2))
        want = c.run(plain).float()
        times = {}
        for n0 in sorted({min(n, nb) for n in SWEEP_SPLITS}):
            per = -(-nb // n0)
            n = -(-nb // per)
            out = torch.empty_like(c.q)
            pml = torch.empty((B, Hkv, G, n, 2), dtype=torch.float32,
                              device="cuda")
            pac = torch.empty((B, Hkv, G, n, D), dtype=torch.float32,
                              device="cuda")

            def call():
                _build.check(lib.moe_paged_attention(
                    c.q.data_ptr(), c.k.data_ptr(), c.v.data_ptr(),
                    c.tables.data_ptr(), c.lim.data_ptr(), None,
                    out.data_ptr(), pml.data_ptr(), pac.data_ptr(),
                    _scale_value(c.q, None), B, Hkv, G, D, D, attn["bs"], nb,
                    per, n, warps, 0, 0, 0, 0.0, 1, stream()), "sweep")
                return out
            call()
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), want, **cs.TOL["bfloat16"])
            big = B * (max(c.lims) + 1) > 4096
            times[n] = cs.device_ms(call, 20 if big else 50, 10) * 1e3
        print(json.dumps({"sweep": kind, "plan": split_plan(B, Hkv, nb, sms),
                          "us_by_n_split": times, "card": smi}))
        del c
        torch.cuda.empty_cache()
    for kind, (attn, rows, nb, slots) in cs.MLA_SHAPES.items():
        c = cs.MLACase(attn, rows, torch.bfloat16, seed=19, nb=nb,
                       slots=slots)
        B, _, G, D = c.q.shape
        D2, bs = c.q2.shape[-1], attn["bs"]
        nbt = max(1, mla_tile(D, D2) // bs)
        want = c.run(plain).float()
        times = {}
        for n0 in sorted({min(n, nb) for n in SWEEP_SPLITS}):
            per = min(nb, -(-(-(-nb // n0)) // nbt) * nbt)
            n = -(-nb // per)
            if n in times:
                continue
            out = torch.empty_like(c.q)
            pml = torch.empty((B, 1, G, n, 2), dtype=torch.float32,
                              device="cuda")
            pac = torch.empty((B, 1, G, n, D), dtype=torch.float32,
                              device="cuda")

            def call():
                _build.check(lib.moe_paged_attention_mla(
                    c.q.data_ptr(), c.q2.data_ptr(), c.k.data_ptr(),
                    c.k2.data_ptr(), c.tables.data_ptr(), c.lim.data_ptr(),
                    None, out.data_ptr(), pml.data_ptr(), pac.data_ptr(),
                    _scale_value(c.q, c.scale), B, 1, G, D, D2, bs, nb,
                    c.k.shape[0], per, n, 0, 0, 0, 0.0, 1, stream()),
                    "sweep mla")
                return out
            call()
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), want, **cs.TOL["bfloat16"])
            big = B * (max(c.lims) + 1) > 4096
            times[n] = cs.device_ms(call, 20 if big else 50, 10) * 1e3
        print(json.dumps({"sweep": f"mla {kind}",
                          "plan": mla_split_plan(B, 1, G, nb, bs, D, D2, sms),
                          "us_by_n_split": times, "card": smi}))
        del c
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
