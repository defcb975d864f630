"""A/B of the paged decode-attention kernels of this checkout against those
of another source tree, on one NVIDIA GPU.

    python3 chip_paged_ab.py --other DIR [--no-time] [--sweep] [--replays 10]

DIR is the root of another checkout whose ``src/repro_torch/csrc`` has the
paged-attention C interface from before the split-KV kernel
(``moe_paged_attention`` taking q already scaled, one thread block per
(row, KV head); and ``moe_paged_attention_mla``), e.g. the parent commit
unpacked with ``git archive``.  Both trees' sources are compiled with the
same nvcc flags.

1. prints ptxas's registers and spills of this tree's paged-attention
   kernels;
2. the MLA kernel (deepseek-v2's absorbed decode: 128 and 120 heads, latent
   512 + rope key 64, blocks of 16; decode B=2 and the 64-row chunk step;
   bf16 and fp32): the two trees' outputs must be bitwise equal;
3. the GQA kernel at each of ``chip_smoke.PAGED_SHAPES`` (moonshot decode,
   chunk, long context and batched; mixtral's GQA decode), bf16 and fp32:
   this tree is held within chip_smoke's ``TOL`` of the plain version and
   must be bitwise equal across two calls; the max abs difference between
   the trees is printed; then (unless ``--no-time``) in bf16 both trees are
   timed in turns (other, this, this, other): device time per call from
   CUDA-graph replays between CUDA events, beside the bound;
4. with ``--sweep``, this tree's GQA kernel at each of those shapes (bf16)
   under split plans other than ``split_plan``'s: the C entry called
   directly with n_split from a fixed list, each timed as above, beside
   the plan the wrapper takes.

Prints one JSON line per shape and a last line ``{"ok": true, ...}``;
exits non-zero on an MLA difference or a GQA output out of tolerance."""
import argparse
import ctypes
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent


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
            if "paged_attention" in entry:
                print(f"ptxas {cs.kernel_name(entry)}: "
                      f"{line.split(':', 1)[1].strip()}{spill}")
            entry = None
    other, _ = chip_gemm_ab.build_other(
        args.other / "src" / "repro_torch" / "csrc", _build.NVCC_FLAGS)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    other.moe_paged_attention.argtypes = [P] * 7 + [I] * 10 + [F, I, P]
    other.moe_paged_attention_mla.argtypes = [P] * 8 + [I] * 10 + [F, I, P]
    for fn in (other.moe_paged_attention, other.moe_paged_attention_mla):
        fn.restype = ctypes.c_int
    smi = cs.smi_line()
    print(smi)
    stream = lambda: _build.stream_ptr(torch.device("cuda", 0))  # noqa: E731

    # the MLA kernel: bitwise the other tree's
    for dtype in (torch.bfloat16, torch.float32):
        for G, kind in ((128, "decode"), (128, "chunk"), (120, "decode")):
            c = cs.MLACase(dict(cs.MLA_ATTN, G=G), cs.paged_rows(kind), dtype,
                           seed=17 + G)
            B, _, _, D = c.q.shape
            D2 = c.q2.shape[-1]
            this_out = c.run(kern)
            qs, q2s = scale_q(c.q, c.scale), scale_q(c.q2, c.scale)
            out = torch.empty_like(this_out)
            _build.check(other.moe_paged_attention_mla(
                qs.data_ptr(), q2s.data_ptr(), c.k.data_ptr(),
                c.k2.data_ptr(), c.tables.data_ptr(), c.lim.data_ptr(), None,
                out.data_ptr(), B, 1, G, D, D2, c.attn["bs"], c.nb, 0, 0, 0,
                0.0, _build.dtype_code(dtype), stream()), "other mla")
            torch.cuda.synchronize()
            same = bool(torch.equal(out, this_out))
            print(json.dumps({"kernel": "paged_attention_mla", "G": G,
                              "kind": kind, "dtype": str(dtype)[6:],
                              "bitwise_equal_to_other": same}))
            if not same:
                sys.exit(f"chip_paged_ab: the MLA kernel differs from the "
                         f"other tree's ({G} heads, {kind}, {dtype})")
            del c, out, this_out

    # the GQA kernel: held against plain; times beside the other tree's
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kind, (attn, rows, nb, slots) in cs.PAGED_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).replace("torch.", "")
            c = cs.PagedCase(attn, rows, dtype, seed=11, nb=nb, slots=slots)
            B, Hkv, G, D = c.q.shape
            qs = scale_q(c.q, None).contiguous()

            def this():
                return c.run(kern)

            def that():
                out = torch.empty_like(c.q)
                _build.check(other.moe_paged_attention(
                    qs.data_ptr(), c.k.data_ptr(), c.v.data_ptr(),
                    c.tables.data_ptr(), c.lim.data_ptr(), None,
                    out.data_ptr(), B, Hkv, G, D, D, attn["bs"], nb, 0, 0, 0,
                    0.0, _build.dtype_code(dtype), stream()), "other gqa")
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
            n_split, per = split_plan(B, Hkv, nb, sms)
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
    """Device µs of this tree's GQA kernel (bf16) at each of
    chip_smoke.PAGED_SHAPES under n_split from SWEEP_SPLITS (at most the
    table width; per_split = ceil(nb / n_split)), beside split_plan's."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import (_scale_value, gqa_warps,
                                                      split_plan)
    lib = _build.library()
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
                    per, n, warps, 0, 0, 0, 0.0, 1,
                    _build.stream_ptr(torch.device("cuda", 0))), "sweep")
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


if __name__ == "__main__":
    main()
