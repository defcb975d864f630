"""Probe the MLA form of the paged decode-attention kernel on the card.

    python3 chip_mla_probe.py

Builds the kernels (printing ptxas's register and spill lines of the MLA
kernels when this call compiles them, and the HGMMA / UTMALDG counts of
the bf16 Hopper kernel from ``cuobjdump -sass``), holds the MLA kernels
against their plain version at each of ``chip_smoke.MLA_SHAPES`` (deepseek
decode, the 64-row chunk step, long context and batched) and with 120
heads, bf16 and fp32 (``chip_smoke.check_mla``), times the bf16 kernel at
each of those shapes beside its split plan, plain version, bound and SDPA
yardstick (``chip_smoke.time_mla``) and the GQA kernel at moonshot's
decode, then times one row of 16 heads over kv_limit 15-2047 (1-128 pool
blocks), eagerly and on the device (CUDA-graph replays), whose slope is
the cost of a tile.  It needs one CUDA device and exits non-zero without
one.
"""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_mla_probe: CUDA is not available")
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import paged_decode_attention
    _build.library()
    entry = None
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and "mla" in entry and ("Used" in line or "spill" in line):
            print(f"ptxas {cs.kernel_name(entry)}: {line.strip()}")
        if "Performance" in line or "serialized" in line:
            print(f"ptxas: {line.strip()}")
    for fn, n in cs.sass_counts(_build.build()).items():
        if cs.HOPPER_KERNELS["paged_attention_mla"] in fn:
            print(f"SASS {cs.kernel_name(fn)}: HGMMA {n['HGMMA']}, UTMALDG "
                  f"{n['UTMALDG']}")
    print(cs.smi_line())
    errs: dict = {}
    cs.check_mla(errs)
    print(f"max_abs_err {errs}")
    keys = ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
            "bound_bytes_ms", "bound_ops_ms", "library_ms", "n_split",
            "per_split")
    for kind in cs.MLA_SHAPES:
        t = cs.time_mla(kind)
        print(f"mla {kind}: " + ", ".join(f"{k} {t[k]}" for k in keys))
    t = cs.time_paged("decode")
    print(f"gqa decode: ms {t['ms']}, eager_ms {t['eager_ms']}")
    g = torch.Generator(device="cuda").manual_seed(0)
    nb, bs, G = 128, 16, 16
    ckv = torch.randn(nb, bs, 1, 512, generator=g, device="cuda").bfloat16()
    kr = torch.randn(nb, bs, 1, 64, generator=g, device="cuda").bfloat16()
    q = torch.randn(1, 1, G, 512, generator=g, device="cuda").bfloat16()
    q2 = torch.randn(1, 1, G, 64, generator=g, device="cuda").bfloat16()
    tables = torch.arange(nb, dtype=torch.int32, device="cuda")[None]
    for lim in (15, 63, 127, 255, 511, 1023, 2047):
        lim_t = torch.full((1,), lim, dtype=torch.int32, device="cuda")

        def call():
            return paged_decode_attention(q, ckv, ckv, tables, lim_t,
                                          scale=576 ** -0.5, q2=q2,
                                          k2_pool=kr)
        print(f"one row, {G} heads, kv_limit {lim}: eager "
              f"{cs.time_ms(call, 50) * 1e3:.1f} us, device "
              f"{cs.device_ms(call, 50) * 1e3:.1f} us")


if __name__ == "__main__":
    main()
