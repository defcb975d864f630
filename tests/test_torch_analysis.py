"""The port's analysis (``repro_torch.analysis``) against the reference's
``repro.analysis``: the cost model cell for cell, the roofline's FLOP and
byte fields, the ring link-byte formulas and loop multipliers, and the
report's tables (``perf_rows``, the variant table, too) string for
string over the same records.  Nothing here
computes on a device; the reference's modules are pure Python."""
import dataclasses
import json

import pytest

pytest.importorskip("jax")      # the reference side; absent on the card
from repro.analysis import flops as ref_flops  # noqa: E402
from repro.analysis import report as ref_report  # noqa: E402
from repro.analysis.hlo import (_link_bytes, collective_report as  # noqa: E402
                                ref_collective_report, parse_collectives)
from repro.analysis.roofline import analyze_cell as ref_analyze_cell  # noqa: E402
from repro.configs import (ARCH_NAMES, SHAPES as REF_SHAPES,  # noqa: E402
                           cell_is_runnable as ref_runnable,
                           get_config as ref_get_config)
from repro_torch.analysis import flops, report  # noqa: E402
from repro_torch.analysis.collectives import collective_report, link_bytes  # noqa: E402
from repro_torch.analysis.roofline import (HBM_BW, PEAK_FLOPS, analyze_cell,  # noqa: E402
                                           bound_ms, link_rate)
from repro_torch.configs import SHAPES, cell_is_runnable, get_config  # noqa: E402

from torch_threads import one_torch_thread  # noqa: F401,E402

CELLS = [(a, s.name) for a in ARCH_NAMES for s in REF_SHAPES]


def _shape(name, shapes):
    return next(s for s in shapes if s.name == name)


def test_shapes_are_the_references():
    assert [dataclasses.astuple(s) for s in SHAPES] == \
        [dataclasses.astuple(s) for s in REF_SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_is_runnable_matches_reference(arch, shape):
    assert cell_is_runnable(get_config(arch), _shape(shape, SHAPES)) == \
        ref_runnable(ref_get_config(arch), _shape(shape, REF_SHAPES))


@pytest.mark.parametrize("chips", [256, 512])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_cost_equals_reference(arch, shape, chips):
    """Every CellCost field equals the reference's at ep 16 (its fixed
    EP size), train cells with the reference's accumulation and remat."""
    kw = dict(chips=chips, accum=4 if shape == "train_4k" else 1,
              remat=shape == "train_4k")
    ref = ref_flops.cell_cost(ref_get_config(arch),
                              _shape(shape, REF_SHAPES), **kw)
    got = flops.cell_cost(get_config(arch), _shape(shape, SHAPES), ep=16,
                          **kw)
    r, g = dataclasses.asdict(ref), dataclasses.asdict(got)
    assert r.keys() == g.keys()
    for k in r:
        if isinstance(r[k], float):
            assert g[k] == pytest.approx(r[k], rel=1e-12, abs=0), k
        else:
            assert g[k] == r[k], k
    # the default EP size is the reference's 16
    assert dataclasses.asdict(flops.cell_cost(
        get_config(arch), _shape(shape, SHAPES), **kw)) == g


DECODE_ARCHS = ["moonshot-v1-16b-a3b", "deepseek-v2-236b", "qwen2-7b",
                "gemma2-9b", "rwkv6-1.6b", "zamba2-7b"]


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_step_work_decode_against_cell_cost(arch):
    """A decode step's least bytes: ``cell_cost``'s on one card less the
    embedding rows it does not gather (an untied embedding), its routed
    experts as many as the router chose, at their stored bytes; its FLOPs
    ``cell_cost``'s less the capacity padding."""
    cfg = get_config(arch).replace(n_layers=6)
    shape = dataclasses.replace(_shape("decode_32k", SHAPES), seq_len=70,
                                global_batch=2)
    cc = flops.cell_cost(cfg, shape, chips=1, ep=1)
    w = flops.step_work(cfg, shape)
    d, pb = cfg.d_model, 2.0
    emb = 0.0 if cfg.tie_embeddings else (cfg.vocab_size - 2) * d * pb
    kinds = flops._all_kinds(cfg)
    # C18: the K/V of MoE blocks without MLA, which cell_cost leaves out
    moe_kv = w.parts["cache"] - flops._cache_bytes(cfg, kinds, [70, 70])
    assert (moe_kv > 0) == (cfg.is_moe and cfg.mla is None)
    assert w.hbm_bytes == pytest.approx(cc.hbm_bytes - emb + moe_kv,
                                        rel=1e-12)
    n_moe = sum(k == "moe" for k in kinds)
    if not n_moe:
        assert w.flops == pytest.approx(cc.dispatch_flops, rel=1e-12)
        return
    assert cc.model_flops < w.flops < cc.dispatch_flops
    m = cfg.moe
    per = 3 * d * m.d_ff_expert * pb
    routed = flops.step_work(cfg, shape, routed=n_moe * m.top_k)
    assert w.hbm_bytes - routed.hbm_bytes == pytest.approx(
        n_moe * (m.n_experts - m.top_k) * per, rel=1e-12)
    stored = flops.step_work(cfg, shape, routed=n_moe * m.top_k,
                             expert_bytes=per / 2)
    assert routed.hbm_bytes - stored.hbm_bytes == pytest.approx(
        n_moe * m.top_k * per / 2, rel=1e-12)
    assert stored.flops == routed.flops == w.flops


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_step_work_decode_context_rows(arch):
    """Rows at their own contexts: equal contexts are the shape's seq_len;
    the cache and the attention grow with them."""
    cfg = get_config(arch).replace(n_layers=6)
    shape = dataclasses.replace(_shape("decode_32k", SHAPES), seq_len=40,
                                global_batch=2)
    w = flops.step_work(cfg, shape)
    same = flops.step_work(cfg, shape, context=[40, 40])
    assert (same.flops, same.hbm_bytes) == (w.flops, w.hbm_bytes)
    more = flops.step_work(cfg, shape, context=[40, 60])
    assert more.parts["cache"] >= w.parts["cache"]
    assert more.flops >= w.flops
    if any(k in ("attn", "attn_global", "shared_attn", "moe", "moe_dense")
           for k in flops._all_kinds(cfg)):
        assert more.parts["cache"] > w.parts["cache"]


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "qwen2-7b",
                                  "rwkv6-1.6b"])
@pytest.mark.parametrize("remat", [False, True])
def test_step_work_train_drops_only_the_capacity_padding(arch, remat):
    cfg = get_config(arch).replace(n_layers=4)
    shape = dataclasses.replace(_shape("train_4k", SHAPES), seq_len=512,
                                global_batch=8)
    cc = flops.cell_cost(cfg, shape, chips=1, ep=1, remat=remat)
    w = flops.step_work(cfg, shape, remat=remat)
    assert w.hbm_bytes == cc.hbm_bytes
    waste = 0.0
    if cfg.is_moe:          # cell_cost's capacity term on one card
        m, T = cfg.moe, 8 * 512
        cap = max(128, 2.0 * T * m.top_k / m.n_experts)
        waste = sum(k == "moe" for k in flops._all_kinds(cfg)) * 3.0 * (
            m.n_experts * cap / (T * m.top_k) - 1.0) * m.top_k * 6 \
            * cfg.d_model * m.d_ff_expert * T * (4 / 3 if remat else 1)
        assert waste > 0
    assert w.flops == pytest.approx(cc.dispatch_flops - waste, rel=1e-12)


def test_c17_ep_size_below_16_chips():
    """The reference fixes ep = 16: below 16 chips its tokens a group fall
    to 1 and moonshot's dispatch FLOPs come out 994x its model FLOPs.  The
    port takes the EP size from the grid: at 8 chips with ep = 8 (and one
    card with ep = 1) the ratio is the 16-chip one."""
    arch, shape = "moonshot-v1-16b-a3b", "train_4k"
    ref8 = ref_flops.cell_cost(ref_get_config(arch),
                               _shape(shape, REF_SHAPES), chips=8)
    ref16 = ref_flops.cell_cost(ref_get_config(arch),
                                _shape(shape, REF_SHAPES), chips=16)
    assert ref8.dispatch_flops / ref8.model_flops == pytest.approx(
        994.48, rel=1e-4)
    for chips, ep in ((8, 8), (1, 1), (8, 4)):
        got = flops.cell_cost(get_config(arch), _shape(shape, SHAPES),
                              chips=chips, ep=ep)
        assert got.dispatch_flops / got.model_flops == pytest.approx(
            ref16.dispatch_flops / ref16.model_flops, rel=1e-12)
    with pytest.raises(ValueError, match="C17"):
        flops.cell_cost(get_config(arch), _shape(shape, SHAPES), chips=8)
    with pytest.raises(ValueError, match="divide"):
        flops.cell_cost(get_config(arch), _shape(shape, SHAPES), chips=8,
                        ep=3)


def _records():
    return [
        {"arch": "qwen2-7b", "shape": "train_4k", "mesh": "16x16",
         "meta": {"accum": 4}, "collectives": {"total_bytes": 500e9},
         "cost": {"flops": 1e12, "bytes accessed": 1e12},
         "memory": {"temp_bytes": 5e9, "argument_bytes": 2e9}},
        {"arch": "deepseek-v2-236b", "shape": "decode_32k",
         "mesh": "2x16x16", "collectives": {"total_bytes": 3e9},
         "cost": {"flops": 4e12},
         "memory": {"temp_bytes": 9e9, "argument_bytes": 70e9}},
        {"arch": "moonshot-v1-16b-a3b", "shape": "prefill_32k",
         "mesh": "16x16", "collectives": {"total_bytes": 0.0},
         "memory": {"temp_bytes": None}},
        {"arch": "rwkv6-1.6b", "shape": "long_500k", "mesh": "2x16x16",
         "meta": {"accum": 1}, "collectives": {"total_bytes": 1e6}},
    ]


@pytest.mark.parametrize("i", range(4))
def test_analyze_cell_flops_and_bytes_equal_reference(i):
    rec = _records()[i]
    ref = ref_analyze_cell(rec)
    got = analyze_cell(rec)
    assert got.chips == ref.chips
    for f in ("model_flops", "dispatch_flops", "flops_ratio",
              "hlo_raw_flops", "hlo_raw_bytes", "collective_bytes",
              "temp_bytes_per_dev"):
        assert getattr(got, f) == getattr(ref, f), f
    # the terms are the H100's: FLOPs over 989e12 a card, bytes over
    # 3.35e12, link bytes over NVLink or the assumed inter-host rate
    assert got.compute_s == ref.dispatch_flops / (ref.chips * PEAK_FLOPS)
    assert got.collective_s == ref.collective_bytes / link_rate(
        ref.chips)[0]
    assert "assumption" in link_rate(ref.chips)[1]


def test_analyze_cell_reads_chips_and_ep_from_the_grid():
    rec = {"arch": "moonshot-v1-16b-a3b", "shape": "train_4k",
           "grid": "2x4", "chips": 8, "meta": {"accum": 4, "ep": 4},
           "collectives": {"total_bytes": 1e9},
           "memory": {"temp_bytes": 1e9, "argument_bytes": 2e9}}
    r = analyze_cell(rec)
    c = flops.cell_cost(get_config(rec["arch"]), _shape("train_4k", SHAPES),
                        chips=8, accum=4, ep=4)
    assert (r.chips, r.mesh) == (8, "2x4")
    assert r.dispatch_flops == c.dispatch_flops
    assert r.memory_s == c.hbm_bytes / HBM_BW
    assert r.collective_s == 1e9 / 450e9 and "NVLink" in r.link_source
    assert r.fits_hbm is True


def test_bound_ms():
    assert bound_ms(3.35e12, 1.0) == (1e3, "bytes")
    assert bound_ms(1.0, 989e12) == (1e3, "operations")


KINDS = [("all-reduce", "all_reduce"), ("all-gather", "all_gather"),
         ("reduce-scatter", "reduce_scatter"), ("all-to-all", "all_to_all"),
         ("collective-permute", "collective_permute")]


def _port_bytes(kind: str, result: int, g: int) -> int:
    """COLLECTIVES' bytes of the collective whose HLO result is
    ``result`` bytes: a reduce-scatter's input, the result elsewhere."""
    return result * g if kind == "reduce_scatter" else result


@pytest.mark.parametrize("g", [1, 2, 4, 16])
@pytest.mark.parametrize("ref_kind,kind", KINDS)
def test_link_bytes_equal_reference(ref_kind, kind, g):
    for res in (0, 40, 8192, 3 * 2 ** 20):
        assert link_bytes(kind, _port_bytes(kind, res, g), g) == \
            pytest.approx(_link_bytes(ref_kind, res, g), rel=1e-15)
        assert link_bytes(ref_kind, _port_bytes(kind, res, g), g) == \
            link_bytes(kind, _port_bytes(kind, res, g), g)


SYNTH = """
ENTRY %main.1 (p0: f32[16,16]) -> f32[16,16] {
  %ag = bf16[64,128]{1,0} all-gather(%x), channel_id=1, replica_groups=[16,16]<=[256], dimensions={0}, metadata={op_name="jit(f)/while/body/jvp(layer_stack)/dot"}
  %ar = f32[32,32]{1,0} all-reduce(%y), channel_id=2, replica_groups=[4,4]<=[16], metadata={op_name="jit(f)/opt"}
  %rs = f32[8,8]{1,0} reduce-scatter(%z), channel_id=3, replica_groups=[2,8]<=[16], dimensions={0}
  %a2a = bf16[4,16]{1,0} all-to-all(%w), channel_id=4, replica_groups=[1,16]<=[16], dimensions={0}
  %cp = f32[10]{0} collective-permute(%v), channel_id=5, source_target_pairs={{0,1}}
}
"""

# tests/test_roofline.py's SYNTH as the port's records: the all-gather
# inside the layer stack and the accumulation loop, the rest outside both
SYNTH_RECORDS = [
    {"op": "all_gather", "bytes": 64 * 128 * 2, "g": 16,
     "scope": "layer+accum"},
    {"op": "all_reduce", "bytes": 32 * 32 * 4, "g": 4},
    {"op": "reduce_scatter", "bytes": 8 * 8 * 4 * 8, "g": 8},
    {"op": "all_to_all", "bytes": 4 * 16 * 2, "g": 16},
    {"op": "collective_permute", "bytes": 40, "g": 2},
]


@pytest.mark.parametrize("trips", [(1, 1), (10, 3), (60, 2)])
def test_collective_report_reproduces_synth(trips):
    ref = ref_collective_report(SYNTH, layer_trips=trips[0],
                                accum_trips=trips[1])
    got = collective_report(SYNTH_RECORDS, layer_trips=trips[0],
                            accum_trips=trips[1])
    for key in ("total_bytes", "raw_bytes"):
        assert got[key] == pytest.approx(ref[key], rel=1e-15)
    for ref_kind, kind in KINDS:
        assert got["by_kind"][kind] == pytest.approx(
            ref["by_kind"][ref_kind], rel=1e-15)
    assert got["count"] == ref["count"] == len(parse_collectives(SYNTH))


# ----------------------------------------------------------------------
# Report tables over the same synthetic records
# ----------------------------------------------------------------------
def _write_results(root):
    res = root / "results"
    (res / "sched").mkdir(parents=True)
    (res / "sched" / "skew.json").write_text(json.dumps([
        {"config": cfg, "dist": dist, "policy": pol, "executor": ex,
         "block_m": 32, "pad_waste": 1.0 + 0.1 * i, "occupancy": 0.9 - i / 50,
         "drop_fraction": 0.01 * i, "us": 100.0 + i}
        for i, (cfg, dist, pol, ex) in enumerate(
            (c, d, p, e) for c in ("mixtral-8x7b", "qwen2-moe-57b")
            for d in ("uniform", "zipf-2.0")
            for p in ("dynamic", "fixed", "capacity_factor")
            for e in ("xla", "pallas"))]))
    (res / "serve").mkdir()
    lat = {"ttft_s": {"p50": 0.0123, "p99": 0.0456},
           "tpot_s": {"p50": 0.001, "p99": 0.002}, "queue_wait_s": None}
    cfg = {"executor": "cuda", "schedule_policy": "dynamic",
           "quant": "none", "admission": "fcfs", "kv_block_size": 16,
           "prefill_chunk": 32, "seed": 0}
    (res / "serve" / "moonshot.json").write_text(json.dumps({
        "arch": "moonshot-v1-16b-a3b", "records": [],
        "shared_prefix": [
            {"mode": "paged", "tok_per_s": 123.456, "latency": lat,
             "kv_stats": {"blocks_in_use": 3, "blocks_total": 64,
                          "prefix_hit_tokens": 48}, "config": cfg},
            {"mode": "contiguous", "tok_per_s": 99.0, "latency": {},
             "kv_stats": None, "config": None}]}))
    (res / "serve" / "loadgen_moonshot.json").write_text(json.dumps({
        "arch": "moonshot-v1-16b-a3b", "records": [
            {"pattern": pat, "config": dict(cfg, admission=adm),
             "completed": 15, "offered": 16, "goodput_rps": 1.234,
             "slo_attainment": 0.5, "ttft_p50_s": 0.1, "ttft_p99_s": None,
             "tpot_p50_s": 0.01, "tpot_p99_s": 0.02, "preempted": 2,
             "resumed": 1}
            for pat in ("burst", "poisson") for adm in ("fcfs", "slo")]}))
    (res / "spec").mkdir()
    (res / "spec" / "spec.json").write_text(json.dumps({
        "arch": "moonshot-v1-16b-a3b", "records": [
            {"sampling": "greedy", "spec_k": 0, "target_forwards": 40,
             "tokens_per_forward": 1.0},
            {"sampling": "greedy", "spec_k": 4, "draft": "smollm",
             "draft_self": False, "acceptance_rate": 0.61,
             "target_forwards": 20, "tokens_per_forward": 2.0,
             "forward_reduction": 2.0},
            {"sampling": "top_p", "spec_k": 2, "draft": "x",
             "draft_self": True, "acceptance_rate": 0.9,
             "target_forwards": 15, "tokens_per_forward": 2.6}]}))
    (res / "tuning").mkdir()
    blk = {"block_m": 128, "block_n": 64, "block_k": 32}
    (res / "tuning" / "kernel_tune.json").write_text(json.dumps({
        "records": [
            {"config": c, "kernel": k,
             "shape": {"E": 8, "M": 512, "K": 4096, "N": 14336,
                       "scheme": "none"},
             "default": dict(blk, us=150.0),
             "tuned": dict(blk, block_n=128, us=120.0), "speedup": 1.25,
             "n_candidates": 12}
            for c in ("qwen2-moe-57b", "mixtral-8x7b")
            for k in ("grouped_gemm", "fused_gate_up")]}))
    (res / "tuning" / "cache.json").write_text(json.dumps({
        "entries": {"a": 1, "b": 2}, "version": 3, "device": "H100"}))
    return res


DRYRUN_RECORDS = [
    {"arch": "qwen2-7b", "shape": "train_4k", "mesh": "16x16",
     "status": "ok", "compile_s": 12.3,
     "memory": {"argument_bytes": 3.2e9, "temp_bytes": 12.5e9},
     "cost": {"flops": 4.56e15},
     "collectives": {"total_bytes": 123.4e9}},
    {"arch": "hubert-xlarge", "shape": "decode_32k", "mesh": "16x16",
     "status": "skip", "reason": "encoder-only arch has no decode step"},
    {"arch": "deepseek-v2-236b", "shape": "decode_32k", "mesh": "2x16x16",
     "status": "ok", "compile_s": 40.0,
     "memory": {"argument_bytes": 70e9, "temp_bytes": 1e9},
     "cost": {}, "collectives": {"total_bytes": 55.5e9}},
]

TABLES = ["scheduling_table", "serving_table", "loadgen_table",
          "spec_table", "tuning_table"]


@pytest.mark.parametrize("name", TABLES)
def test_report_tables_string_equal_reference(name, tmp_path, monkeypatch):
    res = _write_results(tmp_path)
    monkeypatch.setattr(ref_report, "ROOT", tmp_path)
    ref = getattr(ref_report, name)()
    got = getattr(report, name)(res)
    assert got == ref
    assert got.count("\n") >= 3


def test_dryrun_table_string_equal_reference():
    assert report.dryrun_table(DRYRUN_RECORDS) == \
        ref_report.dryrun_table(DRYRUN_RECORDS)
    # the port's records carry the grid beside the reference's mesh key
    port = [dict(r, grid=r["mesh"], chips=256) for r in DRYRUN_RECORDS]
    assert report.dryrun_table(port) == \
        ref_report.dryrun_table(DRYRUN_RECORDS)


@pytest.mark.parametrize("name", TABLES)
def test_report_tables_say_where_records_are_missing(name, tmp_path):
    assert "no records under" in getattr(report, name)(tmp_path)


def test_fit_table():
    t = report.fit_table(DRYRUN_RECORDS)
    rows = t.splitlines()[2:]
    assert rows[0].startswith("| deepseek-v2-236b | decode_32k | 2x16x16 "
                              "| 70.00 | 1.00 | 71.00 | Y |")
    assert rows[1].endswith("| 3.20 | 12.50 | 15.70 | Y |")


def _variant_records(tmp_path):
    """A baseline and a variant record of one cell at 16x16, written as
    files (the reference reads them by path)."""
    import json
    base = {"arch": "deepseek-v2-236b", "shape": "decode_32k",
            "mesh": "16x16", "grid": "16x16", "chips": 256, "status": "ok",
            "compile_s": 1.0,
            "memory": {"argument_bytes": 7e9, "temp_bytes": 12.34e9},
            "cost": {"flops": 1e12},
            "collectives": {"total_bytes": 56.78e9}}
    var = dict(base, variant="int8", quant="int8_expert",
               memory={"argument_bytes": 4e9, "temp_bytes": 9.87e9},
               collectives={"total_bytes": 16.5e9})
    paths = []
    for name, rec in (("base", base), ("var", var)):
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps(rec))
        paths.append(p)
    return paths, base, var


def test_perf_rows_string_equal_reference(tmp_path):
    """The variant table over the same two records is the reference's,
    string for string (its seconds at 256 cards' link rate, which is the
    reference's 50 GB/s); the port takes records or paths."""
    (base_p, var_p), base, var = _variant_records(tmp_path)
    rows = [(str(var_p), "kept"), (str(base_p), "same")]
    ref = ref_report.perf_rows(rows, str(base_p), "Cell 3: deepseek")
    assert report.perf_rows(rows, str(base_p), "Cell 3: deepseek") == ref
    assert report.perf_rows([(var, "kept"), (base, "same")], base,
                            "Cell 3: deepseek") == ref
    assert "| int8 | 16.5 | 0.29x | 9.9 | 0.80x | kept |" in ref


def test_report_main_prints_the_variant_tables(tmp_path, monkeypatch,
                                              capsys):
    import sys
    (base_p, var_p), base, var = _variant_records(tmp_path)
    var_p.rename(tmp_path / "deepseek-v2-236b.decode_32k.16x16.int8.json")
    base_p.rename(tmp_path / "deepseek-v2-236b.decode_32k.16x16.json")
    monkeypatch.setattr(sys, "argv", ["report", "--results",
                                      str(tmp_path / "none"), "--dryrun",
                                      str(tmp_path)])
    report.main()
    out = capsys.readouterr().out
    assert "## Variants" in out
    assert "**deepseek-v2-236b x decode_32k, grid 16x16** — baseline: " \
           "collective 56.8 GB/dev/step (1.14 s), temp 12.3 GB/dev" in out
    assert "| int8 | 16.5 | 0.29x | 9.9 | 0.80x | quant int8_expert |" in out
    # the dry-run table lists the cell once: the variant is not a cell
    assert out.count("| deepseek-v2-236b | decode_32k | 16x16 | ok |") == 1
