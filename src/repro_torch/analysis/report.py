"""Markdown tables over the port's result records (counterpart of
``repro.analysis.report``).

Every table reads the reference's record formats under a results
directory passed in (``results_dir``): ``sched/*.json`` (skew study),
``serve/*.json`` and ``serve/loadgen_*.json`` (serving, goodput),
``spec/*.json`` (speculation), ``tuning/kernel_tune*.json`` and
``tuning/cache.json`` (kernel tuning), and the dry run's records
(``launch/dryrun.py``, by default under ``results/torch/dryrun``) for the
dry-run and roofline tables.  The tables are the reference's, string for
string on the same records.  ``perf_rows`` is the reference's variant
table (a dry run's ``--variant`` records against the untagged record of
the same cell); its seconds are at the link rate of the baseline's grid
(``roofline.link_rate``), which past one host is the reference's 50 GB/s
a card.  The reference's TPU-round verdicts and TPU constants are not
carried over.

    PYTHONPATH=src python -m repro_torch.analysis.report \
        [--results results/torch] [--dryrun results/torch/dryrun]
"""
from __future__ import annotations

import json
import pathlib

from repro_torch.analysis.roofline import (CARD, analyze_cell, card_line,
                                           grid_chips, link_rate,
                                           load_results, markdown_table)


def _grid(r) -> str:
    return r.get("grid") or r["mesh"]


def _no_records(where) -> str:
    return f"_(no records under {where})_"


def _rel(p: pathlib.Path, results_dir) -> str:
    base = pathlib.Path(results_dir).parent
    try:
        return p.relative_to(base).as_posix()
    except ValueError:
        return p.as_posix()


def dryrun_table(recs):
    """The dry run's records (``launch/dryrun.py``): per-rank bytes, the
    FlopCounterMode FLOPs and the link bytes of the recorded collectives.
    ``compile s`` is the seconds the fake step took to run."""
    rows = ["| arch | shape | mesh | status | compile s | arg GB/dev | "
            "temp GB/dev | HLO GFLOP/dev | coll GB/dev (corrected) |",
            "|" + "---|" * 9]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], _grid(r))):
        if r["status"] == "skip":
            rows.append(f"| {r['arch']} | {r['shape']} | {_grid(r)} | "
                        f"SKIP ({r['reason']}) | | | | | |")
            continue
        m, c = r["memory"], r.get("cost", {})
        rows.append(
            f"| {r['arch']} | {r['shape']} | {_grid(r)} | ok | "
            f"{r['compile_s']} | {m['argument_bytes'] / 1e9:.2f} | "
            f"{m['temp_bytes'] / 1e9:.2f} | "
            f"{(c.get('flops') or 0) / 1e9:.0f} | "
            f"{r['collectives']['total_bytes'] / 1e9:.1f} |")
    return "\n".join(rows)


_POLICY_ORDER = {"fixed": 0, "capacity_factor": 1, "dynamic": 2}


def scheduling_table(results_dir):
    """ScheduleStats telemetry of a skew study (``<results>/sched/*.json``,
    lists of records): the three schedule policies head-to-head."""
    sched_dir = pathlib.Path(results_dir) / "sched"
    recs = []
    if sched_dir.exists():
        for p in sorted(sched_dir.glob("*.json")):
            recs.extend(json.loads(p.read_text()))
    if not recs:
        return _no_records(sched_dir)
    rows = ["| config | dist | policy | executor | M | pad waste | "
            "occupancy | drop | CPU us |",
            "|" + "---|" * 9]
    for r in sorted(recs, key=lambda r: (r["config"], r["dist"],
                                         _POLICY_ORDER.get(r["policy"], 9),
                                         r.get("executor", "xla"))):
        rows.append(
            f"| {r['config']} | {r['dist']} | {r['policy']} | "
            f"{r.get('executor', 'xla')} | "
            f"{r['block_m']} | {r['pad_waste']:.2f}x | "
            f"{r['occupancy']:.1%} | {r['drop_fraction']:.1%} | "
            f"{r['us']:.0f} |")
    worst = max((r for r in recs if r["policy"] == "fixed"),
                key=lambda r: r["pad_waste"], default=None)
    twin = None if worst is None else next(
        (r for r in recs
         if r["policy"] == "dynamic"
         and (r["config"], r["dist"]) == (worst["config"],
                                          worst["dist"])), None)
    if twin is not None:
        rows.append(
            f"\nWorst fixed-policy cell: {worst['config']}/{worst['dist']} "
            f"pads {worst['pad_waste']:.2f}x; dynamic schedules the same "
            f"assignment at {twin['pad_waste']:.2f}x "
            f"({twin['occupancy']:.0%} block occupancy).")
    return "\n".join(rows)


def _load_serve_docs(results_dir, name_filter):
    serve_dir = pathlib.Path(results_dir) / "serve"
    docs = []
    if serve_dir.exists():
        for p in sorted(serve_dir.glob("*.json")):
            if not name_filter(p.name):
                continue
            try:
                d = json.loads(p.read_text())
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue
            if isinstance(d, dict) and "records" in d:
                docs.append(d)
    return docs


def _cfg_str(c):
    """Compact self-describing cell config (the ``config`` block a serving
    record carries)."""
    if not c:
        return "—"
    seed = c.get("seed")
    return (f"{c.get('executor', '?')}/{c.get('schedule_policy', '?')}"
            f"/q:{c.get('quant', 'none')} adm={c.get('admission', '?')} "
            f"kvb={c.get('kv_block_size')} pc={c.get('prefill_chunk')}"
            + (f" seed={seed}" if seed is not None else ""))


def _ms(agg):
    return (f"{agg['p50'] * 1e3:.1f} / {agg['p99'] * 1e3:.1f}"
            if agg else "—")


def serving_table(results_dir):
    """Per-request latency + paged-cache telemetry of the serving records
    (``<results>/serve/*.json``): the shared-prefix workload cells carry
    TTFT/TPOT aggregates (nearest-rank p50/p99 over retired requests,
    ``obs.latency``), the final ``PagedKVCache.stats()`` snapshot, and the
    self-describing cell config."""
    docs = _load_serve_docs(results_dir,
                            lambda n: not n.startswith("loadgen_"))
    cells = [(d.get("arch", "?"), r) for d in docs
             for r in d.get("shared_prefix") or []]
    if not cells:
        return _no_records(pathlib.Path(results_dir) / "serve")

    rows = ["| arch | mode | tok/s | TTFT p50/p99 ms | TPOT p50/p99 ms | "
            "queue p50/p99 ms | kv in-use/total | prefix hit tok | "
            "config |",
            "|" + "---|" * 9]
    for arch, r in cells:
        lat = r.get("latency") or {}
        kv = r.get("kv_stats")
        rows.append(
            f"| {arch} | {r['mode']} | {r['tok_per_s']:.1f} | "
            f"{_ms(lat.get('ttft_s'))} | {_ms(lat.get('tpot_s'))} | "
            f"{_ms(lat.get('queue_wait_s'))} | "
            + (f"{kv['blocks_in_use']}/{kv['blocks_total']} | "
               f"{kv['prefix_hit_tokens']} | " if kv else "— | — | ")
            + f"{_cfg_str(r.get('config'))} |")
    return "\n".join(rows)


def loadgen_table(results_dir):
    """Goodput under SLO (``<results>/serve/loadgen_*.json``): every cell
    is one seeded arrival trace replayed on virtual time through the
    open-stream front-end under one admission policy
    (``serve/loadgen.py``)."""
    docs = _load_serve_docs(results_dir, lambda n: n.startswith("loadgen_"))
    cells = [(d.get("arch", "?"), r) for d in docs
             for r in d.get("records") or []]
    if not cells:
        return _no_records(pathlib.Path(results_dir) / "serve" /
                           "loadgen_*.json")
    rows = ["| arch | pattern | admission | done/offered | goodput req/s | "
            "SLO attain | TTFT p50/p99 s | TPOT p50/p99 s | pre/res | "
            "config |",
            "|" + "---|" * 10]

    def s(v):
        return f"{v:.2f}" if v is not None else "—"

    for arch, r in sorted(cells, key=lambda c: (c[0], c[1].get("pattern")
                                                or "?")):
        cfg = dict(r.get("config") or {})
        adm = cfg.get("admission", "?")
        rows.append(
            f"| {arch} | {r.get('pattern', '?')} | {adm} | "
            f"{r['completed']}/{r['offered']} | "
            f"{r['goodput_rps']:.3f} | {r['slo_attainment']:.2f} | "
            f"{s(r.get('ttft_p50_s'))} / {s(r.get('ttft_p99_s'))} | "
            f"{s(r.get('tpot_p50_s'))} / {s(r.get('tpot_p99_s'))} | "
            f"{r['preempted']}/{r['resumed']} | {_cfg_str(cfg)} |")
    return "\n".join(rows)


def spec_table(results_dir):
    """Speculative-decoding sweep (``<results>/spec/*.json``): acceptance
    rate and decode tokens per target forward vs the k=0 baseline, per
    (sampling, k, draft) cell."""
    spec_dir = pathlib.Path(results_dir) / "spec"
    cells = []
    for p in sorted(spec_dir.glob("*.json")) if spec_dir.exists() else []:
        try:
            d = json.loads(p.read_text())
        except (json.JSONDecodeError, UnicodeDecodeError):
            continue
        cells.extend((d.get("arch", "?"), r) for r in d.get("records") or [])
    if not cells:
        return _no_records(spec_dir)
    rows = ["| arch | sampling | k | draft | accept | tgt fwd | "
            "tok/fwd | fwd win |",
            "|" + "---|" * 8]
    for arch, r in sorted(cells, key=lambda c: (c[0], c[1]["sampling"],
                                                c[1]["spec_k"],
                                                c[1].get("draft", ""))):
        if r["spec_k"] == 0:
            rows.append(f"| {arch} | {r['sampling']} | 0 | — | — | "
                        f"{r['target_forwards']} | "
                        f"{r['tokens_per_forward']:.2f} | baseline |")
        else:
            dname = "self" if r.get("draft_self") else r.get("draft", "?")
            rows.append(f"| {arch} | {r['sampling']} | {r['spec_k']} | "
                        f"{dname} | {r['acceptance_rate']:.2f} | "
                        f"{r['target_forwards']} | "
                        f"{r['tokens_per_forward']:.2f} | "
                        f"{r.get('forward_reduction', 0):.2f}x |")
    return "\n".join(rows)


def tuning_table(results_dir):
    """Kernel-autotuner sweep (``<results>/tuning/kernel_tune*.json``):
    per (paper config, kernel) cell, the default tile config vs the swept
    winner on the same microbenchmark, plus the persistent cache's
    footprint (``<results>/tuning/cache.json``)."""
    tune_dir = pathlib.Path(results_dir) / "tuning"
    rows_in = []
    for p in sorted(tune_dir.glob("kernel_tune*.json")) \
            if tune_dir.exists() else []:
        try:
            d = json.loads(p.read_text())
        except (json.JSONDecodeError, UnicodeDecodeError):
            continue
        rows_in.extend((d, r) for r in d.get("records") or [])
    if not rows_in:
        return _no_records(tune_dir / "kernel_tune*.json")

    def blk(c):
        return f"({c['block_m']},{c['block_n']},{c['block_k']})"

    rows = ["| config | kernel | shape (E,M,K,N) | scheme | "
            "default blocks / us | tuned blocks / us | speedup | cands |",
            "|" + "---|" * 8]
    for doc, r in sorted(rows_in, key=lambda x: (x[1]["config"],
                                                 x[1]["kernel"])):
        s = r["shape"]
        rows.append(
            f"| {r['config']} | {r['kernel']} | "
            f"({s['E']},{s['M']},{s['K']},{s['N']}) | {s['scheme']} | "
            f"{blk(r['default'])} {r['default']['us']:.0f} | "
            f"{blk(r['tuned'])} {r['tuned']['us']:.0f} | "
            f"{r['speedup']:.2f}x | {r['n_candidates']} |")
    cache_p = tune_dir / "cache.json"
    if cache_p.exists():
        try:
            c = json.loads(cache_p.read_text())
            rows.append(f"\nPersistent cache: {len(c.get('entries', {}))} "
                        f"entries (version {c.get('version')}, device "
                        f"{c.get('device') or '?'}) in "
                        f"{_rel(cache_p, results_dir)}.")
        except (json.JSONDecodeError, UnicodeDecodeError):
            pass
    return "\n".join(rows)


def fit_table(recs) -> str:
    """Each ok record's bytes a rank against one card's 80 GB: arguments
    (parameters, optimizer state, batch, cache), the high-water mark above
    them, and the verdict."""
    from repro_torch.analysis.roofline import HBM_PER_CHIP
    rows = ["| arch | shape | grid | arg GB/rank | temp GB/rank | "
            "peak GB/rank | fits 80 GB |", "|" + "---|" * 7]
    for r in sorted((r for r in recs if r.get("status") == "ok"),
                    key=lambda r: (r["arch"], r["shape"], _grid(r))):
        m = r["memory"]
        peak = m["argument_bytes"] + m["temp_bytes"]
        rows.append(f"| {r['arch']} | {r['shape']} | {_grid(r)} | "
                    f"{m['argument_bytes'] / 1e9:.2f} | "
                    f"{m['temp_bytes'] / 1e9:.2f} | {peak / 1e9:.2f} | "
                    f"{'Y' if peak <= HBM_PER_CHIP else 'N'} |")
    return "\n".join(rows)


def _record(r) -> dict:
    """A dry-run record, or the one a path names."""
    return r if isinstance(r, dict) else json.loads(
        pathlib.Path(r).read_text())


def _ratio(v: float, base: float) -> str:
    return f"{v / base:.2f}x" if base else "—"


def perf_rows(records, baseline, label: str) -> str:
    """The reference's variant table: ``records`` are ``(record, verdict)``
    pairs (a record or the path of one), each row its link bytes of the
    collectives and its temporary bytes beside the ``baseline``'s and the
    verdict.  The heading gives the baseline's link bytes in seconds at its
    grid's link rate; a ratio over a baseline of 0 bytes (one card, no
    collective) is "—"."""
    base = _record(baseline)
    bc = base["collectives"]["total_bytes"]
    bt = base["memory"]["temp_bytes"]
    rate = link_rate(base.get("chips") or grid_chips(_grid(base)))[0]
    out = [f"**{label}** — baseline: collective "
           f"{bc / 1e9:.1f} GB/dev/step ({bc / rate:.2f} s), temp "
           f"{bt / 1e9:.1f} GB/dev", "",
           "| variant | collective GB | Δ coll | temp GB | Δ temp | verdict |",
           "|---|---|---|---|---|---|"]
    for r, verdict in records:
        d = _record(r)
        c = d["collectives"]["total_bytes"]
        t = d["memory"]["temp_bytes"]
        out.append(f"| {d.get('variant', 'baseline')} | {c / 1e9:.1f} | "
                   f"{_ratio(c, bc)} | {t / 1e9:.1f} | {_ratio(t, bt)} | "
                   f"{verdict} |")
    return "\n".join(out)


def variant_tables(recs) -> list:
    """``perf_rows`` of every cell whose ok records include variants, each
    against the cell's untagged ok record; a variant's verdict is what it
    changed (its capacity factor, its quantization)."""
    base = {(r["arch"], r["shape"], _grid(r)): r for r in recs
            if r.get("status") == "ok" and not r.get("variant")}
    cells: dict = {}
    for r in recs:
        key = (r["arch"], r["shape"], _grid(r))
        if r.get("status") == "ok" and r.get("variant") and key in base:
            cells.setdefault(key, []).append(r)
    tables = []
    for key in sorted(cells):
        rows = [(r, ", ".join(f"{k} {r[k]}" for k in ("capacity_factor",
                                                      "quant") if k in r)
                 or "—") for r in sorted(cells[key],
                                         key=lambda r: r["variant"])]
        tables.append(perf_rows(rows, base[key],
                                f"{key[0]} x {key[1]}, grid {key[2]}"))
    return tables


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results/torch",
                    help="directory of the sched/, serve/, spec/ and "
                         "tuning/ records")
    ap.add_argument("--dryrun", default="results/torch/dryrun",
                    help="directory of the dry run's records")
    args = ap.parse_args()
    loaded = load_results(args.dryrun)
    dr = [r for r in loaded if not r.get("variant")]
    ok = [r for r in dr if r.get("status") == "ok"]
    rl = [analyze_cell(r) for r in ok]
    grids = sorted({r.mesh for r in rl}, key=lambda g: (len(g), g))
    print(f"# Report of the port\n\nBounds: {CARD}; card here: "
          f"{card_line()}.  The dry run's bytes and FLOPs are reckoned on "
          f"the host (fake tensors), not measured on a card.\n")
    for title, table in (("Scheduling policies",
                          scheduling_table(args.results)),
                         ("Serving latency", serving_table(args.results)),
                         ("Goodput under SLO", loadgen_table(args.results)),
                         ("Speculative decoding", spec_table(args.results)),
                         ("Kernel tuning", tuning_table(args.results)),
                         ("Dry run", dryrun_table(dr)),
                         ("Fit on one card", fit_table(dr))):
        print(f"## {title}\n\n{table}\n")
    for g in grids:
        print(f"## Roofline, grid {g}\n\n" + markdown_table(sorted(
            (r for r in rl if r.mesh == g),
            key=lambda r: (r.arch, r.shape))) + "\n")
    variants = variant_tables(loaded)
    if variants:
        print("## Variants\n\n" + "\n\n".join(variants) + "\n")


if __name__ == "__main__":
    main()
