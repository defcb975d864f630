"""Roofline assembly on the H100: three terms per (arch x shape x grid)
cell (counterpart of ``repro.analysis.roofline``).

    compute term    = FLOPs / (chips x 989e12 bf16 FLOP/s)
    memory term     = HBM bytes a card / 3.35e12 B/s
    collective term = link bytes a card / the link rate

Constants are NVIDIA's H100 SXM data sheet (dense bf16 tensor-core rate,
HBM3 rate and size; NVLink 900 GB/s a card to the others of its host, 450
GB/s each way), at the card's full 700 W: a card set to a lower
``power.limit`` runs slower under load, so print its limit beside any
number taken from these.  A grid wider than one host (8 cards) crosses
hosts, where the rate is ``INTER_HOST_BW``: an assumption, not a
measurement (one 400 Gb/s ConnectX-7 port a card, as NVIDIA's DGX H100
data sheet lists them), named as such in each record.

FLOPs and HBM bytes come from the analytic model (``analysis.flops``,
with the grid's EP size); the dry run's own counts (``FlopCounterMode``'s
FLOPs; its ``bytes accessed``, every op's operand and result bytes) are
carried as ``hlo_raw_*`` for comparison; collective bytes are the dry run's records through the ring
formulas (``analysis.collectives``).  The card count comes from the
record's grid, not from a mesh name."""
from __future__ import annotations

import json
import pathlib
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.analysis.flops import cell_cost
from repro_torch.configs import SHAPE_BY_NAME, get_config

CARD = "NVIDIA H100 SXM (data sheet, 700 W)"
PEAK_FLOPS = 989e12          # dense bf16 tensor cores, FLOP/s a card
HBM_BW = 3.35e12             # B/s a card
HBM_PER_CHIP = 80e9          # bytes a card, for fit checks
NVLINK_BW = 450e9            # B/s each way, card to card inside a host
CARDS_PER_HOST = 8
INTER_HOST_BW = 50e9         # B/s a card across hosts: ASSUMED, one 400
                             # Gb/s ConnectX-7 port a card (DGX H100 data
                             # sheet); not measured here
INTER_HOST_SOURCE = ("assumption: 400 Gb/s a card (one ConnectX-7 port "
                     "a card, NVIDIA DGX H100 data sheet); not measured")


def bound_ms(n_bytes: float, flops: float):
    """(the least ms a card takes for ``n_bytes`` of HBM traffic and
    ``flops`` bf16 operations, "bytes" or "operations": which bounds)."""
    t_bytes = n_bytes / HBM_BW * 1e3
    t_ops = flops / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def link_rate(chips: int) -> tuple:
    """(B/s a card's collectives move at, its source) on ``chips`` cards:
    NVLink inside one host, the assumed inter-host rate past it."""
    if chips <= CARDS_PER_HOST:
        return NVLINK_BW, "NVLink 450 GB/s each way (H100 SXM data sheet)"
    return INTER_HOST_BW, INTER_HOST_SOURCE


def grid_chips(grid: str) -> int:
    """``"2x4"`` -> 8, ``"2x16x16"`` -> 512."""
    n = 1
    for part in str(grid).split("x"):
        n *= int(part)
    return n


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    dispatch_flops: float
    flops_ratio: float          # MODEL / dispatched (useful fraction)
    hlo_raw_flops: Optional[float]
    hlo_raw_bytes: Optional[float]
    collective_bytes: float
    temp_bytes_per_dev: Optional[float]
    fits_hbm: Optional[bool]
    note: str = ""
    link_source: str = ""

    def step_time_s(self) -> float:
        """Perfect-overlap bound: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the step-time bound (an MFU bound)."""
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        t = self.step_time_s()
        return ideal / t if t > 0 else 0.0


_NOTES = {
    "compute": "compute-bound: raise useful-FLOP fraction (cut remat/"
               "capacity waste) or grow per-card arithmetic intensity",
    "memory": "HBM-bound: cut weight/cache re-reads (fuse gate+up, batch "
              "more tokens per weight load, quantize cache)",
    "collective": "link-bound: shrink per-layer gathers (gather bf16 not "
                  "fp32, overlap a2a with expert GEMMs, widen DP axis)",
}


def record_chips(record: Dict) -> int:
    """The record's card count: ``chips``, else its ``grid``'s (or a
    reference record's ``mesh``) product."""
    if record.get("chips"):
        return int(record["chips"])
    return grid_chips(record.get("grid") or record["mesh"])


def record_ep(record: Dict) -> Optional[int]:
    """The record's EP size (``meta["ep"]``); None (16, the reference's)
    for a record without one."""
    ep = (record.get("meta") or {}).get("ep")
    return int(ep) if ep else None


def analyze_cell(record: Dict, *, capacity_factor: float = 2.0) -> Roofline:
    cfg = get_config(record["arch"])
    shape = SHAPE_BY_NAME[record["shape"]]
    chips = record_chips(record)
    accum = (record.get("meta") or {}).get("accum", 1)
    cost = cell_cost(cfg, shape, chips=chips, accum=accum,
                     capacity_factor=capacity_factor,
                     remat=(shape.kind == "train"),
                     ep=record_ep(record))

    coll_bytes = (record.get("collectives") or {}).get("total_bytes", 0.0)
    rate, source = link_rate(chips)
    compute_s = cost.dispatch_flops / (chips * PEAK_FLOPS)
    memory_s = cost.hbm_bytes / HBM_BW             # hbm_bytes is per card
    collective_s = coll_bytes / rate               # per-card link bytes
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)

    temp = (record.get("memory") or {}).get("temp_bytes")
    arg = (record.get("memory") or {}).get("argument_bytes") or 0
    fits = None
    if temp is not None:
        fits = (temp + arg) <= HBM_PER_CHIP

    return Roofline(
        arch=record["arch"], shape=record["shape"],
        mesh=record.get("grid") or record["mesh"], chips=chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant,
        model_flops=cost.model_flops,
        dispatch_flops=cost.dispatch_flops,
        flops_ratio=cost.model_flops / max(cost.dispatch_flops, 1.0),
        hlo_raw_flops=(record.get("cost") or {}).get("flops"),
        hlo_raw_bytes=(record.get("cost") or {}).get("bytes accessed"),
        collective_bytes=coll_bytes,
        temp_bytes_per_dev=temp,
        fits_hbm=fits,
        note=_NOTES[dominant],
        link_source=source,
    )


def load_results(result_dir: str):
    out = []
    for p in sorted(pathlib.Path(result_dir).glob("*.json")):
        try:
            out.append(json.loads(p.read_text()))
        except Exception:
            pass
    return out


def markdown_table(rooflines) -> str:
    hdr = ("| arch | shape | grid | compute s | memory s | collective s | "
           "bottleneck | MODEL/HLO | roofline frac | fits HBM |")
    sep = "|" + "---|" * 10
    rows = [hdr, sep]
    for r in rooflines:
        rows.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.compute_s:.3e} | "
            f"{r.memory_s:.3e} | {r.collective_s:.3e} | {r.dominant} | "
            f"{r.flops_ratio:.2f} | {r.roofline_fraction():.2%} | "
            f"{'Y' if r.fits_hbm else 'N' if r.fits_hbm is not None else '?'} |")
    return "\n".join(rows)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or a
    line that says the figures are the data sheet's at 700 W."""
    import shutil
    import subprocess
    smi = shutil.which("nvidia-smi")
    if smi:
        out = subprocess.run([smi, "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    return f"no card here: bounds are the {CARD}'s"


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results/torch/dryrun")
    ap.add_argument("--grid", default=None)
    args = ap.parse_args()
    recs = [r for r in load_results(args.results) if r.get("status") == "ok"]
    if args.grid:
        recs = [r for r in recs if r.get("grid") == args.grid]
    rl = [analyze_cell(r) for r in recs]
    print(f"card: {card_line()}")
    print(markdown_table(rl))
    for r in rl:
        print(f"  {r.arch}/{r.shape}/{r.mesh}: {r.dominant} -> {r.note} "
              f"(links: {r.link_source})")


if __name__ == "__main__":
    main()
