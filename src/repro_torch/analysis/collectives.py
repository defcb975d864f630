"""Collective traffic of a step: link bytes a rank from the collectives the
port's groups record (counterpart of ``repro.analysis.hlo``).

The reference parses XLA's HLO text for each collective's result shape
and replica-group size; the port has no HLO.  Its groups
(``distributed/group.py``) record every collective they run instead: the
op, the bytes ``COLLECTIVES`` counts and the group size ``g``
(``COLLECTIVE_GROUPS``); the dry run's groups do the same on fake tensors
(``launch/dryrun.py``).  The ring formulas are the reference's:

    all_reduce       2 * bytes * (g-1)/g      (bytes = the input)
    all_gather       bytes * (g-1)/g          (bytes = the gathered result)
    reduce_scatter   bytes * (g-1)/g          (bytes = the input, which is
                                               the reference's result x g)
    all_to_all       bytes * (g-1)/g
    collective_permute  bytes

Names take the reference's spelling too (``all-gather``).  The bytes are
the convention ``COLLECTIVES`` counts: a reduce-scatter's INPUT, where the
reference's formula starts from its result, so ``link_bytes`` of a
reduce-scatter of input ``b`` equals the reference's of result ``b / g``.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable

KINDS = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all",
         "collective_permute")


def _kind(kind: str) -> str:
    k = kind.replace("-", "_")
    if k not in KINDS:
        raise ValueError(f"unknown collective {kind!r}; one of {KINDS}")
    return k


def link_bytes(kind: str, nbytes: float, g: int) -> float:
    """Bytes one rank sends over its links for one collective of ``nbytes``
    (``COLLECTIVES``' convention) over ``g`` ranks (ring formulas)."""
    k = _kind(kind)
    if k == "collective_permute":
        return float(nbytes)
    if g <= 1:
        return 0.0
    f = (g - 1) / g
    if k == "all_reduce":
        return 2.0 * nbytes * f
    return nbytes * f


def records_of(groups: Dict) -> list:
    """``COLLECTIVE_GROUPS`` ({(op, g): [calls, bytes]}) -> records
    ``{"op", "g", "calls", "bytes"}`` in a stable order."""
    return [{"op": op, "g": g, "calls": c, "bytes": b}
            for (op, g), (c, b) in sorted(groups.items())]


def collective_report(records: Iterable[Dict], layer_trips: int = 1,
                      accum_trips: int = 1) -> Dict:
    """Aggregate link bytes over ``records`` (each ``{"op", "bytes", "g"}``
    with optional ``"scope"``: ``"layer"`` for a collective inside the
    layer stack, ``"accum"`` inside the microbatch loop only,
    ``"layer+accum"`` both), with the reference's structural multipliers:
    x ``layer_trips`` inside the layer stack, and x ``accum_trips`` inside
    the microbatch loop.  The dry run runs every layer and every
    microbatch, so its records come with trips of 1."""
    by_kind: Dict[str, float] = defaultdict(float)
    by_kind_raw: Dict[str, float] = defaultdict(float)
    total = raw = 0.0
    n = 0
    for r in records:
        scope = r.get("scope", "")
        lb = link_bytes(r["op"], r["bytes"], r["g"])
        mult = 1
        if "layer" in scope:
            mult *= layer_trips
        if accum_trips > 1 and "accum" in scope:
            mult *= accum_trips
        k = _kind(r["op"])
        by_kind[k] += lb * mult
        by_kind_raw[k] += lb
        total += lb * mult
        raw += lb
        n += int(r.get("calls", 1))
    return {"total_bytes": total, "raw_bytes": raw,
            "by_kind": dict(by_kind), "by_kind_raw": dict(by_kind_raw),
            "count": n, "layer_trips": layer_trips,
            "accum_trips": accum_trips}
