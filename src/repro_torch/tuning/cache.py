"""Persistent kernel-config cache: the autotuner's memory (counterpart of
``repro.tuning.cache``; the port keeps its own copy and its own files).

Winning tile shapes are keyed by

    ``<kernel>|E<E>|K<K>|N<N>|M<bucket>|<dtype>|<scheme>|<executor>``

where the M axis is a power-of-two *shape bucket* of the routed rows T·k
(decode row counts vary step to step; tile choice does not care about the
exact count), ``dtype`` the activations' (``bfloat16``, ``float32``: the
reference's names) and ``scheme`` the kernel-level weight format
(``dense``/``int8``/``int4``).  The port's executor is ``cuda``.  Both the
sweeps (``tuning.autotune``) and the lookups (``kernels/ops.py``,
``execution/base.py``) key on T·k, so a swept entry is the one a call at
that T reads.

Two layers overlay:

* **packaged defaults**: ``default_cache.json`` next to this module, swept
  on an H100 by ``python -m repro_torch.tuning.build``;
* **local results**: ``results/tuning/cache_torch.json`` (override with
  ``$REPRO_TORCH_TUNE_CACHE``), written by the build tool on the
  deployment machine.  Local entries win.

Files are versioned: a ``version`` mismatch (or unreadable JSON) silently
invalidates the whole file, so a stale cache degrades to the kernels'
default tiles, never to a crash.

The port runs eagerly, so ``lookup_block_sizes`` is called on every GEMM
call that asks for it: its answer is memoized per key (``reset_cache``
clears the memo), and ``STATS`` counts lookups and hits."""
from __future__ import annotations

import json
import os
import pathlib
from typing import Dict, Optional

CACHE_VERSION = 1
ENV_CACHE = "REPRO_TORCH_TUNE_CACHE"
LOCAL_CACHE = os.path.join("results", "tuning", "cache_torch.json")
_PACKAGED = pathlib.Path(__file__).with_name("default_cache.json")


def dtype_name(dtype) -> str:
    """The key's name of a dtype: ``torch.bfloat16`` -> ``bfloat16`` (the
    reference's names); a string passes as is."""
    return dtype if isinstance(dtype, str) else str(dtype).replace(
        "torch.", "")


def shape_bucket(m: int) -> int:
    """Next power of two >= m (min 8): the M axis of the cache key."""
    return 8 if m <= 8 else 1 << (int(m) - 1).bit_length()


def make_key(kernel: str, *, M: int, K: int, N: int, E: int,
             dtype: str = "float32", scheme: str = "dense",
             executor: str = "cuda") -> str:
    """The canonical cache key. M is bucketed; everything else is exact."""
    return (f"{kernel}|E{E}|K{K}|N{N}|M{shape_bucket(M)}"
            f"|{dtype}|{scheme}|{executor}")


class TuneCache:
    """A dict of key -> winning config record, JSON round-trippable.

    Record schema: ``{"block_m", "block_n", "block_k", "us",
    "default_us", "source"}``: the winner's tile (``block_m`` the row tile,
    ``block_n`` the output columns an item, ``block_k`` the 64-deep K
    stage), its measured time, the default tile's time on the same
    measurement, and where the entry came from (``swept``/``manual``); the
    port's sweeps add ``spread``, the larger of the winner's and the
    default's (max - min) / min over the sweep's rounds."""

    def __init__(self, entries: Optional[Dict[str, dict]] = None,
                 device: str = ""):
        self.entries: Dict[str, dict] = dict(entries or {})
        self.device = device

    # -- persistence ----------------------------------------------------
    def to_doc(self) -> dict:
        return {"version": CACHE_VERSION, "device": self.device,
                "entries": self.entries}

    @classmethod
    def from_doc(cls, doc: dict) -> "TuneCache":
        if not isinstance(doc, dict) or doc.get("version") != CACHE_VERSION:
            raise ValueError(
                f"tune cache version "
                f"{doc.get('version') if isinstance(doc, dict) else doc!r} "
                f"!= {CACHE_VERSION} (stale cache; rebuild with "
                "python -m repro_torch.tuning.build)")
        return cls(doc.get("entries", {}), doc.get("device", ""))

    @classmethod
    def load(cls, path) -> Optional["TuneCache"]:
        """None on missing / unreadable / version-mismatched files: a stale
        cache invalidates itself rather than erroring."""
        try:
            with open(path) as f:
                return cls.from_doc(json.load(f))
        except (OSError, ValueError, json.JSONDecodeError):
            return None

    def save(self, path) -> None:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.to_doc(), indent=1, sort_keys=True)
                     + "\n")

    # -- access ---------------------------------------------------------
    def lookup(self, key: str) -> Optional[dict]:
        return self.entries.get(key)

    def put(self, key: str, *, block_m: int, block_n: int, block_k: int,
            us: Optional[float] = None, default_us: Optional[float] = None,
            source: str = "swept", **extra) -> dict:
        """``extra`` carries kernel-family-specific fields (the ``sub_block``
        family's ``block_m_min``), additive to the v1 schema."""
        rec = {"block_m": int(block_m), "block_n": int(block_n),
               "block_k": int(block_k), "source": source}
        if us is not None:
            rec["us"] = float(us)
        if default_us is not None:
            rec["default_us"] = float(default_us)
        for k, v in extra.items():
            rec[k] = int(v) if isinstance(v, (bool, int)) else v
        self.entries[key] = rec
        return rec

    def merge(self, other: Optional["TuneCache"]) -> "TuneCache":
        """Overlay ``other`` on top of self (other's entries win)."""
        if other is not None:
            self.entries.update(other.entries)
            self.device = other.device or self.device
        return self


def local_cache_path() -> str:
    return os.environ.get(ENV_CACHE, LOCAL_CACHE)


_ACTIVE: Optional[TuneCache] = None
_MEMO: Dict[tuple, Optional[dict]] = {}
STATS = {"lookups": 0, "hits": 0}


def get_cache() -> TuneCache:
    """The process-wide cache: packaged defaults overlaid by the local
    results file.  Loaded lazily once; ``reset_cache()`` drops it (tests,
    and tools that just rewrote the local file)."""
    global _ACTIVE
    if _ACTIVE is None:
        base = TuneCache.load(_PACKAGED) or TuneCache()
        _ACTIVE = base.merge(TuneCache.load(local_cache_path()))
    return _ACTIVE


def reset_cache() -> None:
    """Drop the loaded cache and the lookup memo (the next lookup reloads
    both files)."""
    global _ACTIVE
    _ACTIVE = None
    _MEMO.clear()


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def lookup_block_sizes(kernel: str, *, M: int, K: int, N: int, E: int,
                       dtype: str = "float32", scheme: str = "dense",
                       executor: str = "cuda") -> Optional[dict]:
    """The winning record for this call's shape key, or None (the caller
    keeps the default tile).  Memoized per (kernel, E, K, N, M bucket,
    dtype, scheme, executor); counted in ``STATS``."""
    memo = (kernel, E, K, N, shape_bucket(M), dtype, scheme, executor)
    try:
        rec = _MEMO[memo]
    except KeyError:
        rec = _MEMO[memo] = get_cache().lookup(make_key(
            kernel, M=M, K=K, N=N, E=E, dtype=dtype, scheme=scheme,
            executor=executor))
    STATS["lookups"] += 1
    if rec is not None:
        STATS["hits"] += 1
    return rec
