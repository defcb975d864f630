"""Dry run: one rank's step of every (arch x shape x grid) cell on fake
tensors (counterpart of ``repro.launch.dryrun``).

Per cell: build the rank's inputs under ``FakeTensorMode`` (``launch/
specs.py``: full-size parameters, optimizer state, batch and cache, cut to
the rank's blocks, without allocating), then run its step (train, prefill,
decode, or the encoder's forward) under three tools:

- ``torch.utils.flop_counter.FlopCounterMode``: the FLOPs of the rank's
  step, its ``aten`` products and the kernels' own (the kernels' shape-only
  path, ``kernels/shapes.py``, counts every scheduled row, padding
  included): the counterpart of ``cost_analysis()["flops"]``, here with
  every layer and microbatch counted;
- a memory tracker: ``argument_bytes``, the rank's parameters, optimizer
  state, batch and cache; ``temp_bytes``, the high-water mark of what the
  step allocates above them (the counterparts of ``memory_analysis()``);
- a grid of ``DryGroup``s (``distributed/group.py``): each collective
  returns a result of the right shape and records (op, bytes, group
  size), which ``analysis/collectives.py`` turns into link bytes.

The record keeps the reference's keys (``status``, ``meta``, ``memory``,
``cost``, ``collectives``; ``mesh`` is the grid) plus ``grid`` and
``chips``.  Everything is reckoned on the host: no card is used, and no
number here is a measurement of one.  A step that cannot run on fake
tensors (a read of a value on the host) is recorded as ``status:
"error"`` with the op and the file and line where it stopped.

Grids (``--grid``, data x model, or pod x data x model): ``1x1`` one
H100, ``2x4`` the eight cards of one host, ``16x16`` and ``2x16x16``
(``--multi-pod``) the reference's meshes as logical grids, for comparing
FLOPs and bytes.

Variants (the reference's flags, ``run_cell``'s arguments):
``--capacity-factor CF`` runs the MoE layers on the ``capacity_factor``
policy at headroom CF; ``--quant SCHEME`` (``--quant-experts``: its alias
for ``int8_expert``) quantizes the routed experts of a serving cell in the
fake parameters (``quantization.quantize_model``, as the engine does at
load; the kernels' shape-only ops take the payload and its scales), and a
train cell under it is ``skip``; ``--variant TAG`` goes into the record
and its file name (``<arch>.<shape>.<grid>.<TAG>.json``), which
``analysis/report.py``'s ``perf_rows`` sets against the untagged record
of the same cell.  ``--executor NAME`` (the reference's flag; its
spellings ``pallas`` and ``xla`` name ``cuda`` and ``blocks``) runs the
MoE layers on that executor instead of ``cuda``, and the record keeps
its name: under ``dense`` the FLOP counter sees every expert on every
token, under ``blocks`` the products of every scheduled block.  ``dense``
has no phases for expert parallelism: its cells that would run EP (a
serving cell with a 'model' axis past 1, a train cell on more than one
rank) are ``skip``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --grid 2x4
  python -m repro_torch.launch.dryrun --all [--grid 1x1 --grid 2x4] [--jobs 4]
  python -m repro_torch.launch.dryrun --arch deepseek-v2-236b \\
      --shape decode_32k --grid 2x4 --quant int8_expert --variant int8
  python -m repro_torch.launch.dryrun --arch moonshot-v1-16b-a3b \\
      --shape decode_32k --executor dense --variant dense
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import subprocess
import sys
import time
import traceback
import weakref

RESULT_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "torch" / "dryrun"
DEFAULT_GRIDS = ("1x1", "2x4")
GC_SLACK = 64 << 20             # bytes the memory mark may rise between
                                # two collections of reference cycles


def parse_grid(spec: str) -> dict:
    """``"2x4"`` -> {"pod": 1, "data": 2, "model": 4}; three numbers are
    pod x data x model."""
    dims = [int(x) for x in spec.split("x")]
    if len(dims) == 2:
        dims = [1] + dims
    if len(dims) != 3 or min(dims) < 1:
        raise ValueError(f"grid {spec!r}: data x model or pod x data x model")
    return dict(zip(("pod", "data", "model"), dims))


def _storages(tree) -> dict:
    """{id: (storage, bytes)} of every tensor in ``tree`` (dicts, lists,
    tuples, modules), each storage once."""
    import torch
    out = {}

    def walk(x):
        if isinstance(x, torch.nn.Module):
            for t in list(x.parameters()) + list(x.buffers()):
                walk(t)
        elif isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            out[id(st)] = (st, st.nbytes())
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(tree)
    return out


ALLOC_BLOCK = 512               # the CUDA caching allocator rounds each
ALLOC_SMALL = 1 << 20           # tensor to 512 B; past 1 MiB a block may
                                # keep an unsplit remainder of up to 1 MiB


def alloc_bytes(n: int) -> int:
    """``n`` bytes as the caching allocator's count holds them, less any
    unsplit remainder: rounded up to 512 B (0 for an empty tensor)."""
    return -(-n // ALLOC_BLOCK) * ALLOC_BLOCK


def argument_bytes(arguments: dict):
    """(bytes of each argument group and their sum, each storage once;
    the storages; each group's ``{"tensors", "alloc_bytes", "large"}``:
    its storages, their bytes as the allocator rounds them, and how many
    are past 1 MiB)."""
    seen, out, alloc = {}, {}, {}
    for name, tree in arguments.items():
        st = {k: v for k, v in _storages(tree).items() if k not in seen}
        seen.update(st)
        out[name] = sum(n for _, n in st.values())
        alloc[name] = {"tensors": len(st),
                       "alloc_bytes": sum(alloc_bytes(n)
                                          for _, n in st.values()),
                       "large": sum(alloc_bytes(n) > ALLOC_SMALL
                                    for _, n in st.values())}
    out["total"] = sum(n for _, n in seen.values())
    return out, [st for st, _ in seen.values()], alloc


def _live_bytes_mode(known=()):
    """A dispatch mode that adds up the storages the ops it sees create
    (each once, released when the storage is) and keeps the high-water
    mark: the memory tracker of a fake step.  ``known`` storages (the
    arguments) are never counted: an in-place op returns its input.

    The step leaves some tensors in reference cycles (a step's gradients
    among them), which Python frees only when its cycle collector runs:
    so the mark counts what is reachable, collecting before it rises by
    more than ``GC_SLACK`` (or 0.5 %), and does not depend on when the
    collector would have run.

    It also adds up each op's operand and result bytes (views excluded),
    the counterpart of XLA's ``bytes accessed``: the traffic of the step
    run op by op, with nothing fused but the kernels' own ops."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.weak import WeakIdKeyDictionary

    class LiveBytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.live = self.peak = self.accessed = 0
            self._seen = WeakIdKeyDictionary()
            self._collect_at = 0
            for st in known:
                self._seen[st] = 0

        def _free(self, n: int) -> None:
            self.live -= n

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not getattr(func, "is_view", False):
                self.accessed += sum(
                    t.numel() * t.element_size()
                    for t in tree_leaves((args, kwargs, out))
                    if isinstance(t, torch.Tensor))
            for t in tree_leaves(out):
                if not isinstance(t, torch.Tensor):
                    continue
                st = t.untyped_storage()
                if st in self._seen:
                    continue
                n = st.nbytes()
                self._seen[st] = n
                self.live += n
                weakref.finalize(st, self._free, n)
                if self.live > self.peak:
                    # a new high-water mark: first free what only
                    # reference cycles hold, then count what is reachable
                    if self.live > self._collect_at:
                        gc.collect()
                        self._collect_at = self.live + max(
                            GC_SLACK, self.live // 200)
                    self.peak = max(self.peak, self.live)
            return out

    return LiveBytes()


def _where(exc: BaseException) -> str:
    """The innermost frame of the port's code in ``exc``'s traceback (else
    the innermost outside torch), as ``file:line (function)``."""
    import torch
    torch_dir = pathlib.Path(torch.__file__).parent.as_posix()
    frames = traceback.extract_tb(exc.__traceback__)
    mine = [f for f in frames if "repro_torch" in f.filename
            and not f.filename.endswith(__file__.split("/")[-1])]
    outside = [f for f in frames if not f.filename.startswith(torch_dir)]
    f = (mine or outside or frames)[-1]
    name = f.filename.split("src/")[-1]
    return f"{name}:{f.lineno} ({f.name})"


def run_step(ci, grid) -> dict:
    """Run ``ci``'s step (inside the caller's ``FakeTensorMode``) under
    the FLOP counter and the memory tracker, with ``grid``'s 'model' group
    the EP group.  Returns the record's ``memory``, ``cost`` and
    ``collectives`` and the seconds the step took."""
    import contextlib

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis.collectives import collective_report, records_of
    from repro_torch.distributed import group as G
    args_b, known, args_alloc = argument_bytes(ci.arguments)
    G.reset_collectives()
    ep_ctx = (G.use_ep_group(grid.group("model")) if ci.rc.ep
              else contextlib.nullcontext())
    live = _live_bytes_mode(known)
    t0 = time.perf_counter()
    # what exists before the step is none of its garbage: frozen, it is
    # not walked by the tracker's collections (most of their time)
    gc.collect()
    gc.freeze()
    try:
        with ep_ctx, FlopCounterMode(display=False) as fc, live:
            out = ci.step_fn(*ci.args)
    finally:
        gc.unfreeze()
    seconds = time.perf_counter() - t0
    del out, known
    records = records_of(G.COLLECTIVE_GROUPS)
    by_op = {str(k): int(v) for k, v in fc.get_flop_counts()
             .get("Global", {}).items()}
    return {
        "seconds": seconds,
        "memory": {"argument_bytes": args_b["total"],
                   "argument_parts": {k: v for k, v in args_b.items()
                                      if k != "total"},
                   "argument_alloc": args_alloc,
                   "temp_bytes": live.peak, "output_bytes": None,
                   "alias_bytes": None, "code_bytes": None},
        "cost": {"flops": int(fc.get_total_flops()), "flops_by_op": by_op,
                 "bytes accessed": live.accessed},
        "collectives": dict(collective_report(records), records=records),
    }


def run_cell(arch: str, shape_name, grid_spec: str = "1x1", *,
             accum=None, cfg=None, rc=None, optimizer: bool = True,
             capacity_factor=None, quant: str = "none",
             executor=None, variant: str = "") -> dict:
    """The record of one cell: ``skip`` where ``cell_is_runnable`` says
    so, ``ok`` with the step's numbers, or ``error`` with where it
    stopped.  ``shape_name`` names one of ``SHAPES`` (or is a
    ``ShapeConfig``); ``cfg`` replaces the arch's config (a reduced one),
    ``rc`` the dry run's ``RunConfig``; ``optimizer=False`` runs a train
    cell as one forward and backward (``specs.cell_inputs``).

    The variants: ``capacity_factor`` runs the MoE layers on the
    ``capacity_factor`` policy at that headroom (the only policy with a
    capacity; it also sizes the static EP layout of a decode cell on a
    grid); ``quant`` compresses a serving cell's routed experts under that
    scheme (a train cell is ``skip``: the port trains no quantized
    experts); ``executor`` runs the MoE layers on that registered
    executor (a schedule-free one skips the cells that would run EP);
    ``variant`` tags the record (and ``main``'s file name)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.roofline import grid_chips, link_rate
    from repro_torch.configs import (SHAPE_BY_NAME, cell_is_runnable,
                                     get_config)
    from repro_torch.distributed.group import dry_grid
    from repro_torch.execution import get_executor
    from repro_torch.launch.specs import cell_inputs, dryrun_runconfig

    shape = (SHAPE_BY_NAME[shape_name] if isinstance(shape_name, str)
             else shape_name)
    cfg = cfg or get_config(arch)
    chips = grid_chips(grid_spec)
    rec: dict = {"arch": arch, "shape": shape.name, "mesh": grid_spec,
                 "grid": grid_spec, "chips": chips, "rank": 0}
    if variant:
        rec["variant"] = variant
    sizes = parse_grid(grid_spec)
    if capacity_factor is not None or quant != "none" \
            or executor is not None:
        rc = rc or dryrun_runconfig(cfg, shape, ep=sizes["model"] > 1)
        if executor is not None:
            rc = rc._replace(executor=executor)
            rec["executor"] = executor
        if capacity_factor is not None:
            rc = rc._replace(schedule_policy="capacity_factor",
                             capacity_factor=capacity_factor)
            rec["capacity_factor"] = capacity_factor
        if quant != "none":
            rc = rc._replace(quant=quant)
    if rc is not None and rc.quant != "none":
        rec["quant"] = rc.quant
    ok, why = cell_is_runnable(cfg, shape)
    if ok and rc is not None and rc.quant != "none" \
            and shape.kind == "train":
        ok, why = False, (f"quant {rc.quant}: the port trains no quantized "
                          "experts (serving cells only)")
    if ok and rc is not None and cfg.is_moe \
            and not get_executor(rc.executor).needs_schedule \
            and (sizes["model"] > 1
                 or (shape.kind == "train" and chips > 1)):
        ok, why = False, (f"executor {rc.executor}: no schedule, so no "
                          "expert parallelism (blocks or cuda)")
    if not ok:
        rec.update(status="skip", reason=why)
        return rec
    grid = dry_grid(sizes["data"], sizes["model"], sizes["pod"])
    rec["links"] = link_rate(chips)[1]       # past one host: an assumption
    t0 = time.perf_counter()
    try:
        with FakeTensorMode(allow_non_fake_inputs=False):
            ci = cell_inputs(arch, shape, grid, rc, accum=accum, cfg=cfg,
                             optimizer=optimizer)
            t_inputs = time.perf_counter() - t0
            res = run_step(ci, grid)
        rec.update(status="ok", inputs_s=round(t_inputs, 1),
                   compile_s=round(res["seconds"], 1),
                   meta=dict(ci.meta, grid=grid_spec, rank=0),
                   memory=res["memory"], cost=res["cost"],
                   collectives=res["collectives"])
    except Exception as e:  # noqa: BLE001 - a failing cell is a report
        rec.update(status="error", error=f"{type(e).__name__}: {e}"[:2000],
                   where=_where(e),
                   traceback=traceback.format_exc()[-4000:])
    return rec


def all_cells():
    from repro_torch.configs import ARCH_NAMES, SHAPES
    return [(a, s.name) for a in ARCH_NAMES for s in SHAPES]


def cell_file(arch: str, shape: str, grid: str, variant: str = "") -> str:
    """A record's file name: ``<arch>.<shape>.<grid>[.<variant>].json``."""
    return f"{arch}.{shape}.{grid}" + (f".{variant}" if variant else "") \
        + ".json"


def _sweep(out: pathlib.Path, grids, jobs: int, timeout: float,
           variant: dict) -> int:
    """Every cell on every grid, each in a subprocess (fault isolation, a
    fresh fake mode; its errors in ``<cell>.log`` beside its record, kept
    where it failed), ``jobs`` at a time, each with ``variant``'s flags;
    cells already ``ok`` or ``skip`` are not run again.  Returns the count
    that ended neither."""
    flags = []
    if variant["capacity_factor"] is not None:
        flags += ["--capacity-factor", str(variant["capacity_factor"])]
    if variant["quant"] != "none":
        flags += ["--quant", variant["quant"]]
    if variant["executor"] is not None:
        flags += ["--executor", variant["executor"]]
    if variant["variant"]:
        flags += ["--variant", variant["variant"]]
    todo = []
    for arch, shape in all_cells():
        for g in grids:
            dest = out / cell_file(arch, shape, g, variant["variant"])
            if dest.exists() and json.loads(dest.read_text()).get(
                    "status") in ("ok", "skip"):
                print(f"[done   ] {arch}.{shape}.{g}", flush=True)
                continue
            todo.append((arch, shape, g, dest))
    failures, running = 0, []

    def reap(block: bool):
        nonlocal failures
        for item in list(running):
            (arch, shape, g, dest), p, t0 = item
            status = "?"
            if p.poll() is None:
                if time.time() - t0 < timeout:
                    continue
                p.kill()
                p.wait()
                status = "timeout"
            running.remove(item)
            if dest.exists():
                status = json.loads(dest.read_text()).get("status")
            print(f"[{status:7s}] {arch}.{shape}.{g}  "
                  f"{time.time() - t0:6.1f}s", flush=True)
            log = dest.with_suffix(".log")
            if status not in ("ok", "skip"):
                failures += 1
                if log.exists():
                    print(log.read_text()[-2000:], flush=True)
            elif log.exists():
                log.unlink()
        if block and running:
            time.sleep(0.5)

    for cell in todo:
        while len(running) >= jobs:
            reap(block=True)
        arch, shape, g, dest = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--grid", g, "--out", str(out)] \
            + flags
        with open(dest.with_suffix(".log"), "w") as log:
            running.append((cell, subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=log), time.time()))
    while running:
        reap(block=True)
    return failures


def main() -> int:
    from repro_torch.execution import available_executors, executor_cli_name
    from repro_torch.quantization import available_schemes, resolve_quant_cli
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--grid", action="append", default=None,
                    help="data x model or pod x data x model (repeatable "
                         "with --all); default 1x1, with --all 1x1 and 2x4")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's multi-pod mesh: grid 2x16x16")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=2,
                    help="--all: cells run at once")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="--all: seconds a cell may take")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--capacity-factor", type=float, default=None,
                    help="the MoE layers on the capacity_factor policy at "
                         "this headroom")
    ap.add_argument("--quant", default=None, choices=available_schemes(),
                    help="expert-weight quantization scheme of the serving "
                         "cells (a train cell is skipped); default: none")
    ap.add_argument("--quant-experts", action="store_true",
                    help="DEPRECATED: alias for --quant int8_expert")
    ap.add_argument("--executor", default=None, type=executor_cli_name,
                    choices=available_executors(),
                    help="MoE executor of every cell (default: cuda; the "
                         "reference's pallas and xla name cuda and blocks)")
    ap.add_argument("--variant", default="",
                    help="tag of the record, appended to its file name")
    ap.add_argument("--out", default=str(RESULT_DIR))
    args = ap.parse_args()
    quant = resolve_quant_cli(args.quant, args.quant_experts)
    variant = dict(capacity_factor=args.capacity_factor, quant=quant,
                   executor=args.executor, variant=args.variant)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    grids = args.grid or (list(DEFAULT_GRIDS) if args.all else ["1x1"])
    if args.multi_pod:
        grids = ["2x16x16"]

    if args.all:
        return 1 if _sweep(out, grids, args.jobs, args.timeout,
                           variant) else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    rc = 0
    for g in grids:
        rec = run_cell(args.arch, args.shape, g, accum=args.accum, **variant)
        dest = out / cell_file(args.arch, args.shape, g, args.variant)
        dest.write_text(json.dumps(rec, indent=2))
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in ("traceback", "collectives")},
                         indent=2))
        if rec["status"] == "error":
            print(rec.get("traceback", ""), file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
