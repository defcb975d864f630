"""Process groups over ``torch.distributed``: the expert-parallel group and
the grid of ranks (counterpart of the multi-process half of
``repro.launch.mesh``).

The reference runs one jitted program over a device mesh and ``shard_map``
splits it per device.  The port runs one process per rank instead: every
rank runs the same host control flow over the same requests, and the MoE
layer's exchange (``repro_torch.core.distributed``) is the only place the
ranks talk to each other.  This module holds what that needs:

* ``init_distributed`` joins this process to a group (``--coordinator`` /
  ``--num-processes`` / ``--process-id``, or torchrun's ``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``);
* ``make_ep_group`` returns the ``EPGroup`` this rank dispatches over: its
  rank, size, process group, backend and device, and the collectives the
  exchange uses (``all_to_all`` on dim 0, sync or async, ``all_gather``,
  ``all_reduce`` sum and mean);
* ``use_ep_group`` makes a group the current one for the model's MoE
  layers (the reference's ``set_mesh``);
* ``make_grid`` places this rank on a ``pod x data x model`` grid, the
  reference's ``jax.make_mesh((pod, data, model))``: its coordinates and
  one ``EPGroup`` per axis and per set of axes (sharded training,
  ``repro_torch.distributed.sharding``); the groups add
  ``reduce_scatter`` and ``barrier`` to the collectives;
* ``spawn_ranks`` starts ``n`` rank processes from one process (the
  ``spawn`` start method) and returns each rank's result: the counterpart
  of the reference's forced host-device mesh.

**Backend rule**, printed by rank 0 when a group is made: ``nccl`` when
each rank has a card of its own; otherwise ``gloo`` (the CPU, and several
ranks on one card, which NCCL refuses).  The collectives take the tensors
where they lie, on the card too (this torch's gloo takes CUDA tensors), and
a collective that fails raises.

The reference's ``make_production_mesh``, ``make_debug_mesh`` and
``multiprocess_compute_supported`` have no counterpart: they build XLA
device meshes, and torch's gloo runs multi-process compute on the CPU."""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import socket
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device

# Every collective this process ran over more than one rank: op -> [calls,
# bytes, seconds]: the bytes of the whole tensor (an all_gather's result, a
# reduce_scatter's or all_reduce's input, an all_to_all's input) and the
# host's seconds inside the call; and (op, group size) -> [calls, bytes]
# in ``COLLECTIVE_GROUPS``, which ``analysis.collectives`` turns into link
# bytes.  Host counters only; ``reset_collectives`` zeroes them.
COLLECTIVES: dict = {}
COLLECTIVE_GROUPS: dict = {}


def reset_collectives() -> None:
    COLLECTIVES.clear()
    COLLECTIVE_GROUPS.clear()


def count_collective(op: str, nbytes: int, g: int,
                     seconds: float = 0.0) -> None:
    """Add one collective of ``nbytes`` over ``g`` ranks to the counters."""
    c = COLLECTIVES.setdefault(op, [0, 0, 0.0])
    c[0] += 1
    c[1] += nbytes
    c[2] += seconds
    cg = COLLECTIVE_GROUPS.setdefault((op, g), [0, 0])
    cg[0] += 1
    cg[1] += nbytes


@contextlib.contextmanager
def _counted(op: str, t: torch.Tensor, g: int):
    t0 = time.perf_counter()
    yield
    count_collective(op, t.numel() * t.element_size(), g,
                     time.perf_counter() - t0)


# reduce_scatter_single is reduce_scatter_tensor's newer name
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


def free_port() -> int:
    """A TCP port that was free a moment ago (bound to port 0 and
    released): never a fixed one, since several groups may start at once."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def placement(device, local_rank: int, local_world: int):
    """(device, backend) of rank ``local_rank`` of ``local_world`` ranks on
    this host: with a bare ``"cuda"`` and a card for every rank, card
    ``local_rank`` and ``nccl``; on a named card, or with fewer cards than
    ranks, that card (or card 0), shared, and ``gloo``; on the CPU,
    ``gloo``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev, "gloo"
    if dev.index is None and torch.cuda.device_count() >= local_world:
        return torch.device("cuda", local_rank), "nccl"
    return torch.device("cuda", dev.index or 0), "gloo"


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device="cuda") -> torch.device:
    """Join this process to the default group and return its device.

    torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``
    (and ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``) win where set; otherwise
    ``coordinator`` (``host:port``; process 0 binds it), ``num_processes``
    and ``process_id``, all ranks on one host.  The backend follows the
    rule above."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        init = "env://"
    else:
        if coordinator is None or num_processes is None or process_id is None:
            raise ValueError("init_distributed takes coordinator, "
                             "num_processes and process_id, or torchrun's "
                             "RANK and WORLD_SIZE")
        rank, world = process_id, num_processes
        init = f"tcp://{coordinator}"
    dev, backend = placement(device, int(env.get("LOCAL_RANK", rank)),
                             int(env.get("LOCAL_WORLD_SIZE", world)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    return dev


class Pending:
    """An ``all_to_all`` in flight: ``wait()`` returns its output."""

    def __init__(self, work, out: torch.Tensor):
        self._work, self._out = work, out

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
        return self._out


class EPGroup:
    """One process group: ``rank`` of ``size`` ranks, the process group
    (``None``: the default one), its backend and this rank's device, and
    the collectives of the exchange.  A group of one rank calls no
    collective: each one returns a copy of its input."""

    def __init__(self, rank: int, size: int, group, backend: str,
                 device: torch.device):
        self.rank, self.size, self.group = rank, size, group
        self.backend, self.device = backend, device

    def all_to_all(self, t: torch.Tensor, async_op: bool = False):
        """``t`` (size, ...): chunk i goes to rank i, and chunk i of the
        result came from rank i.  ``async_op`` returns a ``Pending``."""
        if t.shape[0] != self.size:
            raise ValueError(f"all_to_all takes ({self.size}, ...) chunks, "
                             f"not {tuple(t.shape)}")
        src = t.contiguous()
        if self.size == 1:
            out = src.clone()
            return Pending(None, out) if async_op else out
        out = torch.empty_like(src)
        with _counted("all_to_all", src, self.size):
            work = dist.all_to_all_single(out, src, group=self.group,
                                          async_op=async_op)
        return Pending(work, out) if async_op else out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's ``t`` in rank order."""
        src = t.contiguous()
        if self.size == 1:
            return src.clone()[None]
        outs = [torch.empty_like(src) for _ in range(self.size)]
        with _counted("all_gather", src.expand(self.size, *src.shape),
                      self.size):
            dist.all_gather(outs, src, group=self.group)
        return torch.stack(outs)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (or ``"mean"``, or ``"max"``) of every rank's ``t``, a
        new tensor."""
        if op not in ("sum", "mean", "max"):
            raise ValueError(f"all_reduce op {op!r}: sum, mean or max")
        out = t.clone()
        if self.size == 1:
            return out
        with _counted("all_reduce", out, self.size):
            dist.all_reduce(out, op=(dist.ReduceOp.MAX if op == "max"
                                     else dist.ReduceOp.SUM),
                            group=self.group)
        return out / self.size if op == "mean" else out

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of the sum over ranks of ``t``, cut into
        ``size`` equal blocks on ``dim``."""
        if t.shape[dim] % self.size:
            raise ValueError(f"reduce_scatter over {self.size} ranks: dim "
                             f"{dim} of {tuple(t.shape)} does not divide")
        if self.size == 1:
            return t.clone()
        src = t.movedim(dim, 0).contiguous()
        n = src.shape[0] // self.size
        out = src.new_empty((n,) + tuple(src.shape[1:]))
        with _counted("reduce_scatter", src, self.size):
            _reduce_scatter(out, src, group=self.group)
        return out.movedim(0, dim)


def make_ep_group(ep: Optional[int] = None, *, device=None,
                  verbose: bool = True) -> EPGroup:
    """The EP group of this rank over the default group's ranks: all of
    them (``ep=None``), or consecutive blocks of ``ep`` (which must divide
    the world size).  ``device`` defaults to the current CUDA device when
    the backend is NCCL, else the CPU: ranks sharing a card pass it."""
    if not dist.is_initialized():
        raise RuntimeError("make_ep_group needs torch.distributed: call "
                           "init_distributed (or run under spawn_ranks)")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if ep is None else ep
    if n < 1 or world % n:
        raise ValueError(f"ep={n} does not divide the {world}-rank group")
    group = None
    if n != world:
        for start in range(0, world, n):      # every rank makes every group
            g = dist.new_group(list(range(start, start + n)))
            if start <= rank < start + n:
                group = g
    backend = dist.get_backend(group)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    g = EPGroup(rank % n, n, group, backend, torch.device(device))
    if verbose and rank == 0:
        shared = (" (ranks share a card: NCCL refuses that)"
                  if backend == "gloo" and g.device.type == "cuda" else "")
        print(f"[ep] {world} rank(s), EP groups of {n}, backend {backend} on "
              f"{g.device}{shared}", flush=True)
    return g


# ----------------------------------------------------------------------
# The grid of ranks (the reference's jax.make_mesh((pod, data, model)))
# ----------------------------------------------------------------------
AXES = ("pod", "data", "model")


class Grid:
    """This rank's place in a ``pod x data x model`` grid of ranks, with
    rank ``(p * D + d) * M + m`` at coordinates (p, d, m): the device order
    of the reference's ``jax.make_mesh((pod, data, model))``.

    ``shape`` maps the grid's axis names to their sizes, as a mesh's does:
    ``("data", "model")``, with ``"pod"`` first when the grid has pods.
    ``group(axes)`` is the ``EPGroup`` of the ranks that differ from this
    one only on ``axes`` (one per axis and per set of axes), its members in
    rank order; ``world`` is the group of every rank."""

    def __init__(self, sizes: dict, coords: dict, groups: dict, rank: int,
                 backend: str):
        self.sizes, self.coords, self._groups = sizes, coords, groups
        self.rank, self.backend = rank, backend
        names = AXES if sizes["pod"] > 1 else AXES[1:]
        self.shape = {a: sizes[a] for a in names}
        self.axis_names = names
        self.world = self.group(AXES)

    def group(self, axes) -> EPGroup:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return self._groups[frozenset(a for a in axes if a in AXES)]

    def size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n = 1
        for a in axes:
            n *= self.sizes[a]
        return n

    def index(self, axes) -> int:
        """This rank's block index over ``axes`` in their given order
        (row-major: the first axis is the major one), as a dim sharded over
        a tuple of mesh axes is cut."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in axes:
            i = i * self.sizes[a] + self.coords[a]
        return i

    def __repr__(self):
        dims = "x".join(str(self.sizes[a]) for a in self.axis_names)
        return (f"Grid({dims} {' x '.join(self.axis_names)}, rank "
                f"{self.rank} at {self.coords})")


def make_grid(data: int, model: int, pod: int = 1, *, device=None,
              verbose: bool = True) -> Grid:
    """The grid of this rank over the default group, whose size must be
    ``pod * data * model``; a grid of one rank needs no group.  Every rank
    makes every process group, in the same order.

    ``device`` defaults to the current CUDA device under NCCL, else the
    CPU (ranks sharing a card pass it)."""
    sizes = {"pod": pod, "data": data, "model": model}
    n = pod * data * model
    if min(sizes.values()) < 1:
        raise ValueError(f"grid sizes must be >= 1, not {sizes}")
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
    elif n == 1:
        world, rank, backend = 1, 0, "none"
    else:
        raise RuntimeError("make_grid needs torch.distributed for more than "
                           "one rank: call init_distributed (or run under "
                           "spawn_ranks)")
    if world != n:
        raise ValueError(f"a {pod}x{data}x{model} grid needs {n} ranks, "
                         f"not {world}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    device = torch.device(device)
    coords = {"model": rank % model, "data": (rank // model) % data,
              "pod": rank // (model * data)}

    def rank_of(c):
        return (c["pod"] * data + c["data"]) * model + c["model"]

    groups = {}
    for mask in range(1, 8):
        axes = tuple(a for i, a in enumerate(AXES) if mask >> i & 1)
        size = 1
        for a in axes:
            size *= sizes[a]
        mine = None
        if 1 < size < world:
            others = [a for a in AXES if a not in axes]
            for fixed in itertools.product(*(range(sizes[a])
                                             for a in others)):
                members = []
                for inner in itertools.product(*(range(sizes[a])
                                                 for a in axes)):
                    c = dict(zip(others, fixed))
                    c.update(zip(axes, inner))
                    members.append(rank_of(c))
                g = dist.new_group(sorted(members))
                if rank in members:
                    mine = (sorted(members).index(rank), g)
        idx, pg = (mine if mine is not None
                   else ((rank if size == world else 0), None))
        groups[frozenset(axes)] = EPGroup(idx, size, pg, backend, device)
    grid = Grid(sizes, coords, groups, rank, backend)
    if verbose and rank == 0:
        dims = "x".join(str(sizes[a]) for a in grid.axis_names)
        print(f"[grid] {dims} ({' x '.join(grid.axis_names)}), {world} "
              f"rank(s), backend {backend} on {device}", flush=True)
    return grid


class DryGroup(EPGroup):
    """A group whose collectives move nothing: each returns a new tensor of
    its result's shape and dtype (its values undefined) and records (op,
    bytes, group size) in the counters, as a real group of ``size`` ranks
    would; a group of one rank returns copies, as ``EPGroup`` does.  The dry run
    (``launch/dryrun.py``) runs one rank's step on fake tensors over a
    grid of these; no process group exists."""

    def __init__(self, rank: int, size: int, device):
        super().__init__(rank, size, None, "dry", torch.device(device))

    def all_to_all(self, t: torch.Tensor, async_op: bool = False):
        if self.size == 1:
            return super().all_to_all(t, async_op)
        if t.shape[0] != self.size:
            raise ValueError(f"all_to_all takes ({self.size}, ...) chunks, "
                             f"not {tuple(t.shape)}")
        count_collective("all_to_all", t.numel() * t.element_size(),
                         self.size)
        out = torch.empty_like(t, memory_format=torch.contiguous_format)
        return Pending(None, out) if async_op else out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return super().all_gather(t)
        count_collective("all_gather",
                         self.size * t.numel() * t.element_size(), self.size)
        return t.new_empty((self.size,) + tuple(t.shape))

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        if self.size == 1:
            return super().all_reduce(t, op)
        if op not in ("sum", "mean", "max"):
            raise ValueError(f"all_reduce op {op!r}: sum, mean or max")
        count_collective("all_reduce", t.numel() * t.element_size(),
                         self.size)
        return torch.empty_like(t, memory_format=torch.contiguous_format)

    def barrier(self) -> None:
        pass

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if self.size == 1:
            return super().reduce_scatter(t, dim)
        if t.shape[dim] % self.size:
            raise ValueError(f"reduce_scatter over {self.size} ranks: dim "
                             f"{dim} of {tuple(t.shape)} does not divide")
        count_collective("reduce_scatter", t.numel() * t.element_size(),
                         self.size)
        shape = list(t.shape)
        shape[dim] //= self.size
        return t.new_empty(shape)


def dry_grid(data: int, model: int, pod: int = 1, *,
             device="cpu") -> Grid:
    """Rank 0 of a ``pod x data x model`` grid of ``DryGroup``s:
    ``make_grid``'s groups (one a set of axes), with no process group
    behind them.  Every rank runs the same step, so the dry run takes
    rank 0's."""
    sizes = {"pod": pod, "data": data, "model": model}
    coords = {"pod": 0, "data": 0, "model": 0}
    groups = {}
    for mask in range(1, 8):
        axes = tuple(a for i, a in enumerate(AXES) if mask >> i & 1)
        size = 1
        for a in axes:
            size *= sizes[a]
        groups[frozenset(axes)] = DryGroup(0, size, device)
    return Grid(sizes, coords, groups, 0, "dry")


_CURRENT: contextvars.ContextVar = contextvars.ContextVar("ep_group",
                                                          default=None)


@contextlib.contextmanager
def use_ep_group(group: EPGroup):
    """Make ``group`` the one the model's MoE layers dispatch over."""
    token = _CURRENT.set(group)
    try:
        yield group
    finally:
        _CURRENT.reset(token)


def current_ep_group() -> EPGroup:
    g = _CURRENT.get()
    if g is None:
        raise RuntimeError("expert parallelism needs an EP group: run inside "
                           "use_ep_group(make_ep_group(...)) or spawn_ranks")
    return g


# ----------------------------------------------------------------------
# Ranks from one process
# ----------------------------------------------------------------------
def _rank_main(fn, rank: int, n: int, device: str, port: int, queue,
               args: tuple) -> None:
    try:
        dev, backend = placement(device, rank, n)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend,
                                init_method=f"tcp://127.0.0.1:{port}",
                                world_size=n, rank=rank)
        try:
            group = make_ep_group(device=dev)
            with use_ep_group(group):
                result = fn(group, *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, "ok", result))
    except BaseException:                  # reported, then the rank exits
        queue.put((rank, "error", traceback.format_exc()))
        raise


def spawn_ranks(fn: Callable, n: int, device="cpu", *args,
                timeout: float = 1800.0) -> list:
    """Run ``fn(group, *args)`` on ``n`` ranks, each a process started with
    the ``spawn`` method, in one EP group over a free local port; returns
    the ranks' results in rank order.

    ``fn`` must be importable by module path and its result picklable (no
    torch tensors: return numpy or Python values).  On a CUDA device the
    kernels are built here first, so that the ranks only load them.  A
    rank that raises or dies fails the call: the other ranks are killed
    and the error, with the failing rank's traceback, is raised here."""
    import multiprocessing as mp
    import queue as queue_mod

    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, str(device), port, q, args),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < n:
            try:
                rank, status, value = q.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} died with exit codes "
                                       f"{[procs[r].exitcode for r in dead]}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks did not finish in {timeout} s")
                continue
            if status != "ok":
                raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        q.close()
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with codes {bad}")
    return [results[r] for r in range(n)]
