"""Checkpointing: versioned, atomic, async, self-describing (counterpart of
``repro.checkpoint.manager``).

* Atomic: each checkpoint is written to ``<dir>/tmp.<step>`` and renamed
  to ``<dir>/ckpt_<step:08d>`` only after every file is flushed, so a crash
  mid-write never corrupts the latest checkpoint.  Older checkpoints are
  removed down to ``keep_last`` after each publish.
* Async: the trainer updates its parameters and moments in place
  (``optim.adamw``), so ``save`` copies every leaf to host memory on the
  caller's thread before it returns; only the file write runs on the
  background thread (the reference likewise calls ``device_get`` on the
  caller's thread).  One write is in flight at a time.
* Staged: the host copies land in page-locked buffers that the manager
  keeps and reuses (``save`` waits for the previous write before it
  overwrites them), so a device leaf crosses to the host in one
  asynchronous copy, not a pageable one; the leaves are written by a few
  threads, one ``.npy`` file each, and ``restore`` reads them through
  memory maps into the same buffers on a few threads before one copy to
  the device each (``PERF.md`` gives the times on the card's host).
* Self-describing: ``manifest.json`` holds the step, the time and every
  leaf's name, shape and dtype.  numpy has no bfloat16, so a bf16 leaf is
  stored as its raw 16-bit words (int16) with ``bfloat16`` in the
  manifest.
* Structure: the state is flattened by name (``params/<parameter or
  buffer>``, ``opt/m/<name>``, ``opt/v/<name>``, ``opt/step``); a module
  flattens to its ``state_dict``, so a model whose routed experts are
  quantized (payload and scale buffers in place of the dense stack) has
  another structure than the dense one, and restoring one into the other
  raises the reference's structure-mismatch error.

``restore`` copies each leaf into the target's tensor, on that tensor's
own device, in place.  ``restore_params`` reads a part of a checkpoint
(by default a training state's ``params/*``, skipping ``opt/*``) into a
model of another dtype, each leaf cast to its target's: what a server
loads from a trainer's checkpoint.  ``stats`` holds the bytes and the
seconds of the last save's host copy and write and of the last restore.

On a grid of ranks (``shardings``: the state's specs by leaf name, and
the ``grid``) a checkpoint still holds full arrays, as the reference's
do: ``save`` gathers each leaf from every rank's block, one leaf at a
time, and rank 0 alone stages and writes; ``restore`` reads on each rank
only its block of each full leaf (memory-mapped), on any grid: the
reference's elastic restore."""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch

# numpy has no bfloat16: such leaves travel as their raw 16-bit words
_RAW_WORDS = {torch.bfloat16: torch.int16}
_IO_THREADS = 4          # writers and readers of the leaves' files


def flatten_state(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` over a nest of dicts, modules and tensors; a
    module contributes its ``state_dict`` (parameters and buffers), each
    tensor once, under its first name (a module applied at several places,
    as a hybrid model's shared blocks, is held as ``shared.<j>`` alone, as
    ``named_parameters`` names it)."""
    if isinstance(tree, torch.nn.Module):
        seen: set = set()
        tree = {k: v for k, v in tree.state_dict(keep_vars=True).items()
                if not (id(v) in seen or seen.add(id(v)))}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if not isinstance(tree, dict):
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                        f"{prefix or 'the root'}")
    out: Dict[str, torch.Tensor] = {}
    for key, sub in tree.items():
        out.update(flatten_state(sub, f"{prefix}/{key}" if prefix else key))
    return out


def _words(host: torch.Tensor) -> np.ndarray:
    """A host tensor as the numpy array its file holds (bf16: int16)."""
    if host.dtype in _RAW_WORDS:
        host = host.view(_RAW_WORDS[host.dtype])
    return host.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


class CheckpointManager:
    def __init__(self, directory: str, *, keep_last: int = 3,
                 async_save: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._pool = ThreadPoolExecutor(max_workers=1) if async_save else None
        self._pending: Optional[Future] = None
        self._lock = threading.Lock()
        self._host: Dict[str, torch.Tensor] = {}    # staging, reused
        self.stats: Dict[str, float] = {}

    def _staging(self, leaves: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
        """A host buffer per leaf ``{name: (shape, dtype, pinned)}``,
        page-locked for a device leaf; kept from the last call when its
        shape and dtype still match."""
        for name, (shape, dtype, pinned) in leaves.items():
            buf = self._host.get(name)
            if buf is None or buf.shape != shape or buf.dtype != dtype:
                self._host[name] = torch.empty(shape, dtype=dtype,
                                               pin_memory=pinned)
        return {name: self._host[name] for name in leaves}

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, shardings: Optional[dict] = None,
             grid=None) -> None:
        """Copy ``state`` to host memory now, write it (in the background
        when async).  With ``shardings`` ({leaf name: spec}; a leaf absent
        is whole on every rank) each leaf is gathered whole on ``grid``
        first, one at a time, and only rank 0 stages and writes; every
        rank must call."""
        from repro_torch.distributed.sharding import full_shape, unshard
        self.wait()        # one write in flight; it reads the staging
        t0 = time.perf_counter()
        leaves = flatten_state(state)
        specs = {n: (shardings or {}).get(n, ()) for n in leaves}
        shapes = {n: (tuple(t.shape) if shardings is None
                      else full_shape(t.shape, specs[n], grid))
                  for n, t in leaves.items()}
        writer = shardings is None or grid.rank == 0
        if writer:
            staging = self._staging({n: (torch.Size(shapes[n]), t.dtype,
                                         t.is_cuda)
                                     for n, t in leaves.items()})
        for name, t in leaves.items():
            src = t.detach() if shardings is None \
                else unshard(t.detach(), specs[name], grid)
            if writer:
                staging[name].copy_(src, non_blocking=src.is_cuda)
            del src
        if not writer:
            return
        for dev in {t.device for t in leaves.values() if t.is_cuda}:
            torch.cuda.current_stream(dev).synchronize()
        host = {n: _words(b) for n, b in staging.items()}
        meta = [{"name": n, "shape": list(shapes[n]),
                 "dtype": _dtype_name(t)} for n, t in leaves.items()]
        self.stats.update(bytes=sum(a.nbytes for a in host.values()),
                          host_copy_s=time.perf_counter() - t0)
        if self._pool is None:
            self._write(step, host, meta)
            return
        self._pending = self._pool.submit(self._write, step, host, meta)

    def wait(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def _write(self, step: int, host: Dict[str, np.ndarray], meta) -> None:
        t0 = time.perf_counter()
        tmp = self.dir / f"tmp.{step}"
        final = self.dir / f"ckpt_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

        def write_leaf(i_arr):
            i, arr = i_arr
            with open(tmp / f"leaf_{i}.npy", "wb") as f:
                np.save(f, arr)
                f.flush()
        with ThreadPoolExecutor(max_workers=_IO_THREADS) as io:
            list(io.map(write_leaf, enumerate(host.values())))
        manifest = {"step": step, "time": time.time(), "leaves": meta}
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                 # atomic publish
        self._gc()
        self.stats["write_s"] = time.perf_counter() - t0

    def _gc(self) -> None:
        with self._lock:
            ckpts = sorted(self.dir.glob("ckpt_*"))
            for old in ckpts[:-self.keep_last]:
                shutil.rmtree(old, ignore_errors=True)

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        ckpts = sorted(self.dir.glob("ckpt_*"))
        if not ckpts:
            return None
        return int(ckpts[-1].name.split("_")[1])

    def _manifest(self, step: Optional[int]):
        """(checkpoint directory, its leaves' metadata) of ``step``
        (default: the latest)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"ckpt_{step:08d}"
        with open(path / "manifest.json") as f:
            return path, json.load(f)["leaves"]

    def _read(self, path: pathlib.Path, leaves: Dict[str, torch.Tensor],
              files: Dict[str, int], dtypes: Dict[str, torch.dtype],
              where=None) -> int:
        """Read leaf file ``files[name]`` of ``path`` into each of
        ``leaves``' tensors in place, through a host buffer of
        ``dtypes[name]`` (the file's; ``copy_`` casts to the tensor's),
        memory-mapped on a few threads; ``where(name, shape)`` picks this
        rank's block of the full array (default: all of it).  Returns the
        bytes staged."""
        self.wait()                       # the staging may be in a write
        staging = self._staging({n: (t.shape, dtypes[n], t.is_cuda)
                                 for n, t in leaves.items()})

        def read_leaf(name):
            full = np.load(path / f"leaf_{files[name]}.npy", mmap_mode="r")
            block = Ellipsis if where is None else where(name, full.shape)
            _words(staging[name])[...] = full[block]
        with ThreadPoolExecutor(max_workers=_IO_THREADS) as io:
            list(io.map(read_leaf, leaves))
        with torch.no_grad():
            for name, t in leaves.items():
                t.copy_(staging[name], non_blocking=t.is_cuda)
        for dev in {t.device for t in leaves.values() if t.is_cuda}:
            torch.cuda.current_stream(dev).synchronize()
        return sum(b.numel() * b.element_size() for b in staging.values())

    def restore(self, target: Any, step: Optional[int] = None,
                shardings: Optional[dict] = None, grid=None) -> Any:
        """Load checkpoint ``step`` (default: the latest) into ``target``'s
        tensors in place, each on its own device; returns ``target``.
        With ``shardings`` ({leaf name: spec}) ``target`` holds this rank's
        blocks on ``grid``, and each rank reads only its block of each full
        leaf: onto any grid (elastic)."""
        from repro_torch.distributed.sharding import block_slices, full_shape
        path, meta = self._manifest(step)
        leaves = flatten_state(target)
        if len(meta) != len(leaves) \
                or [m["name"] for m in meta] != list(leaves):
            raise ValueError(
                f"checkpoint {path.name} holds {len(meta)} leaves but the "
                f"restore target flattens to {len(leaves)} — the tree "
                f"STRUCTURES differ (e.g. a quantized checkpoint restored "
                f"into a dense target, or vice versa; build the target "
                f"with the same quantization scheme it was saved under)")
        specs = {n: (shardings or {}).get(n, ()) for n in leaves}
        for m, (name, t) in zip(meta, leaves.items()):
            shape = (tuple(t.shape) if shardings is None
                     else full_shape(t.shape, specs[name], grid))
            if tuple(m["shape"]) != shape or m["dtype"] != _dtype_name(t):
                raise ValueError(
                    f"leaf {name}: checkpoint {m['dtype']} {m['shape']} != "
                    f"target {_dtype_name(t)} {list(shape)}")
        t0 = time.perf_counter()
        self._read(path, leaves, {n: i for i, n in enumerate(leaves)},
                   {n: t.dtype for n, t in leaves.items()},
                   None if shardings is None else
                   lambda name, shape: block_slices(shape, specs[name], grid))
        self.stats["restore_s"] = time.perf_counter() - t0
        return target

    def restore_params(self, target: Any, step: Optional[int] = None,
                       prefix: str = "params") -> Any:
        """Load the leaves named ``<prefix>/<name>`` of checkpoint ``step``
        (default: the latest) into ``target``'s tensors in place and skip
        the rest (a training state's ``opt/*``).  Every leaf of the target
        must be in the checkpoint and every leaf under ``prefix`` in the
        target: either kind of stray is named in the error.  Shapes must
        match; each leaf is cast to its target's dtype on the way in (fp32
        master weights into a bf16 server; the same dtype bitwise), floating
        dtypes only.  A grid's checkpoint holds full arrays, so this loads
        it onto one device.  ``stats`` gets the bytes read
        (``restore_bytes``), the seconds and the step."""
        path, meta = self._manifest(step)
        head = prefix + "/"
        stored = {m["name"][len(head):]: (i, m) for i, m in enumerate(meta)
                  if m["name"].startswith(head)}
        leaves = flatten_state(target)
        missing = [n for n in leaves if n not in stored]
        extra = [n for n in stored if n not in leaves]
        if missing or extra:
            raise ValueError(
                f"checkpoint {path.name} under {head}*: "
                + "; ".join(f"{what} {len(names)} leaves ("
                            + ", ".join(names[:6])
                            + (", ..." if len(names) > 6 else "") + ")"
                            for what, names in (
                                ("the target has, the checkpoint lacks,",
                                 missing),
                                ("the checkpoint has, the target lacks,",
                                 extra)) if names))
        dtypes = {}
        for name, t in leaves.items():
            m = stored[name][1]
            src = getattr(torch, m["dtype"])
            if tuple(m["shape"]) != tuple(t.shape):
                raise ValueError(f"leaf {head}{name}: checkpoint "
                                 f"{m['shape']} != target {list(t.shape)}")
            if src != t.dtype and not (src.is_floating_point
                                       and t.dtype.is_floating_point):
                raise ValueError(f"leaf {head}{name}: checkpoint {m['dtype']}"
                                 f" cannot be cast to {_dtype_name(t)}")
            dtypes[name] = src
        t0 = time.perf_counter()
        n_bytes = self._read(path, leaves,
                             {n: stored[n][0] for n in leaves}, dtypes)
        self.stats.update(restore_s=time.perf_counter() - t0,
                          restore_step=int(path.name.split("_")[1]),
                          restore_bytes=n_bytes)
        return target
