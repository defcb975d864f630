"""Deterministic synthetic data (the port's own copy of
``repro.data.pipeline``, numpy for numpy, so a batch is bitwise the
reference's): Markov-chain token streams in which each token may be
followed by only ``branch`` tokens, so a model that learns shows a loss
well below ln(vocab), with the reference's random image embeddings for a
vlm and its masked-prediction batch (feature frames, codebook labels and a
mask) for an encoder.  A batch is a pure function of (seed, step).
``device_batch`` hands it to torch on an explicit device, and
``local_batch`` cuts a rank's block of it on a grid."""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@functools.lru_cache(maxsize=8)
def _transition(vocab: int, seed: int, branch: int = 4) -> np.ndarray:
    """Each token can be followed by only ``branch`` tokens (uniformly)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(vocab, branch)).astype(np.int32)


def markov_tokens(vocab: int, batch: int, seq: int, *, step: int,
                  seed: int = 1234, branch: int = 4) -> np.ndarray:
    trans = _transition(vocab, seed, branch)
    rng = np.random.default_rng((seed, step))
    toks = np.empty((batch, seq), np.int32)
    cur = rng.integers(0, vocab, size=batch).astype(np.int32)
    toks[:, 0] = cur
    choices = rng.integers(0, branch, size=(batch, seq))
    for t in range(1, seq):
        cur = trans[cur, choices[:, t]]
        toks[:, t] = cur
    return toks


def make_batch(cfg: ModelConfig, batch: int, seq: int, *, step: int,
               accum: int = 1, seed: int = 1234) -> Dict[str, np.ndarray]:
    """The reference's batch, with a leading (accum,) microbatch axis when
    ``accum > 1``: {"tokens": (batch, seq) int32} for a decoder LM, plus
    {"image_embeds": (batch, n_image_tokens, d_model) f32} where the config
    has cross blocks; for an encoder {"features": (batch, seq, d_model)
    f32, "labels": (batch, seq) int32, "mask": (batch, seq) bool}: Markov
    labels, normal features with a 0.5 bump at ``label % d_model``, and
    about 8 % of the frames masked."""
    lead = (accum,) if accum > 1 else ()
    n = batch * accum
    rng = np.random.default_rng((seed, step, 7))
    if cfg.encoder_only:
        labels = markov_tokens(cfg.vocab_size, n, seq, step=step, seed=seed)
        feats = rng.normal(size=(n, seq, cfg.d_model)).astype(np.float32) \
            + 0.5 * np.eye(cfg.d_model)[labels % cfg.d_model]
        mask = rng.random((n, seq)) < 0.08
        out = {"features": feats.astype(np.float32), "labels": labels,
               "mask": mask}
    else:
        out = {"tokens": markov_tokens(cfg.vocab_size, n, seq, step=step,
                                       seed=seed)}
        if cfg.cross_attn_every:
            out["image_embeds"] = rng.normal(
                size=(n, cfg.n_image_tokens, cfg.d_model)
            ).astype(np.float32) * 0.3
    return {k: v.reshape(lead + (batch,) + v.shape[1:])
            for k, v in out.items()}


def device_batch(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                                torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


# each key's own dims, after any leading microbatch axis
_CORE_DIMS = {"tokens": 2, "features": 3, "labels": 2, "mask": 2,
              "image_embeds": 3}


def _axes(ax) -> tuple:
    return () if ax is None else ((ax,) if isinstance(ax, str) else ax)


def local_batch(batch: dict, grid, specs: dict, cfg=None) -> dict:
    """This rank's block of a whole batch under ``batch_specs`` on ``grid``:
    every key cut on each dim over the axes its spec names.  ``tokens``
    (cut on the batch dim over the data axes and, under sequence
    parallelism, on the sequence over 'model') also gives ``labels``, the
    next token of each local position that has one (the sequence's last
    rank has one position fewer); an encoder's ``features``, ``labels``
    and ``mask`` are cut alike over (batch, sequence), and a vlm's
    ``image_embeds`` over the batch only, whole on every 'model' rank.
    Works on numpy arrays and on tensors, with or without a microbatch
    axis.

    Every axis of more than one rank must cut the batch, but for 'model'
    where ``cfg``'s family splits heads over it and keeps whole sequences
    on its ranks (``ssm``, ``hybrid``: the loss counts the tokens those
    ranks share once): a dropped one would have its ranks train on the
    same rows twice, so it raises."""
    key = "tokens" if "tokens" in batch else "labels"
    lead = batch[key].ndim - _CORE_DIMS[key]
    B, S = batch[key].shape[lead:lead + 2]
    b_ax, s_ax = specs[key][-2:]
    used = set(_axes(b_ax)) | set(_axes(s_ax))
    if cfg is not None and cfg.family in ("ssm", "hybrid") and s_ax is None:
        used.add("model")
    idle = [a for a in grid.axis_names
            if grid.sizes[a] > 1 and a not in used]
    if idle or S % grid.size(_axes(s_ax)):
        raise ValueError(f"a batch of {B} x {S} does not cut over the "
                         f"{grid!r}: the batch must divide over the data "
                         f"axes and the sequence over 'model'")

    def cut(arr, spec, dims: int, shift: int = 0):
        index = [slice(None)] * arr.ndim
        for i, ax in enumerate(spec[-dims:]):
            dim = arr.ndim - dims + i
            n = arr.shape[dim] // grid.size(_axes(ax))
            start = grid.index(_axes(ax)) * n + (shift if i == 1 else 0)
            index[dim] = slice(start, start + n)
        return arr[tuple(index)]

    out = {}
    for k, arr in batch.items():
        out[k] = cut(arr, specs[k], _CORE_DIMS[k])
    if key == "tokens":             # the next token of each local position
        out["labels"] = cut(batch["tokens"], specs["tokens"], 2, shift=1)
    return out
