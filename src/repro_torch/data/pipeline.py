"""Deterministic synthetic data (the port's own copy of
``repro.data.pipeline``, numpy for numpy, so a batch is bitwise the
reference's): Markov-chain token streams in which each token may be
followed by only ``branch`` tokens, so a model that learns shows a loss
well below ln(vocab).  A batch is a pure function of (seed, step).
``device_batch`` hands it to torch on an explicit device."""
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
    """{"tokens": (batch, seq) int32}, with a leading (accum,) microbatch
    axis when ``accum > 1``: the reference's decoder-LM batch."""
    if cfg.encoder_only or cfg.cross_attn_every:
        raise NotImplementedError(
            f"{cfg.name}: the port trains decoder-only LMs so far")
    lead = (accum,) if accum > 1 else ()
    toks = markov_tokens(cfg.vocab_size, batch * accum, seq, step=step,
                         seed=seed)
    return {"tokens": toks.reshape(lead + (batch, seq))}


def device_batch(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                                torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
