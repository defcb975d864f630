"""Carry the JAX package's parameters over to the port.

``from_jax_params(cfg, tree)`` takes the reference's parameter tree
(``repro.models.lm.init_params`` layout) with every leaf already a numpy
array (the caller runs ``jax.tree.map(np.asarray, params)``; this module
does not import JAX) and returns the port's ``LM`` holding the same
weights.  The stacked ``body`` leaves are unstacked along axis 0 into one
layer each; every ``(in, out)`` matrix keeps its layout."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import LM, group_structure, init_params


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _jax_layers(cfg: ModelConfig, tree: dict):
    """One flat {dotted name: array} dict per layer, in layer order."""
    prefix, body, n_groups, _ = group_structure(cfg)
    layers = [_flatten(b) for b in tree.get("prefix", [])]
    if len(layers) != len(prefix):
        raise ValueError(f"expected {len(prefix)} prefix blocks, "
                         f"got {len(layers)}")
    stacked = _flatten(tree["body"]["b0"])
    for g in range(n_groups):
        layers.append({k: v[g] for k, v in stacked.items()})
    return layers


def from_jax_params(cfg: ModelConfig, tree: dict, *, device="cuda") -> LM:
    """The port's fp32 model with the reference tree's weights."""
    model = init_params(cfg, 0, device=device)

    def load(param: torch.Tensor, arr, name: str) -> None:
        arr = np.array(arr, dtype=np.float32)
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{name}: reference shape {arr.shape}, port "
                             f"shape {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(arr).to(param.dtype))

    load(model.embed, tree["embed"], "embed")
    load(model.head, tree["head"], "head")
    load(model.final_norm.scale, tree["final_norm"]["scale"],
         "final_norm.scale")
    for i, (blk, ref) in enumerate(zip(model.layers, _jax_layers(cfg, tree))):
        names = dict(blk.named_parameters())
        if set(names) != set(ref):
            raise ValueError(
                f"layer {i}: reference leaves missing from the port: "
                f"{sorted(set(ref) - set(names))}; port parameters with no "
                f"reference leaf: {sorted(set(names) - set(ref))}")
        for name, param in names.items():
            load(param, ref[name], f"layers.{i}.{name}")
    return model
