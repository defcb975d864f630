"""The port's sharded training (``repro_torch.distributed.{group, sharding,
ctx}``, the grid path of ``models/lm.py``, ``train/step.py`` and
``train/loop.py``, the sharded checkpoint, ``compressed_psum``,
``combine_stats``) against the reference's, on the CPU.

* Specs, in process: ``param_specs`` (``fsdp`` and ``serve_tp``),
  ``batch_specs``, ``cache_specs`` and ``activation_rules`` equal the
  reference's entry for entry on ``AbstractMesh((2, 2), ("data",
  "model"))`` and ``((2, 2, 2), ("pod", "data", "model"))``, for reduced
  moonshot-v1-16b-a3b, qwen2-7b and deepseek-v2-236b (MLA's leaves; the
  reference's stacked leading axis dropped).
* The sharded step: weights from the reference's ``init_train_state``
  carried across with ``from_jax_params``; one fp32 step on grids 2x2
  (4 spawned gloo ranks), 1x2, 2x1 and 2x1x1 (two pods; 2 ranks), each
  group running every grid's cases, the rank bodies in
  ``torch_sharded_worker`` (no JAX in a rank), held against the
  reference's single-device jitted
  ``make_train_step`` (the reference's own sharded step cannot run under
  this jax: ROADMAP C3).  Reduced qwen2-7b (the reference test's: 2
  layers, d_model 64, 4 heads), reduced moonshot (3 layers) under
  ``fixed`` and ``capacity_factor`` (1.0: its buckets drop) and reduced
  deepseek-v2 (3 layers, MLA: the latent gathered over 'model') under
  ``fixed``, batch 8 x seq 32, ``RunConfig(q_chunk=0, kv_chunk=16,
  loss_chunk=16)`` and the reference test's ``OptConfig``: the loss, every gradient gathered from
  the blocks and every parameter after the step within 1e-4;
  ``lb_loss``/``router_z`` within 1e-6 (relative where they pass 1:
  router_z sums to about 12 over the MoE layers, where fp32's step is
  9.5e-7) and ``sched/dropped_rows`` equal.
  On 2x2 the gradients with remat bitwise those without; the 1x1 grid
  bitwise the unsharded port.  Under SP (1x2, 2x2) the forward gathers
  each layer's K and V, or for MLA the latent and the rope key, over
  'model', and nothing else.
* Elastic restore: a checkpoint written on 2x2 restored onto 1x1 and 1x2
  is bitwise the saved leaves; a run interrupted after 2 steps and resumed
  ends bitwise where an uninterrupted one does, on 2x2 and on 1x2.  The
  2x2 checkpoint served on one device by the serve launcher: the
  unsharded restore's prefill logits bitwise, and its engine's tokens.
* ``compressed_psum`` over a 'pod' group of 4: ``rel < 2e-2`` of the plain
  sum, within 1e-6 of the reference's ``quantize`` arithmetic; the step's
  'pod' reduction through it (``compress_pod``) within ``rel < 2e-2``.
* ``combine_stats`` over a 'model' group of 4 with ``flash_attention(...,
  kv_offset=, return_stats=True)``: within 3e-5 of full attention;
  ``flash_attention``'s ``q_offset``/``kv_offset`` against the
  reference's on one device.
* ``RunConfig(ep_overlap=True)`` on 1x2 (reduced moonshot,
  ``capacity_factor``): the same checks against the same single-device
  step.
* ``apply_moe_ep`` on the global x under autograd (2 ranks): output,
  router losses and the gradients of x, the router and each rank's experts
  against the single-device layer with the EP layer's loss.
* The launcher: ``--grid 2x2 --reduce --steps 2 --device cpu``.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.data.pipeline import make_batch as jax_make_batch  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.lm import RunConfig as JaxRunConfig  # noqa: E402
from repro.models.lm import init_cache as jax_init_cache  # noqa: E402
from repro.models.lm import init_params as jax_init_params  # noqa: E402
from repro.models.lm import loss_fn as jax_loss_fn  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import compress as jcomp  # noqa: E402
from repro.train.step import init_train_state as jax_init_state  # noqa: E402
from repro.train.step import make_train_step as jax_make_step  # noqa: E402
from repro_torch.configs.base import MoEConfig
from repro_torch.core.moe_layer import apply_moe, dispatch_config
from repro_torch.data.pipeline import local_batch
from repro_torch.distributed import spawn_ranks
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.group import Grid, make_grid
from repro_torch.execution import plan_dispatch
from repro_torch.models import attention as tattn
from repro_torch.models.lm import init_cache, init_params, loss_fn
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.step import make_train_step, train_state
from repro_torch.weights import from_jax_params, from_jax_tree

import torch_sharded_worker as W
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
AUX_TOL = 1e-6
ARCHS = ("moonshot-v1-16b-a3b", "qwen2-7b", "deepseek-v2-236b")
CASES = {"qwen2-fixed": ("qwen2-7b", "fixed"),
         "moonshot-fixed": ("moonshot-v1-16b-a3b", "fixed"),
         "moonshot-capacity": ("moonshot-v1-16b-a3b", "capacity_factor"),
         "deepseek-fixed": ("deepseek-v2-236b", "fixed")}
GRIDS = ("1x2x2", "1x1x2", "1x2x1", "2x1x1")   # pod x data x model
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
EP_MOE = dict(n_experts=8, top_k=2, d_ff_expert=32, block_m=8)
# the pipelined EP dispatch (RunConfig.ep_overlap, 2 microbatches) on the
# 1x2 grid: the same step as without it
OVERLAP_CASE = "moonshot-capacity-overlap"


def jax_config(arch):
    if arch == "qwen2-7b":
        return jax_reduced(jax_get_config(arch), layers=2, d_model=64,
                           n_heads=4)
    return jax_reduced(jax_get_config(arch), layers=3)


def jax_run_config(policy):
    return JaxRunConfig(q_chunk=0, kv_chunk=16, loss_chunk=16,
                        schedule_policy=policy, capacity_factor=W.CF,
                        moe_stats=True)


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ----------------------------------------------------------------------
# Specs
# ----------------------------------------------------------------------
def _spec(p):
    return tuple(p)


class _Stacked:
    """A stacked body leaf's spec: every group's is the tail."""

    def __init__(self, spec):
        self.spec = spec

    def __getitem__(self, g):
        return self.spec[1:]


def _port_names(arch, tree):
    """A reference spec tree (PartitionSpec leaves) as {port name: spec}."""
    tree = jax.tree.map(_spec, tree, is_leaf=lambda x: isinstance(x, P))
    tree = dict(tree)
    tree["body"] = jax.tree.map(_Stacked, tree["body"],
                                is_leaf=lambda x: isinstance(x, tuple))
    return from_jax_tree(W.model_config(arch), tree)


def _port_params(arch):
    return {n: tuple(p.shape) for n, p in init_params(
        W.model_config(arch), 0, device="cpu").named_parameters()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("mode", ["fsdp", "serve_tp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mode, mesh):
    jm = AbstractMesh(*MESHES[mesh])
    jcfg = jax_config(arch)
    shapes = jax.eval_shape(lambda: jax_init_params(jcfg, jax.random.key(0)))
    want = _port_names(arch, jsh.param_specs(shapes, jcfg, jm, mode))
    got = tsh.param_specs(_port_params(arch), W.model_config(arch),
                          dict(jm.shape), mode)
    assert got == want
    if mode == "fsdp":                    # the scheme's anchors
        assert got["embed"] == ("model", "data")
        if arch.startswith("moonshot"):
            assert got["layers.1.moe.w_gate"] == ("model", "data", None)
            assert got["layers.1.moe.router"] == (None, None)
    if arch.startswith("deepseek"):       # MLA's leaves
        col, row = ((None, "model"), ("model", None)) if mode == "serve_tp" \
            else (("data", "model"),) * 2
        for leaf in ("wq_a", "wq_b", "wkv_a", "wkv_b"):
            assert got[f"layers.1.attn.{leaf}"] == col, leaf
        assert got["layers.1.attn.wo"] == row
        assert got["layers.1.attn.kv_norm.scale"] == (None,)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_activation_specs_match_reference(arch, mesh):
    jm = AbstractMesh(*MESHES[mesh])
    jcfg, tcfg = jax_config(arch), W.model_config(arch)
    for mode in ("train", "prefill", "decode"):
        for gb in (8, 4, 2, 1, 3):
            for micro in (False, True):
                want = {k: tuple(v) for k, v in jsh.batch_specs(
                    jcfg, jm, mode, gb, microbatched=micro).items()}
                assert tsh.batch_specs(tcfg, dict(jm.shape), mode, gb,
                                       microbatched=micro) == want
            want = {k: tuple(v) for k, v in jsh.activation_rules(
                jcfg, jm, mode, gb).items()}
            assert tsh.activation_rules(tcfg, dict(jm.shape), mode,
                                        gb) == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh):
    jm = AbstractMesh(*MESHES[mesh])
    jcfg, tcfg = jax_config(arch), W.model_config(arch)
    for batch in (8, 2, 1):
        cache = jax.eval_shape(lambda: jax_init_cache(jcfg, batch, 64))
        ref = jsh.cache_specs(cache, jcfg, jm, batch)
        # a reference block's cache is {"kv": {name: leaf}}
        want = [{k: tuple(v) for k, v in layer["kv"].items()}
                for layer in ref.get("prefix", [])]
        n_groups = next(iter(jax.tree.leaves(cache["body"]))).shape[0]
        for _ in range(n_groups):
            for i in range(len(ref["body"])):
                want.append({k: tuple(v)[1:] for k, v
                             in ref["body"][f"b{i}"]["kv"].items()})
        got = tsh.cache_specs(init_cache(tcfg, batch, 64, device="cpu"),
                              tcfg, dict(jm.shape), batch)
        assert got == want, batch


def test_opt_state_specs_share_the_param_layout():
    specs = tsh.param_specs(_port_params("qwen2-7b"),
                            W.model_config("qwen2-7b"),
                            {"data": 2, "model": 2})
    out = tsh.opt_state_specs(specs)
    assert out["m"] is specs and out["v"] is specs and out["step"] == ()


def test_grid_rank_order_and_blocks():
    """A one-rank grid needs no group; a spec's block of a full tensor and
    the reference mesh's device order (rank = (p D + d) M + m)."""
    grid = make_grid(1, 1, verbose=False)
    assert grid.world.size == 1 and grid.shape == {"data": 1, "model": 1}
    t = torch.arange(24.0).reshape(4, 6)
    assert torch.equal(tsh.shard(t, ("data", "model"), grid), t)

    class FakeGrid:                        # coordinates only, no groups
        sizes = {"pod": 2, "data": 2, "model": 3}
        size, index = Grid.size, Grid.index

        def __init__(self, rank):
            self.coords = {"model": rank % 3, "data": rank // 3 % 2,
                           "pod": rank // 6}

    t = torch.arange(12.0 * 6).reshape(12, 6)
    blocks = {}
    for r in range(12):
        g = FakeGrid(r)
        blocks[r] = tsh.shard(t, (("pod", "data"), "model"), g)
        assert blocks[r].shape == (3, 2)
    # rank (p, d, m) holds rows (p*2 + d)*3.. and columns m*2..
    assert torch.equal(blocks[(1 * 2 + 0) * 3 + 2], t[6:9, 4:6])


def test_local_batch_cuts_tokens_and_labels():
    grid = make_grid(1, 1, verbose=False)
    toks = np.arange(2 * 8).reshape(2, 8)
    specs = tsh.batch_specs(W.model_config("qwen2-7b"), grid, "train", 2)
    out = local_batch({"tokens": toks}, grid, specs)
    assert np.array_equal(out["tokens"], toks)
    assert np.array_equal(out["labels"], toks[:, 1:])


# ----------------------------------------------------------------------
# The reference's side (in process) and the ranks (spawned)
# ----------------------------------------------------------------------
def case_inputs() -> dict:
    """Each case's reference weights (``init_train_state``) and batch."""
    out = {}
    for name, (arch, policy) in CASES.items():
        jcfg, jrc = jax_config(arch), jax_run_config(policy)
        state = jax.jit(lambda key: jax_init_state(jcfg, key, jrc))(
            jax.random.key(0))
        batch = jax_make_batch(jcfg, W.BATCH, W.SEQ, step=0)
        out[name] = (state, batch)
    return out


def reference_runs(inputs: dict) -> dict:
    """The reference's single-device loss, gradients and jitted step."""
    out = {}
    jopt = jax_adamw.OptConfig(**W.OPT)
    for name, (arch, policy) in CASES.items():
        jcfg, jrc = jax_config(arch), jax_run_config(policy)
        state, batch = inputs[name]
        step = jax_make_step(jcfg, jrc, jopt, 1)

        def both(state, batch):            # one compile for both
            return (jax.value_and_grad(
                lambda p: jax_loss_fn(p, jcfg, jrc, batch), has_aux=True)(
                    state["params"]), step(state, batch))
        ((loss, metrics), grads), (new, step_metrics) = jax.jit(both)(
            state, batch)
        tcfg = W.model_config(arch)
        out[name] = dict(
            tree=numpy_tree(state["params"]),
            tokens=np.asarray(batch["tokens"]), loss=float(loss),
            metrics={k: float(v) for k, v in metrics.items()},
            step_metrics={k: float(v) for k, v in step_metrics.items()},
            grads=from_jax_tree(tcfg, numpy_tree(grads)),
            params=from_jax_tree(tcfg, numpy_tree(new["params"])))
    return out


def ep_job():
    rng = np.random.default_rng(3)
    d, E, f = 16, EP_MOE["n_experts"], EP_MOE["d_ff_expert"]
    params = {"router": rng.standard_normal((d, E)) * d ** -0.5,
              "w_gate": rng.standard_normal((E, d, f)) * d ** -0.5,
              "w_up": rng.standard_normal((E, d, f)) * d ** -0.5,
              "w_down": rng.standard_normal((E, f, d)) * f ** -0.5}
    return {"moe": EP_MOE,
            "params": {k: v.astype(np.float32) for k, v in params.items()},
            "x": rng.standard_normal((2, 32, d)).astype(np.float32),
            "dy": rng.standard_normal((2, 32, d)).astype(np.float32)}


def combine_job():
    rng = np.random.default_rng(4)
    B, S, H, D = 4, 64, 4, 16
    return {"q": rng.standard_normal((B, 1, H, D)).astype(np.float32),
            "k": rng.standard_normal((B, S, H, D)).astype(np.float32),
            "v": rng.standard_normal((B, S, H, D)).astype(np.float32)}


def rank_runs(inputs: dict, tmp: pathlib.Path) -> dict:
    """Every grid's cases in two spawned groups (4 ranks, then 2)."""
    cases = {name: dict(kind="case", arch=arch, policy=policy,
                        tree=numpy_tree(inputs[name][0]["params"]),
                        tokens=np.asarray(inputs[name][1]["tokens"]))
             for name, (arch, policy) in CASES.items()}
    psum_g = np.random.default_rng(5).standard_normal((4, 64)).astype(
        np.float32)
    remat = {n: dict(c, remat=True) for n, c in cases.items()}
    four = {"grids": [
        ("1x2x2", dict(remat, ckpt=dict(kind="ckpt",
                                        resume=str(tmp / "g22")))),
        ("4x1x1", {"psum": dict(kind="psum", g=psum_g)}),
        ("1x1x4", {"combine": dict(kind="combine", **combine_job())})]}
    sp = dict(cases, ckpt=dict(kind="ckpt", resume=str(tmp / "g12"),
                               restore=str(tmp / "g22" / "split"), step=1),
              ep_fixed=dict(kind="ep", policy="fixed", capacity_factor=2.0,
                            **ep_job()),
              ep_capacity=dict(kind="ep", policy="capacity_factor",
                               capacity_factor=0.5, **ep_job()))
    sp[OVERLAP_CASE] = dict(cases["moonshot-capacity"], overlap=True)
    pod = {"moonshot-fixed": cases["moonshot-fixed"],
           "compress": dict(cases["moonshot-fixed"], kind="compress")}
    two = {"grids": [("1x1x2", sp), ("1x2x1", dict(cases)),
                     ("2x1x1", pod)]}
    out = spawn_ranks(W.rank_main, 4, "cpu", four)
    out2 = spawn_ranks(W.rank_main, 2, "cpu", two)
    res = dict(out[0])
    res.update(out2[0])
    res["others"] = [dict(o) for o in out[1:]] + [dict(o) for o in out2[1:]]
    res["tmp"] = tmp
    res["psum_g"] = psum_g
    return res


@pytest.fixture(scope="module")
def both_sides(tmp_path_factory):
    """The ranks run in a thread while the reference compiles here."""
    from concurrent.futures import ThreadPoolExecutor
    inputs = case_inputs()
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(rank_runs, inputs,
                            tmp_path_factory.mktemp("sharded"))
        ref = reference_runs(inputs)
        return ref, ranks.result()


@pytest.fixture(scope="module")
def reference(both_sides):
    return both_sides[0]


@pytest.fixture(scope="module")
def runs(both_sides):
    return both_sides[1]


def _check_against_reference(got, ref, arch):
    assert abs(got["loss"] - ref["loss"]) <= 1e-4
    for key in ("ce", "tokens"):
        np.testing.assert_allclose(got["metrics"][key], ref["metrics"][key],
                                   **TOL)
    if W.model_config(arch).is_moe:
        for key in ("lb_loss", "router_z"):       # 1e-6, relative past 1
            want = ref["metrics"][key]
            assert abs(got["metrics"][key] - want) \
                <= AUX_TOL * max(1.0, abs(want)), key
        assert got["metrics"]["sched/dropped_rows"] \
            == ref["metrics"]["sched/dropped_rows"]
        assert got["metrics"]["sched/useful_rows"] \
            == ref["metrics"]["sched/useful_rows"]
    assert set(got["grads"]) == set(ref["grads"])
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g, ref["grads"][name], err_msg=name,
                                   **TOL)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got["step_metrics"][key],
                                   ref["step_metrics"][key], err_msg=key,
                                   **TOL)
    for name, p in got["params"].items():
        np.testing.assert_allclose(p, ref["params"][name], err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("grid,case", [
    (g, c) for g in GRIDS for c in sorted(CASES)
    if g != "2x1x1" or c == "moonshot-fixed"])    # two pods: one case
def test_sharded_step_matches_reference(runs, reference, grid, case):
    got = runs[f"{grid}/{case}"]
    _check_against_reference(got, reference[case], CASES[case][0])
    if CASES[case][1] == "capacity_factor":      # the buckets did drop
        assert got["metrics"]["sched/dropped_rows"] > 0
    # every rank holds the same replicated loss and metrics
    for other in runs["others"]:
        if f"{grid}/{case}" in other:
            assert other[f"{grid}/{case}"]["loss"] == got["loss"]
            assert other[f"{grid}/{case}"]["step_metrics"] \
                == got["step_metrics"]


def test_ep_overlap_step_matches_reference(runs, reference):
    """``ep_overlap`` on the 1x2 grid: each rank's 128 tokens go out in 2
    pipelined microbatches, routed, and the capacity drops decided, over
    the whole batch first, so the step is the reference's single-device
    one (which has no EP to pipeline)."""
    got = runs[f"1x1x2/{OVERLAP_CASE}"]
    _check_against_reference(got, reference["moonshot-capacity"],
                             "moonshot-v1-16b-a3b")
    assert got["metrics"]["sched/dropped_rows"] > 0
    for other in runs["others"]:
        if f"1x1x2/{OVERLAP_CASE}" in other:
            assert other[f"1x1x2/{OVERLAP_CASE}"]["loss"] == got["loss"]


@pytest.mark.parametrize("grid", ["1x2x2", "1x1x2"])
@pytest.mark.parametrize("case", ["qwen2-fixed", "deepseek-fixed"])
def test_sequence_parallel_gathers_keys_or_the_latent(runs, grid, case):
    """Under SP each attention layer's forward gathers its keys' source
    over 'model' from this rank's (B/D, S/M) block: K and V (Hkv, D) for
    multi-head attention; for MLA the latent ``c_kv`` (kv_lora_rank) and
    the rotated ``k_rope`` (qk_rope_head_dim), which every rank then
    decompresses, never the decompressed K and V (H x (dn + dr + dv)
    values a token)."""
    _, data, model = (int(v) for v in grid.split("x"))
    cfg = W.model_config(CASES[case][0])
    b, s = W.BATCH // data, W.SEQ // model
    if cfg.mla is not None:
        m = cfg.mla
        want = [(b, s, m.kv_lora_rank), (b, s, m.qk_rope_head_dim)]
        decompressed = cfg.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim
                                      + m.v_head_dim)
        assert 4 * (m.kv_lora_rank + m.qk_rope_head_dim) <= decompressed
    else:
        want = [(b, s, cfg.n_kv_heads, cfg.head_dim)] * 2
    assert runs[f"{grid}/{case}"]["gathers"] == want * cfg.n_layers


@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_gradients_bitwise_on_the_grid(runs, case):
    assert runs[f"1x2x2/{case}"]["remat_bitwise"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_grid_1x1_is_bitwise_the_unsharded_port(reference, case):
    arch, policy = CASES[case]
    ref = reference[case]
    job = dict(kind="case", arch=arch, policy=policy, tree=ref["tree"],
               tokens=ref["tokens"])
    got = W.run_case(job, make_grid(1, 1, verbose=False), True)
    cfg, rc = W.model_config(arch), W.run_config(policy)
    model = train_state(from_jax_params(cfg, ref["tree"], device="cpu"))
    batch = {"tokens": torch.from_numpy(ref["tokens"])}
    loss, metrics = loss_fn(model["params"], cfg, rc, batch)
    params = dict(model["params"].named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    assert got["loss"] == float(loss)
    assert got["metrics"] == {k: float(v) for k, v in metrics.items()}
    for (name, _), g in zip(params.items(), grads):
        assert np.array_equal(got["grads"][name], g.numpy()), name
    state, m = make_train_step(cfg, rc, OptConfig(**W.OPT))(
        train_state(from_jax_params(cfg, ref["tree"], device="cpu")),
        batch)
    assert got["step_metrics"] == {k: float(v) for k, v in m.items()}
    for name, p in state["params"].named_parameters():
        assert np.array_equal(got["params"][name], p.detach().numpy()), name


def test_compressed_pod_reduction_on_a_2x1x1_grid(runs, reference):
    """``compress_pod``: the 'pod' axis's gradient sum as int8
    (``compressed_psum``), every gradient within the reference test's
    ``rel < 2e-2`` of the whole-precision sum."""
    got = runs["2x1x1/compress"]
    want = runs["2x1x1/moonshot-fixed"]["grads"]
    assert set(got) == set(want)
    for name, g in got.items():
        scale = np.abs(want[name]).max()
        assert np.abs(g - want[name]).max() <= 2e-2 * scale, name
    assert any(not np.array_equal(got[n], want[n]) for n in got)


# ----------------------------------------------------------------------
# Elastic restore
# ----------------------------------------------------------------------
def saved_leaves(path: pathlib.Path) -> dict:
    meta = json.load(open(path / "manifest.json"))["leaves"]
    return {m["name"]: np.load(path / f"leaf_{i}.npy")
            for i, m in enumerate(meta)}


@pytest.mark.parametrize("target", ["1x1", "1x2"])
def test_elastic_restore_from_2x2_is_bitwise(runs, target):
    saved = saved_leaves(runs["tmp"] / "g22" / "split" / "ckpt_00000001")
    if target == "1x2":
        got = runs["1x1x2/ckpt"]["leaves"]
    else:
        got = W.restored_leaves(make_grid(1, 1, verbose=False),
                                str(runs["tmp"] / "g22" / "split"), 1)
    assert set(got) == set(saved)
    for name, arr in saved.items():
        assert got[name].dtype == arr.dtype, name
        assert np.array_equal(got[name], arr), name


@pytest.mark.parametrize("grid", ["g22", "g12"])
def test_resumed_run_is_bitwise_the_uninterrupted_one(runs, grid):
    key = {"g22": "1x2x2/ckpt", "g12": "1x1x2/ckpt"}[grid]
    assert runs[key]["resumed_from"] == 1
    split = saved_leaves(runs["tmp"] / grid / "split" / "ckpt_00000002")
    whole = saved_leaves(runs["tmp"] / grid / "whole" / "ckpt_00000002")
    assert set(split) == set(whole)
    for name in whole:
        assert np.array_equal(split[name], whole[name]), name


def test_grid_checkpoint_serves_on_one_device(runs):
    """The 2x2 grid's checkpoint (full arrays: rank 0 gathered them) loaded
    by the serve launcher on one CPU device: its prefill logits are those
    of the unsharded model restored whole from the same step, bitwise, and
    the launcher's tokens those of an engine over that model."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.models.lm import RunConfig, forward
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train.step import init_train_state
    split = str(runs["tmp"] / "g22" / "split")
    cfg = W.model_config("moonshot-v1-16b-a3b")
    served = serve_launcher.load_checkpoint(cfg, split, torch.float32, "cpu")
    state = init_train_state(cfg, 7, W.run_config("fixed"), device="cpu")
    CheckpointManager(split).restore(state, 2)       # the latest
    whole = state["params"]
    toks = torch.as_tensor(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (2, 24)))
    rc = RunConfig(schedule_policy="dynamic")
    with torch.no_grad():
        got = forward(served, cfg, rc, {"tokens": toks})[0]
        want = forward(whole, cfg, rc, {"tokens": toks})[0]
    assert torch.equal(got, want)
    done = serve_launcher.main(
        ["--arch", "moonshot-v1-16b-a3b", "--reduce", "--layers", "3",
         "--ckpt-dir", split, "--dtype", "fp32", "--device", "cpu",
         "--requests", "2", "--max-new", "4"])
    reqs = [Request(rid=r.rid, prompt=r.prompt, max_new=4) for r in done]
    ServeEngine(cfg, whole, slots=2, device="cpu",
                capacity=max(len(r.prompt) for r in reqs) + 5,
                rc=RunConfig(schedule_policy="dynamic", moe_stats=True)
                ).run(reqs)
    assert [r.out for r in reqs] == [r.out for r in done]


# ----------------------------------------------------------------------
# compressed_psum, combine_stats, flash offsets
# ----------------------------------------------------------------------
def test_compressed_psum_over_a_pod_group_of_4(runs):
    g = runs["psum_g"]
    got = runs["4x1x1/psum"]
    plain = g.sum(0)
    rel = np.abs(got - plain).max() / np.abs(plain).max()
    assert rel < 2e-2, rel
    qs = [jcomp.quantize(jnp.asarray(row)) for row in g]
    ref = np.asarray(jnp.tensordot(jnp.stack([s for _, s in qs]),
                                   jnp.stack([q for q, _ in qs]).astype(
                                       jnp.float32), axes=(0, 0)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    for other in runs["others"]:
        if "4x1x1/psum" in other:
            assert np.array_equal(other["4x1x1/psum"], got)


def test_combine_stats_over_a_model_group_of_4(runs):
    job = combine_job()
    q, k, v = (jnp.asarray(job[n]) for n in ("q", "k", "v"))
    ref = jattn.naive_attention(q, k, v, causal=False,
                                kv_limit=jnp.int32(k.shape[1] - 1))
    np.testing.assert_allclose(runs["1x1x4/combine"], np.asarray(ref),
                               rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("causal,window,q_off,kv_off", [
    (True, None, 40, 0), (True, 24, 48, 16), (False, None, 0, 32),
    (True, None, 16, 16)])
def test_flash_offsets_match_reference(causal, window, q_off, kv_off):
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 8)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=8, kv_chunk=8)
    for stats in (False, True):
        want = jattn.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            q_offset=q_off, kv_offset=kv_off, return_stats=stats, **kw)
        got = tattn.flash_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            q_offset=q_off, kv_offset=kv_off, return_stats=stats, **kw)
        if not stats:
            want, got = (want,), (got,)
        for w, g in zip(want, got):
            w = np.asarray(w)
            g = g.numpy()
            if w.min() < -1e29:              # the running max's -inf
                assert np.array_equal(g <= -1e29, w <= -1e29)
                g, w = np.where(w <= -1e29, 0, g), np.where(w <= -1e29, 0, w)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# The EP layer on the global x under autograd
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["ep_fixed", "ep_capacity"])
def test_apply_moe_ep_global_under_autograd(runs, name):
    """2 ranks split the sequence; the single-device layer with the EP
    layer's loss: the router losses the mean of each rank's slice's."""
    job = ep_job()
    policy, cf = (("fixed", 2.0) if name == "ep_fixed"
                  else ("capacity_factor", 0.5))
    got = runs[f"1x1x2/{name}"]
    moe = MoEConfig(**job["moe"])
    cfg = dispatch_config(moe, executor="cuda", schedule_policy=policy,
                          capacity_factor=cf)
    p = {k: torch.from_numpy(v.copy()).requires_grad_()
         for k, v in job["params"].items()}
    x = torch.from_numpy(job["x"].copy()).requires_grad_()
    y, _ = apply_moe(p, x, cfg)
    d, S = x.shape[-1], x.shape[1]
    auxes = [plan_dispatch(x[:, r * S // 2:(r + 1) * S // 2].reshape(-1, d),
                           p["router"], cfg, with_schedule=False).aux
             for r in range(2)]
    lb = (auxes[0]["lb_loss"] + auxes[1]["lb_loss"]) / 2
    z = (auxes[0]["router_z"] + auxes[1]["router_z"]) / 2
    ((y * torch.from_numpy(job["dy"])).sum() + lb + z).backward()
    np.testing.assert_allclose(got["y"], y.detach().numpy(), rtol=2e-4,
                               atol=2e-4)
    assert abs(got["lb_loss"] - float(lb)) <= AUX_TOL
    assert abs(got["router_z"] - float(z)) <= AUX_TOL
    np.testing.assert_allclose(got["dx"], x.grad.numpy(), **TOL)
    for k, v in p.items():
        want = v.grad.numpy()
        if want.ndim == 3:                  # rank 0's experts
            want = want[:moe.n_experts // 2]
            np.testing.assert_allclose(got["grads"][k][:moe.n_experts // 2],
                                       want, err_msg=k, **TOL)
        else:
            np.testing.assert_allclose(got["grads"][k], want, err_msg=k,
                                       **TOL)


# ----------------------------------------------------------------------
# The launcher
# ----------------------------------------------------------------------
def test_launcher_grid_2x2_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "moonshot-v1-16b-a3b", "--reduce", "--grid", "2x2", "--steps", "2",
         "--batch", "4", "--seq", "32", "--device", "cpu"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("done: ce ") == 1, out.stdout
    assert "[grid] 2x2 (data x model), 4 rank(s), backend gloo" in out.stdout
    assert out.stdout.count("[train] step") == 2


def test_rules_reach_the_backward_thread():
    """A CUDA backward runs on autograd's own thread, and under remat the
    layers' forward runs again there: the grid's rules must be visible to
    it.  The backward runs here on another thread, as on the card, and
    its gradients are bitwise those of a backward on this one."""
    import threading
    from repro_torch.data.pipeline import make_batch
    from repro_torch.distributed.ctx import use_rules
    from repro_torch.train.step import grid_rules, init_train_state
    grid = make_grid(1, 1, verbose=False)
    cfg = W.model_config("moonshot-v1-16b-a3b")
    rc = W.run_config("fixed", remat=True)
    model = init_train_state(cfg, 0, rc, device="cpu", grid=grid)["params"]
    toks = torch.from_numpy(make_batch(cfg, 2, 16, step=0)["tokens"])
    batch = {"tokens": toks, "labels": toks[:, 1:]}
    params = list(model.parameters())
    out = {}
    with use_rules(grid, grid_rules(cfg, grid, 2)):
        want = torch.autograd.grad(loss_fn(model, cfg, rc, batch)[0], params)
        loss, _ = loss_fn(model, cfg, rc, batch)

        def backward():
            try:
                out["grads"] = torch.autograd.grad(loss, params)
            except BaseException as e:         # reported below
                out["error"] = e
        t = threading.Thread(target=backward)
        t.start()
        t.join()
    assert "error" not in out, out.get("error")
    for g, w in zip(out["grads"], want):
        assert torch.equal(g, w)
