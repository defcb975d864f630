"""The late families' training on a grid of ranks against the reference,
on the CPU: rwkv6-1.6b and zamba2-7b (the recurrent families, whose rules
split heads over 'model': tensor-parallel heads) and llama-3.2-vision-11b
and hubert-xlarge (sequence parallelism, as the transformer families).

* Specs, in process: ``param_specs`` (``fsdp`` and ``serve_tp``),
  ``batch_specs``, ``activation_rules`` and ``cache_specs`` equal the
  reference's entry for entry on ``AbstractMesh((2, 2), ("data",
  "model"))`` and ``((2, 2, 2), ("pod", "data", "model"))`` for the four
  reduced configs (zamba2 with 2 groups: both shared blocks and the
  suffix's own; the reference's stacked leading axes dropped).
* ``local_batch`` on every rank of a 2x2 grid: an encoder's ``features``,
  ``labels`` and ``mask`` cut over (batch, sequence), a vlm's
  ``image_embeds`` over the batch only, the recurrent families' tokens
  over the batch only (whole sequences on every 'model' rank); the blocks
  put back together are the whole batch.
* The sharded step: random weights in the reference's tree (``numpy_init``:
  its layout, its matrices' scales, and every leaf it inits to a constant
  drawn away from it, so that a rank's wrong slice of ``u``, ``w0``,
  ``dt_bias``, ``d_skip`` or a norm shows), carried across with
  ``from_jax_params``; one fp32 step on grids
  2x2 (4 spawned gloo ranks), 1x2 and 2x1 (2 ranks), the rank bodies in
  ``torch_sharded_worker``, against the reference's single-device jitted
  ``make_train_step`` (its own sharded step cannot run under this jax:
  ROADMAP C3): the loss, every gradient gathered from the blocks and
  every parameter after the step within 1e-4, ``tokens`` equal (each
  token counted once however many ranks hold it).  Batch 4 x seq 32,
  ``RunConfig(q_chunk=0, kv_chunk=16, loss_chunk=16)``, AdamW at eps 1e-3
  (each update a smooth function of its gradient: tests/test_torch_train.py).
* On the recurrent families' rules every rank's WKV recurrence and SSD
  scan take H/M of the heads (r, k, v, w and u; x, dt and a; B and C
  whole) and nothing is gathered; under sequence parallelism hubert
  gathers each layer's K and V over 'model' and the vlm its attention
  block's, its cross block nothing.
* On 2x2 the gradients with remat are bitwise those without; the 1x1
  grid is bitwise the unsharded port.
* Checkpoints: a step of each family on 2x2, saved, and restored onto
  1x2 is bitwise the saved leaves (``ln0``, ``shared.<j>`` once, the
  suffix's block, ``mask_emb``, the cross blocks).
* The launcher's ranks (``--grid``, ``launch.train.train_rank``) for the
  four reduced archs, run in the spawned groups.
"""
import json
import pathlib

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
from repro.models.lm import RunConfig as JaxRunConfig  # noqa: E402
from repro.models.lm import group_structure as jax_group_structure  # noqa
from repro.models.lm import init_cache as jax_init_cache  # noqa: E402
from repro.models.lm import init_params as jax_init_params  # noqa: E402
from repro.models.lm import loss_fn as jax_loss_fn  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.train.step import make_train_step as jax_make_step  # noqa: E402
from repro_torch.data.pipeline import local_batch, make_batch
from repro_torch.distributed import spawn_ranks
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.group import Grid, make_grid
from repro_torch.models.lm import init_cache, init_params, loss_fn
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.step import make_train_step, train_state
from repro_torch.weights import from_jax_params, from_jax_tree

import torch_sharded_worker as W
from reference_init import numpy_init
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("rwkv6-1.6b", "zamba2-7b", "llama-3.2-vision-11b", "hubert-xlarge")
RECURRENT = ("rwkv6-1.6b", "zamba2-7b")
GRIDS = ("1x2x2", "1x1x2", "1x2x1")            # pod x data x model
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
OPT = dict(W.OPT, eps=1e-3)
BATCH, SEQ = 4, W.SEQ
# the launcher's --grid for each arch, run by the 2-rank group
LAUNCHES = {"rwkv6-1.6b": "1x2", "zamba2-7b": "2x1",
            "llama-3.2-vision-11b": "1x2", "hubert-xlarge": "2x1"}


def jax_config(arch):
    return jax_reduced(jax_get_config(arch), layers=W.FAMILY_LAYERS[arch])


def jax_run_config():
    return JaxRunConfig(q_chunk=0, kv_chunk=16, loss_chunk=16,
                        moe_stats=True)


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ----------------------------------------------------------------------
# Specs
# ----------------------------------------------------------------------
class _Stacked:
    """A stacked leaf's spec (``body``, ``shared``): each entry's is the
    tail."""

    def __init__(self, spec, n):
        self.spec, self.shape = spec, (n,)

    def __getitem__(self, g):
        return self.spec[1:]


def _port_names(arch, tree, n_shared):
    """A reference spec tree (PartitionSpec leaves) as {port name: spec}."""
    tree = dict(jax.tree.map(tuple, tree,
                             is_leaf=lambda x: isinstance(x, P)))
    for key, n in (("body", 0), ("shared", n_shared)):
        if key in tree:
            tree[key] = jax.tree.map(lambda s, n=n: _Stacked(s, n),
                                     tree[key],
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
    jcfg, tcfg = jax_config(arch), W.model_config(arch)
    shapes = jax.eval_shape(lambda: jax_init_params(jcfg, jax.random.key(0)))
    want = _port_names(arch, jsh.param_specs(shapes, jcfg, jm, mode),
                       tcfg.n_shared_attn_blocks)
    got = tsh.param_specs(_port_params(arch), tcfg, dict(jm.shape), mode)
    assert got == want
    names = set(got)
    if arch == "rwkv6-1.6b":
        assert got["ln0.scale"] == (None,)
        assert got["layers.0.tm.u"] == (None, None)
    if arch == "zamba2-7b":
        assert {"shared.0.attn.wq", "shared.1.attn.wq"} <= names
        assert got["layers.1.ssm.conv_w"] == (None, "model")
    if arch == "hubert-xlarge":
        assert got["mask_emb"] == (None,)


def _jax_cache_layers(jcfg, cache):
    """The reference's cache as the port's: one flat dict per block."""
    prefix, body, n_groups, suffix = jax_group_structure(jcfg)

    def flat(kind, c):
        if kind == "rwkv":
            return {"tm_shift": c["tm"]["shift"], "tm_state": c["tm"]["state"],
                    "cm_shift": c["cm"]["shift"]}
        return dict(c["kv"]) if "kv" in c else dict(c)
    out = [flat(k, cache["prefix"][i]) for i, k in enumerate(prefix)]
    for g in range(n_groups):
        for i, k in enumerate(body):
            out.append(flat(k, jax.tree.map(
                lambda v: tuple(v)[1:], cache["body"][f"b{i}"],
                is_leaf=lambda x: isinstance(x, P))))
    out += [flat(k, cache["suffix"][i]) for i, k in enumerate(suffix)]
    return [{k: tuple(v) for k, v in layer.items()} for layer in out]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_activation_and_cache_specs_match_reference(arch, mesh):
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
    if tcfg.encoder_only:                 # no cache: trained only
        return
    for batch in (8, 2, 1):
        cache = jax.eval_shape(lambda: jax_init_cache(jcfg, batch, 64))
        want = _jax_cache_layers(jcfg, jsh.cache_specs(cache, jcfg, jm,
                                                       batch))
        got = tsh.cache_specs(init_cache(tcfg, batch, 64, device="cpu"),
                              tcfg, dict(jm.shape), batch)
        assert got == want, batch


class FakeGrid:
    """Coordinates only, no groups: a (data x model) grid's rank."""
    size, index = Grid.size, Grid.index
    axis_names = ("data", "model")

    def __init__(self, data, model, rank):
        self.sizes = {"pod": 1, "data": data, "model": model}
        self.coords = {"pod": 0, "data": rank // model, "model": rank % model}


@pytest.mark.parametrize("arch", ARCHS)
def test_local_batch_cuts_every_key_as_batch_specs_say(arch):
    cfg = W.model_config(arch)
    whole = make_batch(cfg, 4, 8, step=0)
    specs = tsh.batch_specs(cfg, {"data": 2, "model": 2}, "train", 4)
    blocks = [local_batch(whole, FakeGrid(2, 2, r), specs, cfg)
              for r in range(4)]
    for r, got in enumerate(blocks):
        d, m = r // 2, r % 2
        rows = slice(2 * d, 2 * d + 2)
        if arch in RECURRENT:             # whole sequences on every rank
            assert np.array_equal(got["tokens"], whole["tokens"][rows])
            assert np.array_equal(got["labels"], whole["tokens"][rows, 1:])
            continue
        pos = slice(4 * m, 4 * m + 4)
        for key in ("features", "labels", "mask"):
            if key in specs:              # the encoder's: not shifted
                assert np.array_equal(got[key], whole[key][rows, pos]), key
        if "image_embeds" in whole:       # the batch only
            assert np.array_equal(got["image_embeds"],
                                  whole["image_embeds"][rows])
            assert got["tokens"].shape == (2, 4)
            assert np.array_equal(got["labels"],
                                  whole["tokens"][rows, 4 * m + 1:4 * m + 5])
    # put back together: the whole batch
    for key in whole:
        rows = []
        for d in range(2):
            b0, b1 = blocks[2 * d][key], blocks[2 * d + 1][key]
            if arch in RECURRENT or key == "image_embeds":
                assert np.array_equal(b0, b1), key   # both 'model' ranks
                rows.append(b0)
            else:
                rows.append(np.concatenate([b0, b1], 1))
        assert np.array_equal(np.concatenate(rows, 0), whole[key]), key


def test_local_batch_keeps_model_idle_only_for_the_recurrent_families():
    # whole sequences on both 'model' ranks: the recurrent families' rules,
    # and a mistake for any other family or where the family is not given
    whole = make_batch(W.model_config("rwkv6-1.6b"), 4, 8, step=0)
    for arch in ("rwkv6-1.6b", "qwen2-7b"):
        cfg = W.model_config(arch)
        specs = tsh.batch_specs(cfg, {"data": 2, "model": 2}, "decode", 4)
        assert specs["tokens"][-1] is None
        if arch == "rwkv6-1.6b":
            got = local_batch(whole, FakeGrid(2, 2, 1), specs, cfg)
            assert np.array_equal(got["tokens"], whole["tokens"][:2])
            with pytest.raises(ValueError, match="does not cut"):
                local_batch(whole, FakeGrid(2, 2, 1), specs)
        else:
            with pytest.raises(ValueError, match="does not cut"):
                local_batch(whole, FakeGrid(2, 2, 1), specs, cfg)


# ----------------------------------------------------------------------
# The reference's side (in process) and the ranks (spawned)
# ----------------------------------------------------------------------
def case_inputs() -> dict:
    """Each arch's reference state (its constant leaves perturbed) and
    batch."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = jax_config(arch)
        params = jax.tree.map(jnp.asarray, numpy_init(jcfg, 10 + i))
        state = {"params": params, "opt": jax_adamw.init_opt_state(params)}
        batch = jax_make_batch(jcfg, BATCH, SEQ, step=0)
        out[arch] = (state, batch)
    return out


def reference_runs(inputs: dict) -> dict:
    """The reference's single-device loss, gradients and jitted step."""
    out = {}
    jopt = jax_adamw.OptConfig(**OPT)
    jrc = jax_run_config()
    for arch in ARCHS:
        jcfg = jax_config(arch)
        state, batch = inputs[arch]
        step = jax_make_step(jcfg, jrc, jopt, 1)

        def both(state, batch):            # one compile for both
            return (jax.value_and_grad(
                lambda p: jax_loss_fn(p, jcfg, jrc, batch), has_aux=True)(
                    state["params"]), step(state, batch))
        ((loss, metrics), grads), (new, step_metrics) = jax.jit(both)(
            state, batch)
        tcfg = W.model_config(arch)
        out[arch] = dict(
            tree=numpy_tree(state["params"]),
            batch={k: np.asarray(v) for k, v in batch.items()},
            loss=float(loss),
            metrics={k: float(v) for k, v in metrics.items()},
            step_metrics={k: float(v) for k, v in step_metrics.items()},
            grads=from_jax_tree(tcfg, numpy_tree(grads)),
            params=from_jax_tree(tcfg, numpy_tree(new["params"])))
    return out


def case_job(arch, inputs, remat=False):
    state, batch = inputs[arch]
    return dict(kind="case", arch=arch, policy="fixed", opt=OPT, heads=True,
                remat=remat, tree=numpy_tree(state["params"]),
                batch={k: np.asarray(v) for k, v in batch.items()})


def rank_runs(inputs: dict, tmp: pathlib.Path) -> dict:
    """Every grid's cases in two spawned groups (4 ranks, then 2)."""
    four = {f"{a}": case_job(a, inputs, remat=True) for a in ARCHS}
    four.update({f"ckpt/{a}": dict(kind="ckpt", arch=a, save=str(tmp / a),
                                   batch=BATCH) for a in ARCHS})
    two = {a: case_job(a, inputs) for a in ARCHS}
    sp = dict(two)
    sp.update({f"ckpt/{a}": dict(kind="ckpt", arch=a, restore=str(tmp / a),
                                 step=0) for a in ARCHS})
    dp = dict(two)
    for arch, grid in LAUNCHES.items():
        (sp if grid == "1x2" else dp)[f"launch/{arch}"] = dict(
            kind="launch", argv=["--arch", arch, "--reduce", "--grid", grid,
                                 "--steps", "2", "--batch", "2", "--seq",
                                 "32", "--device", "cpu"])
    out = spawn_ranks(W.rank_main, 4, "cpu", {"grids": [("1x2x2", four)]})
    out2 = spawn_ranks(W.rank_main, 2, "cpu",
                       {"grids": [("1x1x2", sp), ("1x2x1", dp)]})
    res = dict(out[0])
    res.update(out2[0])
    res["others"] = [dict(o) for o in out[1:]] + [dict(o) for o in out2[1:]]
    res["tmp"] = tmp
    return res


@pytest.fixture(scope="module")
def both_sides(tmp_path_factory):
    """The ranks run in a thread while the reference compiles here."""
    from concurrent.futures import ThreadPoolExecutor
    inputs = case_inputs()
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(rank_runs, inputs,
                            tmp_path_factory.mktemp("family_grid"))
        ref = reference_runs(inputs)
        return ref, ranks.result()


@pytest.fixture(scope="module")
def reference(both_sides):
    return both_sides[0]


@pytest.fixture(scope="module")
def runs(both_sides):
    return both_sides[1]


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_reference(runs, reference, arch, grid):
    got, ref = runs[f"{grid}/{arch}"], reference[arch]
    assert abs(got["loss"] - ref["loss"]) <= 1e-4
    for key in ("ce", "tokens"):
        np.testing.assert_allclose(got["metrics"][key], ref["metrics"][key],
                                   **TOL)
    assert got["metrics"]["tokens"] == ref["metrics"]["tokens"]
    assert set(got["grads"]) == set(ref["grads"])
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g, ref["grads"][name], err_msg=name, **TOL)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got["step_metrics"][key],
                                   ref["step_metrics"][key], err_msg=key,
                                   **TOL)
    for name, p in got["params"].items():
        np.testing.assert_allclose(p, ref["params"][name], err_msg=name,
                                   **TOL)
    for other in runs["others"]:          # every rank holds the same loss
        if f"{grid}/{arch}" in other:
            assert other[f"{grid}/{arch}"]["loss"] == got["loss"]
            assert other[f"{grid}/{arch}"]["step_metrics"] \
                == got["step_metrics"]


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_runs_its_heads_or_its_sequence_block(runs, arch, grid):
    """The recurrent rules: H/M heads at every WKV recurrence (r, k, v, w
    and u) and SSD scan (x, dt, a; B and C whole), whole sequences, no
    gather.  Sequence parallelism: hubert gathers each layer's K and V
    from (B/D, S/M) blocks, the vlm its attention block's and nothing for
    its cross block."""
    _, data, model = (int(v) for v in grid.split("x"))
    cfg = W.model_config(arch)
    b = BATCH // data
    got = runs[f"{grid}/{arch}"]
    if arch == "rwkv6-1.6b":
        n = cfg.rwkv.head_size
        h = cfg.d_model // n // model
        assert got["heads"] == [("wkv", [(b, SEQ, h, n)] * 4
                                 + [(h, n)])] * cfg.n_layers
    elif arch == "zamba2-7b":
        s = cfg.ssm
        h = s.expand * cfg.d_model // s.head_dim // model
        g = (b, SEQ, s.n_groups, s.d_state)
        n_mamba = cfg.n_layers
        assert got["heads"] == [("ssd", [(b, SEQ, h, s.head_dim),
                                         (b, SEQ, h), g, g, (h,)])] \
            * n_mamba
    else:
        assert got["heads"] == []
    if arch in RECURRENT:
        assert got["gathers"] == []
        return
    kv = (b, SEQ // model, cfg.n_kv_heads, cfg.head_dim)
    n_self = sum(k != "cross" for k in jax_group_structure(
        jax_config(arch))[1]) * (cfg.n_layers // (cfg.cross_attn_every or 1))
    assert got["gathers"] == [kv, kv] * n_self


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_bitwise_on_the_grid(runs, arch):
    assert runs[f"1x2x2/{arch}"]["remat_bitwise"]


@pytest.mark.parametrize("arch", ARCHS)
def test_grid_1x1_is_bitwise_the_unsharded_port(reference, arch):
    ref = reference[arch]
    job = dict(kind="case", arch=arch, policy="fixed", opt=OPT,
               tree=ref["tree"], batch=ref["batch"])
    got = W.run_case(job, make_grid(1, 1, verbose=False), True)
    cfg, rc = W.model_config(arch), W.run_config("fixed")
    model = train_state(from_jax_params(cfg, ref["tree"], device="cpu"))
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    loss, metrics = loss_fn(model["params"], cfg, rc, batch)
    params = dict(model["params"].named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    assert got["loss"] == float(loss)
    assert got["metrics"] == {k: float(v) for k, v in metrics.items()}
    for (name, _), g in zip(params.items(), grads):
        assert np.array_equal(got["grads"][name], g.numpy()), name
    state, m = make_train_step(cfg, rc, OptConfig(**OPT))(
        train_state(from_jax_params(cfg, ref["tree"], device="cpu")),
        batch)
    assert got["step_metrics"] == {k: float(v) for k, v in m.items()}
    for name, p in state["params"].named_parameters():
        assert np.array_equal(got["params"][name], p.detach().numpy()), name


# ----------------------------------------------------------------------
# Checkpoints
# ----------------------------------------------------------------------
def saved_leaves(path: pathlib.Path) -> dict:
    meta = json.load(open(path / "manifest.json"))["leaves"]
    return {m["name"]: np.load(path / f"leaf_{i}.npy")
            for i, m in enumerate(meta)}


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_from_2x2_restores_onto_1x2_bitwise(runs, arch):
    saved = saved_leaves(runs["tmp"] / arch / "ckpt_00000000")
    got = runs[f"1x1x2/ckpt/{arch}"]["leaves"]
    assert set(got) == set(saved)
    new = {"rwkv6-1.6b": "params/ln0.scale",
           "zamba2-7b": "params/shared.1.attn.wq",
           "llama-3.2-vision-11b": "params/layers.0.attn.wq",
           "hubert-xlarge": "params/mask_emb"}[arch]
    assert new in saved
    if arch == "zamba2-7b":               # each shared block once
        assert not any(n.startswith("params/layers.0.") for n in saved)
    for name, arr in saved.items():
        assert got[name].dtype == arr.dtype, name
        assert np.array_equal(got[name], arr), name


# ----------------------------------------------------------------------
# The launcher
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(LAUNCHES))
def test_launcher_grid_on_the_cpu(runs, arch):
    grid = LAUNCHES[arch]
    out = runs[f"1x{grid}/launch/{arch}"]
    assert out.count("done: ce ") == 1, out
    assert f"[grid] {grid} (data x model), 2 rank(s), backend gloo" in out
    assert out.count("[train] step") == 2
