"""Train, checkpoint, serve what training wrote (counterpart of
``tests/test_system.py``), on the CPU in fp32.

* Reduced smollm-360m (2 layers, d_model 64, vocab 64) from one numpy
  draw (``tests/reference_init.numpy_init``), trained 30 steps by the
  port's ``train()`` and by the reference's with a ``ckpt_dir`` and that
  test's optimizer; the port's checkpoint is served by
  ``repro_torch.launch.serve.main(["--ckpt-dir", ...])``.  Its greedy
  tokens equal a ``ServeEngine`` over the port's in-memory trained model,
  and the reference's engine over the reference's parameters restored as
  ``test_system.py`` restores them (into ``init_train_state``'s tree).
  The port's trained loss is below 0.8 log V.
* A 2-step training checkpoint of each trained family (moonshot with
  ``--quant int8_expert``, deepseek-v2 with MLA, rwkv6, zamba2 at 7
  layers, the vlm) served by the launcher: the tokens of an engine over
  the in-memory model.
* C19: the reference launcher's restore target, ``{"params":
  init_params(...)}``, cannot read the reference's own training
  checkpoint (34 leaves against 11).
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import RunConfig as JaxRunConfig  # noqa: E402
from repro.models.lm import init_params as jax_init_params  # noqa: E402
from repro.optim.adamw import OptConfig as JaxOptConfig  # noqa: E402
from repro.optim.adamw import init_opt_state as jax_init_opt_state  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.train import loop as jax_loop  # noqa: E402
from repro.train.step import init_train_state as jax_init_train_state  # noqa: E402
from reference_init import numpy_init  # noqa: E402
import repro_torch.configs  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.models.lm import RunConfig, loss_fn  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train import loop as torch_loop  # noqa: E402
from repro_torch.train.step import train_state  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401,E402  (autouse fixture)

ARCH = "smollm-360m"
SHAPE = dict(layers=2, d_model=64, vocab=64)      # test_system.py's
OPT = dict(lr=1e-2, warmup_steps=5, total_steps=60, weight_decay=0.0)
TRAIN = dict(steps=30, batch=8, seq=64, save_every=10, log_every=10,
             log=lambda s: None)
RC = dict(q_chunk=16, kv_chunk=16, loss_chunk=32)
SERVE = ["--requests", "2", "--max-new", "6", "--slots", "2",
         "--dtype", "fp32", "--device", "cpu"]


def served(argv, monkeypatch, shape=None):
    """The launcher's completed requests, by rid; ``shape`` overrides what
    its ``--reduce`` cuts to."""
    if shape is not None:
        monkeypatch.setattr(repro_torch.configs, "reduced",
                            functools.partial(reduced, **shape))
    done = serve_launcher.main(argv + SERVE)
    assert len(done) == 2
    return sorted(done, key=lambda r: r.rid)


def engine_tokens(cfg, model, done, quant="none"):
    """The launcher's requests through an engine over ``model``, as the
    launcher builds its engine."""
    reqs = [Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
            for r in done]
    capacity = max(len(r.prompt) for r in reqs) + reqs[0].max_new + 1
    rc = RunConfig(schedule_policy="dynamic", quant=quant,
                   moe_stats=bool(cfg.is_moe))
    ServeEngine(cfg, model, slots=2, capacity=capacity, rc=rc,
                device="cpu").run(reqs)
    return [r.out for r in reqs]


@pytest.fixture(scope="module")
def smollm(tmp_path_factory):
    """Both sides trained from one numpy draw, each with a checkpoint."""
    jcfg = jax_reduced(jax_get_config(ARCH), **SHAPE)
    cfg = reduced(get_config(ARCH), **SHAPE)
    tree = numpy_init(jcfg, 0)
    jtree = jax.tree.map(jnp.asarray, tree)
    root = tmp_path_factory.mktemp("system")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loop, "init_train_state", lambda c, key, rc: {
            "params": jtree, "opt": jax_init_opt_state(jtree)})
        ref = jax_loop.train(jcfg, JaxRunConfig(**RC), JaxOptConfig(**OPT),
                             ckpt_dir=str(root / "ref"), **TRAIN)
        mp.setattr(torch_loop, "init_train_state",
                   lambda c, seed, rc, **kw: train_state(
                       from_jax_params(cfg, tree, device="cpu")))
        port = torch_loop.train(cfg, RunConfig(**RC), OptConfig(**OPT),
                                ckpt_dir=str(root / "port"), device="cpu",
                                **TRAIN)
    return dict(jcfg=jcfg, cfg=cfg, ref=ref, port=port, root=root)


def test_train_checkpoint_serve_roundtrip(smollm, monkeypatch):
    cfg, port, root = smollm["cfg"], smollm["port"], smollm["root"]
    hist = port["history"]
    assert hist[-1]["ce"] < hist[0]["ce"]
    np.testing.assert_allclose(hist[-1]["ce"], smollm["ref"]["history"][-1]
                               ["ce"], rtol=1e-4)
    done = served(["--arch", ARCH, "--reduce", "--ckpt-dir",
                   str(root / "port")], monkeypatch, SHAPE)
    got = [r.out for r in done]
    assert all(len(t) == 6 for t in got)
    model = port["state"]["params"]
    assert engine_tokens(cfg, model, done) == got

    # the reference's flow: its checkpoint restored into init_train_state's
    # tree, its engine over those parameters, the launcher's requests
    jcfg = smollm["jcfg"]
    abstract = jax.eval_shape(lambda: jax_init_train_state(
        jcfg, jax.random.key(0), JaxRunConfig(**RC)))
    params = JaxCheckpointManager(str(root / "ref")).restore(
        abstract)["params"]
    capacity = max(len(r.prompt) for r in done) + 6 + 1
    jreqs = [JaxRequest(rid=r.rid, prompt=r.prompt, max_new=6) for r in done]
    JaxServeEngine(jcfg, params, slots=2, capacity=capacity,
                   rc=JaxRunConfig(**RC)).run(jreqs)
    assert [list(r.out) for r in jreqs] == got

    # trained past chance on its own Markov stream
    batch = make_batch(cfg, 8, 64, step=999, seed=1)
    with torch.no_grad():
        loss, _ = loss_fn(model, cfg, RunConfig(**RC),
                          {k: torch.as_tensor(v) for k, v in batch.items()})
    assert float(loss) < 0.8 * np.log(cfg.vocab_size)


def test_c19_reference_launcher_target_cannot_read_a_training_checkpoint(
        smollm):
    """C19: the reference launcher restores into ``{"params":
    init_params(...)}`` (``repro/launch/serve.py``); a training checkpoint
    holds ``params`` and ``opt``, so the reference's manager refuses."""
    jcfg = smollm["jcfg"]
    target = jax.eval_shape(lambda: {
        "params": jax_init_params(jcfg, jax.random.key(0))})
    with pytest.raises(ValueError, match="holds 34 leaves but the restore "
                                         "target flattens to 11"):
        JaxCheckpointManager(str(smollm["root"] / "ref")).restore(target)


# (arch, launcher flags, reduced layers) of each trained family
FAMILIES = {
    "moonshot-int8": ("moonshot-v1-16b-a3b", ["--quant", "int8_expert"], 2),
    "deepseek-mla": ("deepseek-v2-236b", [], 2),
    "rwkv6": ("rwkv6-1.6b", [], 2),
    "zamba2": ("zamba2-7b", ["--layers", "7"], 7),
    "vlm": ("llama-3.2-vision-11b", [], 2),
}


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_family_training_checkpoint_serves(case, tmp_path, monkeypatch):
    arch, flags, layers = FAMILIES[case]
    cfg = reduced(get_config(arch), layers=layers)
    out = torch_loop.train(cfg, RunConfig(loss_chunk=16),
                           OptConfig(lr=1e-3, warmup_steps=1,
                                     total_steps=4),
                           steps=2, batch=2, seq=16, ckpt_dir=str(tmp_path),
                           log=lambda s: None, device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt_00000001"]
    done = served(["--arch", arch, "--reduce", "--ckpt-dir", str(tmp_path)]
                  + flags, monkeypatch)
    quant = "int8_expert" if "--quant" in flags else "none"
    assert engine_tokens(cfg, out["state"]["params"], done, quant) \
        == [r.out for r in done]
