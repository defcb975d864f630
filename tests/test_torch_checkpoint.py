"""The rest of the port's training on the CPU: the checkpoint manager,
resume after a failure, gradient compression and remat (counterparts of
``tests/test_train.py``'s checkpoint and compression tests).

* ``CheckpointManager``: the write is atomic (no ``tmp.*`` left, every
  leaf and the manifest under ``ckpt_<step:08d>``), garbage collection
  keeps the last 2, ``restore`` loads the latest in place, bf16 leaves
  round-trip bitwise as raw 16-bit words; async and sync alike.
* A run of reduced moonshot-v1-16b-a3b (2 layers: 1 dense + 1 MoE) with a
  failure injected at step 6 and ``save_every=2``, restarted by
  ``supervise``, resumes from the checkpoint of step 4 and ends within
  1e-6 of an uninterrupted run.
* A dense checkpoint restored into a model whose routed experts are
  quantized (``quantize_model``), and the reverse, raise the reference's
  structure-mismatch error.
* ``quantize`` and ``compress_with_feedback`` against
  ``repro.optim.compress``: the int8 payload bitwise, the scale within 1
  ulp, the residual carried over 3 steps.
* ``remat=True``: the loss and every gradient bitwise those with
  ``remat=False``, and within 1e-5 / 1e-4 of the reference's loss and
  gradients with ``remat=True``; each MoE layer's forward kernels run once
  more in the backward.
* The launcher with ``--ckpt-dir``: a second run resumes.
* ``restore_params``: a 2-step training checkpoint's ``params/*`` into a
  bf16 model are the saved fp32 parameters cast by ``.to``, bitwise (fp32
  bitwise too), ``opt/*`` skipped; a deeper or a quantized target names
  the leaves it lacks or the checkpoint lacks; the strict ``restore``
  still refuses another dtype and another structure.
"""
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models.lm import RunConfig as JaxRunConfig  # noqa: E402
from repro.models.lm import init_params as jax_init_params  # noqa: E402
from repro.models.lm import loss_fn as jax_loss_fn  # noqa: E402
from repro.optim import compress as jcomp  # noqa: E402
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.launch import train as train_launcher
from repro_torch.models.lm import RunConfig, init_params, loss_fn
from repro_torch.optim import adamw, compress
from repro_torch.quantization import quantize_model
from repro_torch.runtime.fault import supervise
from repro_torch.train.loop import train
from repro_torch.weights import from_jax_params, from_jax_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

LOSS_CHUNK = 8


def cfg2():
    return reduced(get_config("moonshot-v1-16b-a3b"), layers=2)


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_atomic_and_gc(tmp_path, async_save):
    m = CheckpointManager(str(tmp_path), keep_last=2, async_save=async_save)
    state = {"w": torch.arange(4.0), "n": torch.tensor(3, dtype=torch.int32),
             "h": {"b": torch.linspace(-2, 2, 6).to(torch.bfloat16)}}
    for s in (1, 2, 3):
        m.save(s, {"w": state["w"] + s, "n": state["n"] + s,
                   "h": {"b": state["h"]["b"] * s}})
    m.wait()
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["ckpt_00000002", "ckpt_00000003"]   # gc keeps last 2
    assert m.latest_step() == 3
    manifest = json.loads((tmp_path / "ckpt_00000003" /
                           "manifest.json").read_text())
    assert manifest["step"] == 3
    assert [leaf["name"] for leaf in manifest["leaves"]] == ["w", "n", "h/b"]
    assert manifest["leaves"][2] == {"name": "h/b", "shape": [6],
                                     "dtype": "bfloat16"}
    target = {"w": torch.zeros(4), "n": torch.zeros((), dtype=torch.int32),
              "h": {"b": torch.zeros(6, dtype=torch.bfloat16)}}
    assert m.restore(target) is target
    assert torch.equal(target["w"], state["w"] + 3)
    assert int(target["n"]) == 6
    assert torch.equal(target["h"]["b"], state["h"]["b"] * 3)
    m.restore(target, step=2)
    assert torch.equal(target["w"], state["w"] + 2)
    with pytest.raises(ValueError, match="checkpoint float32"):
        m.restore({"w": torch.zeros(5), "n": target["n"],
                   "h": target["h"]})


def test_failure_at_step_6_resumes_from_4_and_ends_as_a_clean_run(tmp_path):
    cfg = cfg2()
    rc = RunConfig(loss_chunk=LOSS_CHUNK)
    opt = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=20,
                          weight_decay=0.0)
    kw = dict(steps=7, batch=2, seq=16, save_every=2, log_every=50,
              log=lambda s: None, device="cpu")
    attempts = []

    def run():
        attempts.append(len(attempts))
        return train(cfg, rc, opt, ckpt_dir=str(tmp_path / "a"),
                     fail_at=6 if len(attempts) == 1 else None, **kw)
    out = supervise(run)
    assert out["restarts"] == 1 and out["resumed_from"] == 4
    clean = train(cfg, rc, opt, **kw)
    assert clean["resumed_from"] is None
    for (name, p), q in zip(out["state"]["params"].named_parameters(),
                            clean["state"]["params"].parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) \
        == ["ckpt_00000002", "ckpt_00000004", "ckpt_00000006"]


@pytest.mark.parametrize("direction", ["dense_into_quantized",
                                       "quantized_into_dense"])
def test_restore_across_quantization_raises(tmp_path, direction):
    cfg = cfg2()
    dense = init_params(cfg, 0, device="cpu")
    quant = quantize_model(init_params(cfg, 0, device="cpu"), "int8_expert")
    src, dst = (dense, quant) if direction == "dense_into_quantized" \
        else (quant, dense)
    m = CheckpointManager(str(tmp_path), async_save=False)
    m.save(1, {"params": src})
    with pytest.raises(ValueError, match="STRUCTURES differ"):
        m.restore({"params": dst})


def test_quantize_matches_reference():
    rng = np.random.default_rng(0)
    for g in (rng.standard_normal(257).astype(np.float32) * 0.1,
              np.linspace(-1, 1, 255, dtype=np.float32),
              rng.standard_normal((16, 24)).astype(np.float32) * 3.0):
        q, s = compress.quantize(torch.from_numpy(g))
        qj, sj = jcomp.quantize(jnp.asarray(g))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
        np.testing.assert_array_max_ulp(s.numpy(), np.asarray(sj), maxulp=1)
        deq = compress.dequantize(q, s)
        assert float((deq - torch.from_numpy(g)).abs().max()) \
            <= float(s) * 0.51


def test_compress_with_feedback_matches_reference():
    rng = np.random.default_rng(1)
    grads = [{"a": rng.standard_normal(64).astype(np.float32) * 0.1,
              "b": rng.standard_normal((8, 4)).astype(np.float32)}
             for _ in range(3)]
    err = compress.init_error_state({k: torch.from_numpy(v)
                                     for k, v in grads[0].items()})
    err_j = jcomp.init_error_state({k: jnp.asarray(v)
                                    for k, v in grads[0].items()})
    for g in grads:
        packed, err = compress.compress_with_feedback(
            {k: torch.from_numpy(v) for k, v in g.items()}, err)
        packed_j, err_j = jcomp.compress_with_feedback(
            {k: jnp.asarray(v) for k, v in g.items()}, err_j)
        for k in g:
            (q, s), (qj, sj) = packed[k], packed_j[k]
            np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
            np.testing.assert_array_max_ulp(s.numpy(), np.asarray(sj),
                                            maxulp=1)
            np.testing.assert_allclose(err[k].numpy(), np.asarray(err_j[k]),
                                       rtol=0, atol=1e-6)


def counted_ops(monkeypatch):
    """Count the calls of the MoE kernels' ops wrappers (here they run the
    plain versions; on the card each call is one launch)."""
    calls = {}
    for name in ("router_topk", "permute", "unpermute", "fused_gate_up",
                 "grouped_gemm", "grouped_gemm_t", "grouped_wgrad"):
        fn = getattr(ops, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, wrapped)
    return calls


@pytest.mark.parametrize("policy", ["fixed", "capacity_factor"])
def test_remat_is_bitwise_and_matches_the_reference(monkeypatch, policy):
    jcfg = jax_reduced(jax_get_config("moonshot-v1-16b-a3b"), layers=2)
    cfg = cfg2()
    params = jax_init_params(jcfg, jax.random.key(0))
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                             (2, 16)).astype(np.int32)
    kw = dict(schedule_policy=policy, capacity_factor=1.25,
              loss_chunk=LOSS_CHUNK)
    calls = counted_ops(monkeypatch)
    got = {}
    for remat in (False, True):
        model = from_jax_params(cfg, jax.tree.map(np.asarray, params),
                                device="cpu").requires_grad_(True)
        calls.clear()
        loss, _ = loss_fn(model, cfg, RunConfig(remat=remat, **kw),
                          {"tokens": torch.from_numpy(toks)})
        named = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        got[remat] = (loss.detach(), dict(zip(named, grads)), dict(calls))
    (loss0, g0, c0), (loss1, g1, c1) = got[False], got[True]
    assert torch.equal(loss0, loss1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    # one MoE layer: its forward's kernels once more, the backward's not
    assert c0 == {"router_topk": 1, "permute": 2, "unpermute": 2,
                  "fused_gate_up": 1, "grouped_gemm": 3,
                  "grouped_gemm_t": 3, "grouped_wgrad": 3}
    assert c1 == {**c0, "router_topk": 2, "permute": 3, "unpermute": 3,
                  "fused_gate_up": 2, "grouped_gemm": 4}
    (loss_j, _), g_j = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, jcfg, JaxRunConfig(remat=True, **kw),
                              {"tokens": jnp.asarray(toks)}),
        has_aux=True))(params)
    np.testing.assert_allclose(float(loss1), float(loss_j), rtol=1e-5,
                               atol=1e-5)
    want = from_jax_tree(cfg, jax.tree.map(np.asarray, g_j))
    for name, g in g1.items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_launcher_resumes_from_its_checkpoint_dir(tmp_path, capsys):
    argv = ["--arch", "moonshot-v1-16b-a3b", "--reduce", "--batch", "2",
            "--seq", "16", "--dtype", "fp32", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--save-every", "2"]
    first = train_launcher.main(argv + ["--steps", "3"])
    assert first["resumed_from"] is None and len(first["history"]) == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt_00000002"]
    again = train_launcher.main(argv + ["--steps", "5"])
    assert again["resumed_from"] == 2
    assert [h["step"] for h in again["history"]] == [3, 4]
    assert "remat False" in capsys.readouterr().out      # --reduce: no remat
    assert sorted(p.name for p in tmp_path.iterdir()) \
        == ["ckpt_00000002", "ckpt_00000004"]


@pytest.fixture(scope="module")
def trained_ckpt(tmp_path_factory):
    """A 2-step training checkpoint of reduced moonshot (fp32 master
    weights and AdamW moments) and the trained model."""
    root = tmp_path_factory.mktemp("train_ckpt")
    out = train(cfg2(), RunConfig(loss_chunk=LOSS_CHUNK),
                adamw.OptConfig(lr=1e-3, warmup_steps=1, total_steps=4),
                steps=2, batch=2, seq=16, ckpt_dir=str(root),
                log=lambda s: None, device="cpu")
    return root, out["state"]["params"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_restore_params_of_a_training_checkpoint(trained_ckpt, dtype):
    """``params/*`` of a training state into a model of another dtype:
    each leaf is the saved fp32 parameter cast by ``.to``, bitwise (fp32
    itself bitwise); ``opt/*`` is skipped."""
    root, trained = trained_ckpt
    manifest = json.loads((root / "ckpt_00000001" / "manifest.json")
                          .read_text())
    assert any(m["name"].startswith("opt/") for m in manifest["leaves"])
    model = init_params(cfg2(), 5, param_dtype=dtype, device="cpu")
    m = CheckpointManager(str(root))
    assert m.restore_params(model) is model
    assert m.stats["restore_step"] == 1
    saved = dict(trained.named_parameters())
    assert m.stats["restore_bytes"] == sum(
        p.numel() * 4 for p in saved.values())
    cast = 0
    for name, p in model.named_parameters():
        want = saved[name].detach().to(p.dtype)  # fp32 vectors stay fp32
        cast += p.dtype == dtype
        assert torch.equal(p, want), name
    assert cast >= 8          # every matrix in ``dtype``


@pytest.mark.parametrize("target", ["deeper", "quantized"])
def test_restore_params_names_a_missing_leaf(trained_ckpt, target):
    root, _ = trained_ckpt
    cfg = cfg2()
    if target == "deeper":
        model = init_params(cfg.replace(n_layers=3), 0, device="cpu")
        match = r"the target has, the checkpoint lacks, \d+ leaves " \
                r"\(layers\.2\."
    else:
        model = quantize_model(init_params(cfg, 0, device="cpu"),
                               "int8_expert")
        match = (r"the target has, the checkpoint lacks, 6 leaves "
                 r"\(layers\.1\.moe\.w_gate_q.*the checkpoint has, the "
                 r"target lacks, 3 leaves \(layers\.1\.moe\.w_gate")
    with pytest.raises(ValueError, match=match):
        CheckpointManager(str(root)).restore_params(model)


def test_strict_restore_stays_strict(trained_ckpt):
    """The whole-state ``restore`` still takes the exact structure and
    dtypes: a bf16 model of the trainer's state is refused."""
    root, trained = trained_ckpt
    from repro_torch.train.step import train_state
    m = CheckpointManager(str(root))
    state = train_state(init_params(cfg2(), 0, param_dtype=torch.bfloat16,
                                    device="cpu"))
    with pytest.raises(ValueError, match="checkpoint float32"):
        m.restore(state)
    with pytest.raises(ValueError, match="STRUCTURES differ"):
        m.restore({"params": init_params(cfg2(), 0, device="cpu")})
