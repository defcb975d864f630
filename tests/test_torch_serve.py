"""Greedy tokens from the port's ``ServeEngine`` must be identical to
``repro.serve.engine.ServeEngine`` on reduced moonshot-v1-16b-a3b (3
layers), contiguous cache (``kv_block_size=0``), fixed policy, fp32: five
requests of mixed prompt lengths on two slots, so slot reuse and
compaction run.

The JAX side uses ``executor="xla"`` for speed: JAX's own tests hold xla ==
pallas (tests/test_execution.py, rtol = atol = 2e-4), and the port's
kernels are held against the pallas executor in test_torch_dispatch.py and
test_torch_model.py."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models.lm import RunConfig as JaxRunConfig
from repro.models.lm import init_params as jax_init_params
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.launch.serve import main as launch_main
from repro_torch.models.lm import RunConfig
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.weights import from_jax_params

LENGTHS = (5, 17, 3, 11, 8)
MAX_NEW = (6, 4, 7, 5, 3)


def test_greedy_tokens_identical_to_reference_engine():
    jcfg = jax_reduced(jax_get_config("moonshot-v1-16b-a3b"), layers=3)
    tcfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=3)
    params = jax_init_params(jcfg, jax.random.key(0))
    model = from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n in LENGTHS]

    jeng = JaxServeEngine(jcfg, params, slots=2, capacity=48,
                          rc=JaxRunConfig(executor="xla",
                                          schedule_policy="fixed",
                                          q_chunk=64, kv_chunk=64),
                          kv_block_size=0)
    jreqs = [JaxRequest(rid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]
    jeng.run(jreqs, max_steps=64)

    teng = ServeEngine(tcfg, model, slots=2, capacity=48, device="cpu")
    treqs = [Request(rid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]
    done = teng.run(treqs, max_steps=64)

    assert len(done) == len(treqs) and all(r.done for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert [len(r.out) for r in treqs] == list(MAX_NEW)
    assert teng.n_active == 0


def test_engine_refuses_configurations_it_does_not_serve():
    tcfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=2)
    from repro_torch.models.lm import init_params
    model = init_params(tcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="contiguous"):
        ServeEngine(tcfg, model, kv_block_size=16, device="cpu")
    with pytest.raises(ValueError, match="greedy"):
        ServeEngine(tcfg, model, sampling="top_p", device="cpu")
    with pytest.raises(ValueError, match="fixed"):
        ServeEngine(tcfg, model, rc=RunConfig(schedule_policy="dynamic"),
                    device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ServeEngine(tcfg, model)


def test_launcher_serves_on_cpu_when_asked(capsys, monkeypatch):
    """The launcher's flags end to end, on a reduced-width config so that
    the CPU run stays small (the card runs it at full width)."""
    import repro_torch.configs as configs
    small = reduced(get_config("moonshot-v1-16b-a3b"), layers=3)
    monkeypatch.setattr(configs, "get_config", lambda name: small)
    done = launch_main(["--arch", "moonshot-v1-16b-a3b", "--layers", "2",
                        "--requests", "3", "--max-new", "2", "--slots", "2",
                        "--dtype", "fp32", "--device", "cpu"])
    assert len(done) == 3 and all(len(r.out) == 2 for r in done)
    assert "3/3 requests completed" in capsys.readouterr().out
