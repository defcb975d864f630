"""Greedy tokens from the port's ``ServeEngine`` must be identical to
``repro.serve.engine.ServeEngine`` on reduced moonshot-v1-16b-a3b (3
layers, fp32), five requests of mixed prompt lengths on two slots, so slot
reuse and compaction run:

* contiguous cache (``kv_block_size=0``) with the ``fixed`` policy;
* the paged engine (blocks of 4, ``prefill_chunk`` 4, ``dynamic``) with
  prompts that share a prefix (prefix hits > 0) and take several chunks,
  through the fused paged read and the gather read.

The JAX side uses ``executor="xla"`` for speed: JAX's own tests hold xla ==
pallas (tests/test_execution.py, rtol = atol = 2e-4), and the port's
kernels are held against the pallas executor in test_torch_dispatch.py and
test_torch_model.py.  One small paged case runs the reference's fused
Pallas read in interpret mode.

The launcher's switches: ``--no-prefix-cache`` serves the shared-prefix
trace with no prefix hit and the same tokens, a ``--capacity`` below the
longest prompt + ``--max-new`` ends the run, and a reference command line
(``--kv-block-size``, ``--schedule-policy``, ``--prefix-cache``,
``--executor xla``) runs."""
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
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

LENGTHS = (5, 17, 3, 11, 8)
MAX_NEW = (6, 4, 7, 5, 3)


@pytest.fixture(scope="module")
def reduced_moonshot():
    jcfg = jax_reduced(jax_get_config("moonshot-v1-16b-a3b"), layers=3)
    tcfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=3)
    params = jax_init_params(jcfg, jax.random.key(0))
    model = from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    return jcfg, tcfg, params, model


def shared_prefix_prompts(vocab):
    """Requests 0, 2 and 4 share a 9-token prefix (two full 4-token
    blocks); the later ones are admitted after request 0's blocks are
    registered, so they hit the prefix cache."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, 9)
    return [(np.concatenate([shared, rng.integers(0, vocab, n)])
             if i % 2 == 0 else rng.integers(0, vocab, n + 3)
             ).astype(np.int32) for i, n in enumerate((2, 6, 4, 1, 5))]


def test_greedy_tokens_identical_to_reference_engine(reduced_moonshot):
    jcfg, tcfg, params, model = reduced_moonshot
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

    teng = ServeEngine(tcfg, model, slots=2, capacity=48, kv_block_size=0,
                       rc=RunConfig(schedule_policy="fixed"), device="cpu")
    treqs = [Request(rid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]
    done = teng.run(treqs, max_steps=64)

    assert len(done) == len(treqs) and all(r.done for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert [len(r.out) for r in treqs] == list(MAX_NEW)
    assert teng.n_active == 0


def test_paged_greedy_tokens_identical_to_reference_engine(reduced_moonshot):
    jcfg, tcfg, params, model = reduced_moonshot
    prompts = shared_prefix_prompts(tcfg.vocab_size)
    jeng = JaxServeEngine(jcfg, params, slots=2, capacity=32,
                          rc=JaxRunConfig(executor="xla",
                                          schedule_policy="dynamic",
                                          q_chunk=64, kv_chunk=64),
                          kv_block_size=4, prefill_chunk=4)
    jreqs = [JaxRequest(rid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]
    jeng.run(jreqs, max_steps=128)
    assert all(r.done for r in jreqs)
    for read in ("fused", "gather"):
        teng = ServeEngine(tcfg, model, slots=2, capacity=32,
                           kv_block_size=4, prefill_chunk=4,
                           rc=RunConfig(schedule_policy="dynamic",
                                        paged_attn=read), device="cpu")
        treqs = [Request(rid=i, prompt=p, max_new=m)
                 for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]
        done = teng.run(treqs, max_steps=128)
        assert len(done) == len(treqs) and teng.n_active == 0
        assert [r.out for r in treqs] == [r.out for r in jreqs], read
        for tr, jr in zip(treqs, jreqs):
            for key in ("serve/prefix_hit_tokens", "serve/prefill_forwards",
                        "serve/decode_batch"):
                assert tr.stats[key] == jr.stats[key], (read, key)
        st = teng.kv.stats()
        assert st["prefix_hit_tokens"] > 0 and st["blocks_in_use"] == 0
        assert st == {k: jeng.kv.stats()[k] for k in st}
        assert max(tr.stats["serve/prefill_forwards"] for tr in treqs) > 1


def test_paged_tokens_identical_to_reference_fused_interpret(
        reduced_moonshot):
    """The reference's fused Pallas paged read (interpret mode) on a small
    case: two requests, the second hits the first's prefix."""
    jcfg, tcfg, params, model = reduced_moonshot
    rng = np.random.default_rng(5)
    shared = rng.integers(0, tcfg.vocab_size, 5)
    prompts = [np.concatenate([shared, rng.integers(0, tcfg.vocab_size, n)]
                              ).astype(np.int32) for n in (1, 2)]
    jeng = JaxServeEngine(jcfg, params, slots=1, capacity=16,
                          rc=JaxRunConfig(executor="xla",
                                          schedule_policy="dynamic",
                                          paged_attn="fused",
                                          q_chunk=64, kv_chunk=64),
                          kv_block_size=4, prefill_chunk=4)
    jreqs = [JaxRequest(rid=i, prompt=p, max_new=3)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs, max_steps=32)
    teng = ServeEngine(tcfg, model, slots=1, capacity=16, kv_block_size=4,
                       prefill_chunk=4, device="cpu")
    assert teng.rc.schedule_policy == "dynamic"       # the engine default
    treqs = [Request(rid=i, prompt=p, max_new=3)
             for i, p in enumerate(prompts)]
    teng.run(treqs, max_steps=32)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert teng.kv.stats()["prefix_hit_tokens"] == 4


def test_engine_serves_paged_dynamic_and_refuses_the_rest():
    """The engine serves blocks of 16 and the dynamic policy with the plan
    stats on by default (paged wherever the model allows it);
    kv_block_size=0 keeps the contiguous engine; every registered admission
    policy builds, and so does a sampling config; an unknown sampling
    method, an unknown admission policy and a missing card raise."""
    tcfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=2)
    from repro_torch.models.lm import init_params
    model = init_params(tcfg, 0, device="cpu")
    eng = ServeEngine(tcfg, model, device="cpu")
    assert eng.paged and eng.kv_block_size == 16 and eng.cache is None
    assert eng.rc.schedule_policy == "dynamic" and eng.prefill_chunk == 32
    assert eng.rc.moe_stats
    eng = ServeEngine(tcfg, model, kv_block_size=16,
                      rc=RunConfig(schedule_policy="dynamic"), device="cpu")
    assert eng.kv.block_size == 16
    done = eng.run([Request(rid=0, prompt=np.arange(20, dtype=np.int32),
                            max_new=2)])
    assert len(done) == 1 and len(done[0].out) == 2
    eng = ServeEngine(tcfg, model, kv_block_size=0, device="cpu")
    assert not eng.paged and eng.kv is None
    from repro_torch.sampling import SamplingConfig
    assert ServeEngine(tcfg, model, sampling=SamplingConfig(method="top_p"),
                       device="cpu").describe()["sampling"] == "top_p"
    with pytest.raises(ValueError, match="unknown sampling method"):
        ServeEngine(tcfg, model, sampling=SamplingConfig(method="nope"),
                    device="cpu")
    for policy in ("fcfs", "sjf", "prefix_hit", "slo"):
        assert ServeEngine(tcfg, model, admission=policy,
                           device="cpu").describe()["admission"] == policy
    with pytest.raises(ValueError, match="unknown admission policy"):
        ServeEngine(tcfg, model, admission="nope", device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        ServeEngine(tcfg, model, capacity=8, device="cpu").admit(
            Request(rid=0, prompt=np.zeros(9, np.int32)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ServeEngine(tcfg, model)


def test_launcher_serves_on_cpu_when_asked(capsys, monkeypatch):
    """The launcher's flags end to end, on a reduced-width config so that
    the CPU run stays small (the card runs it at full width)."""
    import repro_torch.configs as configs
    small = reduced(get_config("moonshot-v1-16b-a3b"), layers=3)
    monkeypatch.setattr(configs, "get_config", lambda name: small)
    for extra, kind in (([], "paged KV cache (blocks of 16,"),
                        (["--kv-block", "0", "--policy", "fixed"],
                         "contiguous KV cache"),
                        (["--kv-block", "8", "--prefill-chunk", "8",
                          "--paged-attn", "gather"], "blocks of 8")):
        done = launch_main(["--arch", "moonshot-v1-16b-a3b", "--layers", "2",
                            "--requests", "3", "--max-new", "2", "--slots",
                            "2", "--dtype", "fp32", "--device", "cpu",
                            *extra])
        assert len(done) == 3 and all(len(r.out) == 2 for r in done)
        out = capsys.readouterr().out
        assert "3/3 requests completed" in out and kind in out, out


def test_launcher_no_prefix_cache_same_tokens_no_hits(tmp_path, monkeypatch):
    """``--no-prefix-cache``: the shared-prefix trace served with no prompt
    block taken from the cache (the pool's prefix-hit tokens 0, against
    some with the cache on) and the same tokens."""
    monkeypatch.chdir(tmp_path)
    argv = ["--arch", "smollm-360m", "--reduce", "--dtype", "fp32",
            "--device", "cpu", "--max-new", "3", "--loadgen",
            "shared_prefix", "--smoke"]
    on = launch_main(argv)
    off = launch_main(argv + ["--no-prefix-cache"])
    assert on["kv_stats"]["prefix_hit_tokens"] > 0
    assert off["kv_stats"]["prefix_hit_tokens"] == 0
    assert off["completed"] == on["completed"] == 12
    assert off["outputs"] == on["outputs"]


def test_launcher_capacity_flag(capsys):
    argv = ["--arch", "smollm-360m", "--reduce", "--requests", "2",
            "--max-new", "4", "--dtype", "fp32", "--device", "cpu"]
    done = launch_main(argv + ["--capacity", "100"])
    assert len(done) == 2 and "2 slots x 100 tokens" in \
        capsys.readouterr().out
    need = max(len(r.prompt) for r in done) + 4
    launch_main(argv + ["--capacity", str(need)])
    with pytest.raises(SystemExit, match=f"--capacity {need - 1} cannot "
                                         f"hold .*: {need} tokens"):
        launch_main(argv + ["--capacity", str(need - 1)])


def test_launcher_takes_a_reference_command_line(capsys):
    """The reference launcher's spellings (``--kv-block-size``,
    ``--schedule-policy``, ``--prefix-cache``, ``--capacity``) run
    unchanged, its ``--executor xla`` too, on ``blocks``, the port's
    name for it."""
    ref_argv = ["--arch", "moonshot-v1-16b-a3b", "--reduce", "--requests",
                "3", "--max-new", "3", "--quant", "int8_expert", "--slots",
                "2", "--capacity", "128", "--kv-block-size", "16",
                "--schedule-policy", "fixed", "--prefix-cache",
                "--prefill-chunk", "32"]
    done = launch_main(ref_argv + ["--dtype", "fp32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(done) == 3 and "fixed schedule" in out
    assert "blocks of 16" in out and "2 slots x 128 tokens" in out
    assert "cuda executor" in out
    done = launch_main(ref_argv + ["--executor", "xla", "--dtype", "fp32",
                                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(done) == 3 and "fixed schedule, blocks executor" in out
