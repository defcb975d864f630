"""Greedy tokens from the port's ``ServeEngine`` on reduced deepseek-v2-236b
(MLA latent cache; 3 layers, fp32) must be identical to
``repro.serve.engine.ServeEngine``'s, five requests of mixed prompt lengths
on two slots:

* the paged engine (blocks of 4, ``prefill_chunk`` 4, ``dynamic``) with
  prompts that share a prefix (prefix hits > 0) and take several chunks,
  through the port's gather read and its fused read (the plain version of
  the MLA kernel), against the reference's gather read;
* the contiguous engine (``kv_block_size=0``) with the ``fixed`` policy;
* one tiny paged case against the reference's fused Pallas read in
  interpret mode;
* the paged engine with the routed experts under ``int8_expert``.

The JAX side uses ``executor="xla"`` (JAX's own tests hold xla == pallas).
Last, the launcher serves ``--arch deepseek-v2-236b`` on the CPU at reduced
width."""
import numpy as np
import pytest

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

ARCH = "deepseek-v2-236b"
LENGTHS = (5, 17, 3, 11, 8)
MAX_NEW = (6, 4, 7, 5, 3)


@pytest.fixture(scope="module")
def reduced_deepseek():
    jcfg = jax_reduced(jax_get_config(ARCH), layers=3)
    tcfg = reduced(get_config(ARCH), layers=3)
    params = jax_init_params(jcfg, jax.random.key(0))
    return jcfg, tcfg, params, jax.tree.map(np.asarray, params)


def port_model(tcfg, np_params):
    return from_jax_params(tcfg, np_params, device="cpu")


def shared_prefix_prompts(vocab):
    """Requests 0, 2 and 4 share a 9-token prefix (two full 4-token
    blocks); the later ones are admitted after request 0's blocks are
    registered, so they hit the prefix cache."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, 9)
    return [(np.concatenate([shared, rng.integers(0, vocab, n)])
             if i % 2 == 0 else rng.integers(0, vocab, n + 3)
             ).astype(np.int32) for i, n in enumerate((2, 6, 4, 1, 5))]


def jax_paged_run(jcfg, params, prompts, **rc_kw):
    jeng = JaxServeEngine(jcfg, params, slots=2, capacity=32,
                          rc=JaxRunConfig(executor="xla",
                                          schedule_policy="dynamic",
                                          q_chunk=64, kv_chunk=64, **rc_kw),
                          kv_block_size=4, prefill_chunk=4)
    jreqs = [JaxRequest(rid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]
    jeng.run(jreqs, max_steps=128)
    assert all(r.done for r in jreqs)
    return jeng, jreqs


def port_paged_run(tcfg, model, prompts, **rc_kw):
    teng = ServeEngine(tcfg, model, slots=2, capacity=32, kv_block_size=4,
                       prefill_chunk=4,
                       rc=RunConfig(schedule_policy="dynamic", **rc_kw),
                       device="cpu")
    treqs = [Request(rid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]
    done = teng.run(treqs, max_steps=128)
    assert len(done) == len(treqs) and teng.n_active == 0
    return teng, treqs


@pytest.fixture(scope="module")
def reference_paged(reduced_deepseek):
    jcfg, tcfg, params, _ = reduced_deepseek
    prompts = shared_prefix_prompts(tcfg.vocab_size)
    return (prompts, *jax_paged_run(jcfg, params, prompts))


@pytest.mark.parametrize("read", ["gather", "fused"])
def test_paged_greedy_tokens_identical_to_reference_engine(reduced_deepseek,
                                                           reference_paged,
                                                           read):
    _, tcfg, _, np_params = reduced_deepseek
    prompts, jeng, jreqs = reference_paged
    teng, treqs = port_paged_run(tcfg, port_model(tcfg, np_params), prompts,
                                 paged_attn=read)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    for tr, jr in zip(treqs, jreqs):
        for key in ("serve/prefix_hit_tokens", "serve/prefill_forwards",
                    "serve/decode_batch"):
            assert tr.stats[key] == jr.stats[key], key
    st = teng.kv.stats()
    assert st["prefix_hit_tokens"] > 0 and st["blocks_in_use"] == 0
    assert st == {k: jeng.kv.stats()[k] for k in st}
    assert max(tr.stats["serve/prefill_forwards"] for tr in treqs) > 1
    assert set(teng.kv.pools[0]) == {"ckv", "kr"}


def test_contiguous_greedy_tokens_identical_to_reference_engine(
        reduced_deepseek):
    jcfg, tcfg, params, np_params = reduced_deepseek
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
    teng = ServeEngine(tcfg, port_model(tcfg, np_params), slots=2,
                       capacity=48, kv_block_size=0,
                       rc=RunConfig(schedule_policy="fixed"), device="cpu")
    treqs = [Request(rid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]
    done = teng.run(treqs, max_steps=64)
    assert len(done) == len(treqs) and teng.n_active == 0
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert [len(r.out) for r in treqs] == list(MAX_NEW)


def test_paged_tokens_identical_to_reference_fused_interpret(
        reduced_deepseek):
    """The reference's fused Pallas MLA read (interpret mode) on a small
    case: two requests, the second hits the first's prefix."""
    jcfg, tcfg, params, np_params = reduced_deepseek
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
    teng = ServeEngine(tcfg, port_model(tcfg, np_params), slots=1,
                       capacity=16, kv_block_size=4, prefill_chunk=4,
                       device="cpu")
    treqs = [Request(rid=i, prompt=p, max_new=3)
             for i, p in enumerate(prompts)]
    teng.run(treqs, max_steps=32)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert teng.kv.stats()["prefix_hit_tokens"] == 4


def test_int8_expert_greedy_tokens_identical_to_reference_engine(
        reduced_deepseek):
    """The engine quantizes the routed experts at load; the reference's
    xla executor dequantizes each gathered block."""
    from repro.quantization import QuantTensor as JaxQuantTensor
    jcfg, tcfg, params, np_params = reduced_deepseek
    prompts = shared_prefix_prompts(tcfg.vocab_size)
    jeng, jreqs = jax_paged_run(jcfg, params, prompts, quant="int8_expert")
    teng, treqs = port_paged_run(tcfg, port_model(tcfg, np_params), prompts,
                                 quant="int8_expert")
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    leaves = jax.tree.leaves(jeng.params,
                             is_leaf=lambda v: isinstance(v, JaxQuantTensor))
    assert teng.quant_expert_bytes == sum(
        v.nbytes for v in leaves if isinstance(v, JaxQuantTensor))


def test_launcher_serves_deepseek_on_cpu_when_asked(capsys, monkeypatch):
    """``--arch deepseek-v2-236b`` end to end, paged and contiguous, on a
    reduced-width config so that the CPU run stays small (the card runs
    it at full width)."""
    import repro_torch.configs as configs
    small = reduced(get_config(ARCH), layers=3)
    monkeypatch.setattr(configs, "get_config", lambda name: small)
    for extra, kind in (([], "paged KV cache (blocks of 16,"),
                        (["--kv-block", "0", "--policy", "fixed"],
                         "contiguous KV cache")):
        done = launch_main(["--arch", ARCH, "--layers", "2", "--requests",
                            "3", "--max-new", "2", "--slots", "2", "--dtype",
                            "fp32", "--device", "cpu", *extra])
        assert len(done) == 3 and all(len(r.out) == 2 for r in done)
        out = capsys.readouterr().out
        assert "3/3 requests completed" in out and kind in out, out
        assert out.startswith(f"{ARCH}: 2 layers"), out
