"""Greedy tokens from the port's ``ServeEngine`` on the dense family must be
identical to ``repro.serve.engine.ServeEngine``'s, on reduced gemma2-9b
(local and global layers, softcaps, GeGLU, post norms, scaled and tied
embeddings) and starcoder2-3b (layernorm, ``gelu_mlp`` with biases, QKV
biases, tied embeddings): between them every dense feature.  Two requests
of 80 prompt tokens (past reduced gemma2's 64-position window) on two
slots, fp32, every bias and norm leaf of the reference's weights drawn
non-zero:

* contiguous (``kv_block_size=0``): the window bites in prefill, and
  decode reads without it, as the reference's (ROADMAP C1);
* paged (blocks of 16, chunks of 40) through the fused read (the kernel's
  plain version on the CPU) and the gather read; its prompt chunks run as
  decode rows, so neither engine applies the window.

Each port engine is held against the reference engine of the same kind,
never paged against contiguous.  ``Request.stats`` carries the reference's
keys, and a dense model's no ``sched/*`` key.  Then the launcher serves
reduced smollm-360m on the CPU, leaves a dense model unquantized under
``--quant`` as the reference's does, and refuses an odd gemma2 depth."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models.lm import RunConfig as JaxRunConfig  # noqa: E402
from repro.models.lm import init_params as jax_init_params  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config, reduced
from repro_torch.launch.serve import main as launch_main
from repro_torch.models.lm import RunConfig
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

PROMPT, MAX_NEW, CAP = 80, 4, 96
ENGINES = {"contiguous": dict(kv_block_size=0),
           "paged": dict(kv_block_size=16, prefill_chunk=40)}
JAX_RC = JaxRunConfig(executor="xla", schedule_policy="dynamic",
                      moe_stats=True, paged_attn="gather", q_chunk=16,
                      kv_chunk=16)


def perturbed(tree, seed):
    """The reference's tree with every bias and norm leaf drawn away from
    its zeros / ones init (so that a missed bias or norm shows)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        return {k: (walk(v) if isinstance(v, (dict, list)) else
                    np.asarray(v) + (rng.standard_normal(np.shape(v))
                                     .astype(np.float32) * 0.2
                                     if k in ("scale", "bias", "bq", "bk",
                                              "bv", "b_up", "b_down")
                                     else 0))
                for k, v in node.items()}
    return walk(tree)


@pytest.fixture(scope="module", params=["gemma2-9b", "starcoder2-3b"])
def served(request):
    """(port config, port model, prompts, {engine kind: reference
    requests})."""
    arch = request.param
    jcfg = jax_reduced(jax_get_config(arch), layers=2, d_model=32, vocab=128)
    tcfg = reduced(get_config(arch), layers=2, d_model=32, vocab=128)
    tree = perturbed(jax.tree.map(np.asarray,
                                  jax_init_params(jcfg, jax.random.key(0))),
                     seed=1)
    params = jax.tree.map(jnp.asarray, tree)
    model = from_jax_params(tcfg, tree, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tcfg.vocab_size, PROMPT).astype(np.int32)
               for _ in range(2)]
    ref = {}
    for kind, kw in ENGINES.items():
        jeng = JaxServeEngine(jcfg, params, slots=2, capacity=CAP,
                              rc=JAX_RC, **kw)
        jreqs = [JaxRequest(rid=i, prompt=p, max_new=MAX_NEW)
                 for i, p in enumerate(prompts)]
        jeng.run(jreqs, max_steps=32)
        assert all(r.done for r in jreqs)
        ref[kind] = jreqs
    return tcfg, model, prompts, ref


@pytest.mark.parametrize("engine", ["contiguous", "paged_fused",
                                    "paged_gather"])
def test_greedy_tokens_and_stats_keys_match_reference_engine(served, engine):
    tcfg, model, prompts, ref = served
    kind, _, read = engine.partition("_")
    rc = RunConfig(schedule_policy="dynamic", moe_stats=True,
                   paged_attn=read or "auto", q_chunk=24, kv_chunk=20)
    teng = ServeEngine(tcfg, model, slots=2, capacity=CAP, rc=rc,
                       device="cpu", **ENGINES[kind])
    treqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
             for i, p in enumerate(prompts)]
    done = teng.run(treqs, max_steps=32)
    assert len(done) == 2 and teng.n_active == 0
    jreqs = ref[kind]
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    for tr, jr in zip(treqs, jreqs):
        assert set(tr.stats) == set(jr.stats)
        assert not any(k.startswith("sched/") for k in tr.stats)
        for key in ("serve/prefix_hit_tokens", "serve/prefill_forwards",
                    "serve/decode_batch"):
            assert tr.stats[key] == jr.stats[key], key


def test_launcher_serves_dense_configs_on_the_cpu(capsys):
    """``--arch smollm-360m --reduce --device cpu`` serves, paged and
    contiguous; ``--quant`` leaves a dense model as it is; gemma2 at an
    odd depth raises, naming the group of two."""
    common = ["--reduce", "--requests", "2", "--max-new", "2", "--dtype",
              "fp32", "--device", "cpu"]
    for extra, kind in (([], "paged KV cache (blocks of 16,"),
                        (["--kv-block", "0", "--quant", "int8_expert"],
                         "contiguous KV cache")):
        done = launch_main(["--arch", "smollm-360m", *common, *extra])
        assert len(done) == 2 and all(len(r.out) == 2 for r in done)
        out = capsys.readouterr().out
        assert "2/2 requests completed" in out and kind in out, out
        assert "reduced width" in out and "routed experts" not in out
        assert not any(k.startswith("sched/") for r in done for k in r.stats)
    with pytest.raises(ValueError, match="groups of two"):
        launch_main(["--arch", "gemma2-9b", *common, "--layers", "3"])
