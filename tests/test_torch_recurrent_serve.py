"""The port's ``ServeEngine`` on the recurrent families against
``repro.serve.engine.ServeEngine``, on the CPU in fp32: reduced rwkv6-1.6b
and zamba2-7b reduced with ``layers=7`` (both shared blocks and the
suffix's own), the reference's weights with every fp32 vector and norm
drawn away from its init.

Neither family has a pageable cache, so both engines fall back to the
contiguous engine, where each slot carries its recurrent state (and, for
zamba2, the KV rows of its attention applications).  Greedy tokens equal
the reference engine's:

* one slot serving two requests in turn (the counterpart of
  ``tests/test_serve.py::test_slot_reuse_resets_recurrent_state``): the
  admission zeroes the row, so each request also gets its tokens alone;
* three requests of different ``max_new`` on two slots: a retirement
  compacts the active slots by swapping every leaf's rows;
* the same with slot 0 preempted after two steps (request 1, moved there
  when request 0 retired): its row is dropped and its resume replays
  prompt + ``out[:-1]``.

Then the automatic fallback and an explicit ``kv_block_size`` ("non-
pageable"), ``SpecEngine``'s refusal, and the launcher serving ``--reduce``
for both architectures with its default ``--kv-block``."""
import numpy as np
import pytest
import torch

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
from repro_torch.models.lm import init_cache, swap_cache_slots
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.spec import SpecEngine
from repro_torch.weights import from_jax_params
from test_torch_recurrent import ARCHS, perturbed
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

CAP = 32
MAX_NEW = (3, 6, 4)           # three requests on two slots: compaction


@pytest.fixture(scope="module", params=list(ARCHS))
def served(request):
    """(port config, port model, prompts, {scenario: reference tokens})."""
    arch = request.param
    kw = ARCHS[arch]
    jcfg = jax_reduced(jax_get_config(arch), **kw)
    tcfg = reduced(get_config(arch), **kw)
    tree = perturbed(jax_init_params(jcfg, jax.random.key(0)), 1)
    params = jax.tree.map(jnp.asarray, tree)
    model = from_jax_params(tcfg, tree, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n in (10, 13, 10)]
    ref = {}
    for name, slots, n in (("batch", 2, 3), ("reuse", 1, 2)):
        jeng = JaxServeEngine(jcfg, params, slots=slots, capacity=CAP,
                              rc=JaxRunConfig())
        assert not jeng.paged
        jreqs = [JaxRequest(rid=i, prompt=prompts[i],
                            max_new=MAX_NEW[i] if name == "batch" else 4)
                 for i in range(n)]
        jeng.run(jreqs, max_steps=64)
        assert all(r.done for r in jreqs)
        ref[name] = [r.out for r in jreqs]
    return tcfg, model, prompts, ref


def engine(tcfg, model, slots, **kw):
    eng = ServeEngine(tcfg, model, slots=slots, capacity=CAP, device="cpu",
                      **kw)
    assert not eng.paged and eng.kv_block_size == 0
    return eng


def test_slot_reuse_resets_recurrent_state(served):
    tcfg, model, prompts, ref = served
    reqs = [Request(rid=i, prompt=prompts[i], max_new=4) for i in range(2)]
    engine(tcfg, model, 1).run(reqs, max_steps=64)
    assert [r.out for r in reqs] == ref["reuse"]
    for i in range(2):
        alone = Request(rid=i, prompt=prompts[i], max_new=4)
        engine(tcfg, model, 1).run([alone], max_steps=64)
        assert alone.out == reqs[i].out


def test_compaction_swaps_state_rows_and_matches_reference(served,
                                                           monkeypatch):
    tcfg, model, prompts, ref = served
    swaps = []
    swap = engine_mod.swap_cache_slots

    def counting(cache, i, j):
        swaps.append((i, j))
        return swap(cache, i, j)
    monkeypatch.setattr(engine_mod, "swap_cache_slots", counting)
    reqs = [Request(rid=i, prompt=prompts[i], max_new=MAX_NEW[i])
            for i in range(3)]
    engine(tcfg, model, 2).run(reqs, max_steps=64)
    assert [r.out for r in reqs] == ref["batch"]
    assert (0, 1) in swaps            # request 0 retired first, below 1


def test_preempted_request_replays_to_the_same_tokens(served):
    tcfg, model, prompts, ref = served
    eng = engine(tcfg, model, 2)
    reqs = [Request(rid=i, prompt=prompts[i], max_new=MAX_NEW[i])
            for i in range(3)]
    pending = eng.enqueue(reqs)
    for i in range(64):
        if i == 2:
            victim = eng.preempt(0)
            assert victim.rid == 1 and not victim.done    # 0 retired
            assert len(victim.out) == 3
            pending.append(victim)
        eng.schedule(pending)
        if eng.step() == 0 and not pending:
            break
    assert (eng.n_preempted, eng.n_resumed) == (1, 1)
    assert all(r.done for r in reqs)
    assert [r.out for r in reqs] == ref["batch"]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_swap_cache_slots_moves_every_leaf(arch):
    cfg = reduced(get_config(arch), **ARCHS[arch])
    cache = init_cache(cfg, 3, 4, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for layer in cache:
        for t in layer.values():
            t.copy_(torch.randn(t.shape, generator=gen))
    before = [{k: t.clone() for k, t in layer.items()} for layer in cache]
    swap_cache_slots(cache, 0, 2)
    for old, new in zip(before, cache):
        for k in old:
            assert torch.equal(new[k][0], old[k][2])
            assert torch.equal(new[k][2], old[k][0])
            assert torch.equal(new[k][1], old[k][1])


def test_contiguous_fallback_and_paged_refusal(served):
    tcfg, model, _, _ = served
    engine(tcfg, model, 1)                      # kv_block_size=None: auto
    with pytest.raises(ValueError, match="non-pageable"):
        ServeEngine(tcfg, model, slots=1, capacity=16, kv_block_size=8,
                    device="cpu")


def test_spec_engine_refuses_a_recurrent_model(served):
    tcfg, model, _, _ = served
    with pytest.raises(ValueError, match="needs the paged engine"):
        SpecEngine(tcfg, model, draft_cfg=tcfg, draft_model=model, slots=1,
                   capacity=16, device="cpu")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_launcher_serves_recurrent_archs_on_the_cpu(arch, capsys):
    common = ["--arch", arch, "--reduce", "--requests", "2", "--max-new",
              "3", "--dtype", "fp32", "--device", "cpu"]
    done = launch_main(common)
    assert len(done) == 2 and all(len(r.out) == 3 for r in done)
    out = capsys.readouterr().out
    assert "2/2 requests completed" in out and "contiguous cache (" in out
    assert "recurrent states" in out and "routed experts" not in out
    with pytest.raises(ValueError, match="non-pageable"):
        launch_main(common + ["--kv-block", "16"])
