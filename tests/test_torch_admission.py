"""Admission policies and preemption in the port's ``ServeEngine`` against
``repro.serve.engine.ServeEngine`` on reduced moonshot-v1-16b-a3b (2
layers: 1 dense + 1 MoE; fp32; the reference on its ``xla`` executor).

Under a stepped clock (the test advances it by ``DT`` after each step and
sets ``step_time_hint`` to ``DT``) the two engines must take the same
decisions on the same requests: the same admit, preempt, resume and
retire sequence (read from the two traces), the same ``serve/*`` and
``kv/*`` counters, ``lat/*`` within 1e-9 and ``sched/*`` within 1e-6, and
the same greedy tokens, which must also be those of an uninterrupted run.
Three scenarios, each run once on the reference (module fixture):

* ``slo`` paged: a long prompt whose TTFT deadline is blown mid-prefill is
  preempted for a feasible arrival; its parked table is resumed;
* ``slo`` contiguous: the same request is preempted for its TPOT budget
  and replays prompt + ``out[:-1]`` on resume;
* ``preempt`` paged: an explicit ``preempt(0)`` under pool pressure; the
  park is reclaimed and the resume replays.

The same explicit preemption on the contiguous engine is held against the
uninterrupted run (and its replay path against the reference by ``slo``
contiguous).

The rest mirrors the reference's policy and preemption tests
(tests/test_serve.py, the SLO cases of tests/test_frontend.py driven
through ``engine.schedule``) on the port, and holds ``PagedKVCache``'s
park / resume / reclaim bookkeeping against the reference's call for
call."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")      # the reference side; absent on the card

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.execution.base import set_plan_hook as jax_set_plan_hook
from repro.models.lm import RunConfig as JaxRunConfig
from repro.models.lm import init_params as jax_init_params
from repro.obs import Observability as JaxObservability
from repro.serve.admission import get_admission as jax_get_admission
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.kv_cache import PagedKVCache as JaxPagedKVCache
from repro_torch.configs import get_config, reduced
from repro_torch.execution.base import set_plan_hook
from repro_torch.models.lm import n_moe_layers
from repro_torch.obs import Observability
from repro_torch.serve.admission import (available_admission_policies,
                                         get_admission)
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

DT = 0.05                          # seconds per step on the stepped clock
WIDTH = dict(layers=2, d_model=64, vocab=128)
JAX_RC = JaxRunConfig(executor="xla", schedule_policy="dynamic",
                      moe_stats=True, q_chunk=64, kv_chunk=64)
EVENTS = ("serve/admit", "serve/preempt", "serve/resume", "serve/retire")


def seeded_params(jcfg):
    """The reference's parameter tree, filled from a numpy seed (norm
    scales 1, every matrix N(0, 0.05^2)): ``jax.eval_shape`` gives the
    layout without running the reference's initialiser."""
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: jax_init_params(jcfg, jax.random.key(0)))

    def leaf(path, s):
        if "scale" in jax.tree_util.keystr(path):
            return jax.numpy.ones(s.shape, s.dtype)
        return jax.numpy.asarray(
            (rng.standard_normal(s.shape) * 0.05).astype(s.dtype))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


class SteppedClock:
    """A clock only the test moves."""

    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, port cfg, reference params, port model)."""
    jcfg = jax_reduced(jax_get_config("moonshot-v1-16b-a3b"), **WIDTH)
    tcfg = reduced(get_config("moonshot-v1-16b-a3b"), **WIDTH)
    params = seeded_params(jcfg)
    model = from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    return jcfg, tcfg, params, model


# -- the four stepped-clock scenarios ------------------------------------
def _prompts(seed, n, lo, hi, vocab=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1))
                         ).astype(np.int32) for _ in range(n)]


def scenario(name, kvb):
    """-> (engine kwargs, {step: [(rid, prompt, max_new, slo_ttft,
    slo_tpot)]} arrivals, (step, slot) of an explicit preemption or
    None)."""
    if name == "slo":
        long_p = np.arange(1, 33, dtype=np.int32)     # 8 chunks of 4
        # paged: short prompts; contiguous (one prefill each, whatever the
        # length): the long prompt's length, one shape fewer to compile
        shorts = _prompts(3, 2, *((3, 3) if kvb else (32, 32)))
        return (dict(slots=1, capacity=48, kv_block_size=kvb,
                     prefill_chunk=4, admission="slo"),
                {0: [(0, long_p, 4, 0.2, 0.01)],
                 1: [(1, shorts[0], 3, 0.3, None),
                     (2, shorts[1], 2, None, None)]}, None)
    # prompts long enough that two active slots need the whole pool of 8
    # blocks; one length, so that the reference compiles few step shapes
    prompts = _prompts(9, 3, 12, 12)
    return (dict(slots=2, capacity=16, kv_block_size=kvb, prefill_chunk=16,
                 prefix_cache=False),
            {0: [(i, p, 4, None, None) for i, p in enumerate(prompts)]},
            (1, 0))


def drive(eng, clock, arrivals, preempt_at, max_steps=200):
    """Arrivals are enqueued before their step's scheduling pass; the
    clock advances by DT after every step."""
    pending = []
    last_arrival = max(arrivals)
    for i in range(max_steps):
        if i in arrivals:
            pending += eng.enqueue(arrivals[i])
        if preempt_at is not None and i == preempt_at[0]:
            pending.append(eng.preempt(preempt_at[1]))
        eng.schedule(pending)
        n = eng.step()
        clock.advance(DT)
        if n == 0 and not pending and i >= last_arrival:
            break
    return pending


def run_scenario(name, kvb, make_engine, make_request, make_obs):
    kw, spec, preempt_at = scenario(name, kvb)
    clock = SteppedClock()
    obs = make_obs(clock)
    eng = make_engine(obs=obs, **kw)
    eng.step_time_hint = DT
    arrivals = {i: [make_request(rid=r, prompt=p, max_new=m, slo_ttft=t,
                                 slo_tpot=u) for r, p, m, t, u in reqs]
                for i, reqs in spec.items()}
    left = drive(eng, clock, arrivals, preempt_at)
    reqs = sorted((r for rs in arrivals.values() for r in rs),
                  key=lambda r: r.rid)
    assert not left and all(r.done for r in reqs), name
    return eng, obs, reqs


def counters(obs):
    """Counter values by (name, labels); the plan counter's executor label
    (xla on the reference side, cuda on the port's) is dropped."""
    out = {}
    for c in obs.metrics.snapshot()["counters"]:
        labels = {k: v for k, v in c["labels"].items() if k != "executor"}
        out[c["name"], tuple(sorted(labels.items()))] = c["value"]
    return out


def events(obs):
    return [(e["name"], e["args"]["rid"]) for e in obs.tracer.events
            if e["name"] in EVENTS]


CASES = [("slo", 4), ("slo", 0), ("preempt", 4)]
IDS = ["slo-paged", "slo-contiguous", "preempt-paged"]


@pytest.fixture(scope="module")
def reference_runs(pair):
    jcfg, _, params, _ = pair
    runs = {}
    try:
        for name, kvb in CASES:
            runs[name, kvb] = run_scenario(
                name, kvb,
                lambda **kw: JaxServeEngine(jcfg, params, rc=JAX_RC, **kw),
                JaxRequest, lambda c: JaxObservability.memory(clock=c))
    finally:
        jax_set_plan_hook(None)
    return runs


def port_run(pair, name, kvb, make_obs=lambda c: Observability.memory(
        clock=c)):
    _, tcfg, _, model = pair
    try:
        return run_scenario(
            name, kvb,
            lambda **kw: ServeEngine(tcfg, model, device="cpu", **kw),
            Request, make_obs)
    finally:
        set_plan_hook(None)


_UNINTERRUPTED = {}


def uninterrupted_tokens(pair, name, kvb):
    """The scenario's requests on fcfs, no deadline, no preemption
    (memoized)."""
    if (name, kvb) in _UNINTERRUPTED:
        return _UNINTERRUPTED[name, kvb]
    _, tcfg, _, model = pair
    kw, spec, _ = scenario(name, kvb)
    kw = dict(kw, admission="fcfs")
    reqs = [Request(rid=r, prompt=p, max_new=m)
            for rs in spec.values() for r, p, m, _, _ in rs]
    ServeEngine(tcfg, model, device="cpu", **kw).run(reqs)
    assert all(r.done for r in reqs)
    _UNINTERRUPTED[name, kvb] = {r.rid: r.out for r in reqs}
    return _UNINTERRUPTED[name, kvb]


@pytest.mark.parametrize("name,kvb", CASES, ids=IDS)
def test_stepped_clock_decisions_match_reference(pair, reference_runs, name,
                                                 kvb):
    jeng, jobs, jreqs = reference_runs[name, kvb]
    teng, tobs, treqs = port_run(pair, name, kvb)
    # the same decisions in the same order
    assert events(tobs) == events(jobs)
    assert (teng.n_preempted, teng.n_resumed) \
        == (jeng.n_preempted, jeng.n_resumed)
    assert teng.n_preempted >= 1 and teng.n_resumed == teng.n_preempted
    tc, jc = counters(tobs), counters(jobs)
    assert tc == jc
    for key in ("serve/admitted", "serve/completed", "serve/preempted",
                "serve/resumed"):
        assert tc[key, ()] == jc[key, ()] > 0
    if kvb:
        assert tc["kv/tables_parked", ()] \
            == tc.get(("kv/tables_resumed", ()), 0.0) \
            + tc.get(("kv/park_reclaims", ()), 0.0) >= 1
        assert teng.kv.stats() == jeng.kv.stats()
        assert teng.kv.stats()["parked_tables"] == 0
        if name == "preempt":
            assert tc["kv/park_reclaims", ()] >= 1     # pool pressure
        else:
            assert tc["kv/tables_resumed", ()] >= 1    # the park survived
    # serve/recompiles counts the distinct step shapes the port ran, and
    # moe/plans_traced the plans built in them (one per MoE layer)
    kind = "paged_step" if kvb else "decode_step"
    arg = "tokens" if kvb else "active_slots"
    shapes = {e["args"][arg] for e in tobs.tracer.events
              if e["name"] == "recompile" and e["args"]["kind"] == kind}
    forwards = {e["args"]["tokens"] for e in tobs.tracer.events
                if e["name"] == "serve/forward"}
    if kvb:
        assert shapes == forwards
    n_shapes = sum(v for (n, lab), v in tc.items()
                   if n == "serve/recompiles")
    assert tc["moe/plans_traced", (("policy", "dynamic"),)] \
        == n_shapes * n_moe_layers(teng.cfg)
    # the same latencies, plan stats, tokens
    for tr, jr in zip(treqs, jreqs):
        assert tr.out == jr.out, tr.rid
        assert set(tr.stats) == set(jr.stats)
        for k, v in jr.stats.items():
            tol = 1e-9 if k.startswith("lat/") else 1e-6
            assert tr.stats[k] == pytest.approx(v, rel=tol, abs=tol), k
    assert {r.rid: r.out for r in treqs} \
        == uninterrupted_tokens(pair, name, kvb)
    # the histograms the retirements fed (latencies and sched/*)
    th = {(h["name"], tuple(h["labels"].items())): h
          for h in tobs.metrics.snapshot()["histograms"]}
    jh = {(h["name"], tuple(h["labels"].items())): h
          for h in jobs.metrics.snapshot()["histograms"]}
    assert set(th) == set(jh)
    for key, h in jh.items():
        assert th[key]["count"] == h["count"]
        assert th[key]["sum"] == pytest.approx(h["sum"], rel=1e-6, abs=1e-6)


# -- the policies ---------------------------------------------------------
def test_admission_policies():
    reqs = [Request(rid=0, prompt=np.zeros(5, np.int32)),
            Request(rid=1, prompt=np.zeros(2, np.int32)),
            Request(rid=2, prompt=np.zeros(2, np.int32))]
    jreqs = [JaxRequest(rid=r.rid, prompt=r.prompt) for r in reqs]
    assert get_admission("fcfs")(reqs) == 0
    assert get_admission("sjf")(reqs) == 1        # shortest; fcfs tie-break
    for name in ("fcfs", "sjf", "prefix_hit", "slo"):
        assert get_admission(name)(reqs) == jax_get_admission(name)(jreqs)
    assert available_admission_policies() \
        == ["fcfs", "prefix_hit", "sjf", "slo"]
    assert hasattr(get_admission("slo"), "preempt")
    with pytest.raises(ValueError, match="unknown admission policy"):
        get_admission("nope")


@pytest.mark.parametrize("policy", ["fcfs", "sjf", "prefix_hit", "slo"])
def test_every_policy_serves(pair, policy):
    """``ServeEngine(cfg, model, admission=p)`` serves under each policy:
    requests submitted in reverse, a shared prefix so that prefix_hit has a
    warm request to prefer; every request completes with the tokens of the
    fcfs run."""
    _, tcfg, _, model = pair
    shared = np.arange(1, 9, dtype=np.int32)
    prompts = [np.concatenate([shared, np.arange(20, 20 + i)]).astype(
        np.int32) if i % 2 else np.arange(40, 42 + i, dtype=np.int32)
        for i in range(4)]

    def serve(adm):
        reqs = [Request(rid=i, prompt=p, max_new=3, slo_ttft=1.0)
                for i, p in enumerate(prompts)]
        eng = ServeEngine(tcfg, model, slots=2, capacity=32,
                          kv_block_size=4, prefill_chunk=4, admission=adm,
                          device="cpu")
        done = eng.run(list(reversed(reqs)), max_steps=64)
        assert len(done) == 4 and all(len(r.out) == 3 for r in reqs)
        return {r.rid: r.out for r in reqs}
    assert serve(policy) == serve("fcfs")


def test_sjf_admission_end_to_end(pair):
    _, tcfg, _, model = pair
    reqs = [Request(rid=i, prompt=np.arange(1, 2 + i, dtype=np.int32),
                    max_new=3) for i in range(4)]
    eng = ServeEngine(tcfg, model, slots=2, capacity=16, admission="sjf",
                      device="cpu")
    obs_order = []
    eng.on_token = lambda r, t: obs_order.append(r.rid)
    done = eng.run(list(reversed(reqs)), max_steps=64)
    assert len(done) == 4 and all(r.done for r in reqs)
    # the two shortest prompts took the two slots first
    assert set(obs_order[:2]) == {0, 1}


def test_admission_order_determinism_paged(pair):
    """Prefix sharing must not make outputs depend on who computed the
    shared blocks first: any admission order gives the same tokens."""
    _, tcfg, _, model = pair
    prefix = np.arange(3, 12, dtype=np.int32)
    rng = np.random.default_rng(17)
    proto = [np.concatenate([prefix, rng.integers(0, 128, int(n))]).astype(
        np.int32) for n in rng.integers(2, 6, 4)]

    def run_order(order):
        reqs = {i: Request(rid=i, prompt=p, max_new=4)
                for i, p in enumerate(proto)}
        eng = ServeEngine(tcfg, model, slots=2, capacity=32, kv_block_size=4,
                          prefill_chunk=3, device="cpu")
        eng.run([reqs[i] for i in order])
        assert all(r.done for r in reqs.values())
        assert eng.kv.stats()["prefix_hit_tokens"] > 0
        return {i: r.out for i, r in reqs.items()}

    base = run_order([0, 1, 2, 3])
    assert run_order([3, 1, 0, 2]) == base
    assert run_order([2, 3, 1, 0]) == base


def test_prefix_hit_admission_policy(pair):
    """prefix_hit admits the pending request with the longest cached
    prefix first (FCFS on a cold cache or without an engine)."""
    _, tcfg, _, model = pair
    eng = ServeEngine(tcfg, model, slots=1, capacity=32, kv_block_size=4,
                      device="cpu")
    warm_prefix = np.arange(1, 9, dtype=np.int32)            # 2 full blocks
    seed = Request(rid=0, prompt=np.concatenate(
        [warm_prefix, [9]]).astype(np.int32), max_new=2)
    eng.run([seed])                                          # registers them
    assert eng.kv.probe_prefix(seed.prompt) == 8
    cold = Request(rid=1, prompt=np.asarray([20, 21], np.int32), max_new=2)
    warm = Request(rid=2, prompt=np.concatenate(
        [warm_prefix, [30, 31]]).astype(np.int32), max_new=2)
    policy = get_admission("prefix_hit")
    assert policy([cold, warm], engine=eng) == 1             # warm first
    assert policy([cold, warm]) == 0                         # no engine
    eng2 = ServeEngine(tcfg, model, slots=1, capacity=32, kv_block_size=4,
                       admission="prefix_hit", device="cpu")
    eng2.run([Request(rid=0, prompt=seed.prompt, max_new=2)])
    assert len(eng2.run([cold, warm])) == 2
    assert warm.stats["serve/prefix_hit_tokens"] == 8.0


def _slo_engines(pair, prompt_len):
    """A port and a reference engine on one stepped clock each (1 slot,
    blocks of 4, chunks of 4, slo admission, step_time_hint 0.05)."""
    jcfg, tcfg, params, model = pair
    kw = dict(slots=1, capacity=64, kv_block_size=4, prefill_chunk=4,
              admission="slo")
    teng = ServeEngine(tcfg, model, device="cpu",
                       obs=Observability(clock=SteppedClock()), **kw)
    jeng = JaxServeEngine(jcfg, params, rc=JAX_RC,
                          obs=JaxObservability(clock=SteppedClock()), **kw)
    for e in (teng, jeng):
        e.step_time_hint = 0.05
    return teng, jeng, np.arange(prompt_len, dtype=np.int32)


def test_slo_admission_orders_by_deadline_feasibility(pair):
    """Feasible deadline-holders admit earliest deadline first; blown
    deadlines go behind no-deadline traffic; the reference decides the
    same at every pick."""
    teng, jeng, prompt = _slo_engines(pair, 8)
    spec = [(0, None), (1, 0.5), (2, 0.3), (3, 0.01)]
    t_pending = teng.enqueue([Request(rid=r, prompt=prompt, max_new=2,
                                      slo_ttft=d) for r, d in spec])
    j_pending = jeng.enqueue([JaxRequest(rid=r, prompt=prompt, max_new=2,
                                         slo_ttft=d) for r, d in spec])
    policy, jpolicy = get_admission("slo"), jax_get_admission("slo")
    picks = []
    while t_pending:
        i = policy(t_pending, engine=teng)
        assert i == jpolicy(j_pending, engine=jeng)
        picks.append(t_pending.pop(i).rid)
        j_pending.pop(i)
    # rid 3 is infeasible (2 prefill steps * 0.05 > 0.01)
    assert picks == [2, 1, 0, 3]


def test_slo_admission_prices_tpot_feasibility(pair):
    """A request asking for a faster decode pace than the engine's step
    estimate is infeasible at admit time: it goes behind feasible and
    no-deadline traffic, until a faster engine makes it feasible."""
    teng, jeng, prompt = _slo_engines(pair, 4)
    spec = [(0, None, None), (1, 0.5, 0.01), (2, 0.5, 0.2)]
    t_pending = teng.enqueue([Request(rid=r, prompt=prompt, max_new=2,
                                      slo_ttft=a, slo_tpot=b)
                              for r, a, b in spec])
    j_pending = jeng.enqueue([JaxRequest(rid=r, prompt=prompt, max_new=2,
                                         slo_ttft=a, slo_tpot=b)
                              for r, a, b in spec])
    policy, jpolicy = get_admission("slo"), jax_get_admission("slo")
    picks = []
    while t_pending:
        i = policy(t_pending, engine=teng)
        assert i == jpolicy(j_pending, engine=jeng)
        picks.append(t_pending.pop(i).rid)
        j_pending.pop(i)
    assert picks == [2, 0, 1]
    for e in (teng, jeng):
        e.step_time_hint = 0.005
    fast = [(3, None, None), (4, 0.5, 0.01)]
    t2 = teng.enqueue([Request(rid=r, prompt=prompt, slo_ttft=a, slo_tpot=b)
                       for r, a, b in fast])
    j2 = jeng.enqueue([JaxRequest(rid=r, prompt=prompt, slo_ttft=a,
                                  slo_tpot=b) for r, a, b in fast])
    assert policy(t2, engine=teng) == jpolicy(j2, engine=jeng) == 1


def test_slo_preempts_hopeless_prefill_for_feasible_arrival(pair):
    """The stepped ``slo`` paged run: the long prefill is preempted once
    the feasible request waits, both finish with the uninterrupted run's
    tokens, and the resumed request keeps its first submit time."""
    eng, _, reqs = port_run(pair, "slo", 4)
    assert eng.n_preempted >= 1 and eng.n_resumed == eng.n_preempted
    assert {r.rid: r.out for r in reqs} \
        == uninterrupted_tokens(pair, "slo", 4)
    assert reqs[0].stats["lat/ttft_s"] > reqs[1].stats["lat/ttft_s"]
    assert reqs[0].stats["lat/queue_wait_s"] == 0.0


def test_slo_never_preempts_without_demand(pair):
    """Preemption is throttled by feasible waiting demand: a queue with no
    deadline never evicts an over-budget active request."""
    _, tcfg, _, model = pair
    clock = SteppedClock()
    eng = ServeEngine(tcfg, model, slots=1, capacity=64, kv_block_size=4,
                      prefill_chunk=4, admission="slo", device="cpu",
                      obs=Observability(clock=clock))
    eng.step_time_hint = DT
    reqs = [Request(rid=0, prompt=np.arange(1, 33, dtype=np.int32),
                    max_new=3, slo_ttft=0.01),
            Request(rid=1, prompt=np.asarray([50, 51], np.int32), max_new=3)]
    drive(eng, clock, {0: reqs}, None)
    assert eng.n_preempted == 0 and all(r.done for r in reqs)


# -- explicit preemption --------------------------------------------------
@pytest.mark.parametrize("kvb", [4, 0], ids=["paged", "contiguous"])
def test_preempt_resume_token_identity(pair, reference_runs, kvb):
    """A request preempted mid-decode and resumed gives the tokens of an
    uninterrupted run (paged: and of the reference's preempted run); its
    censored stats are finite and marked, then replaced at retirement."""
    _, tcfg, _, model = pair
    kw, spec, _ = scenario("preempt", kvb)
    reqs = [Request(rid=r, prompt=p, max_new=m)
            for r, p, m, _, _ in spec[0]]
    eng = ServeEngine(tcfg, model, device="cpu", **kw)
    pending = eng.enqueue(reqs)
    eng.schedule(pending)
    eng.step()
    victim = eng.preempt(0)
    assert not victim.done and victim.out
    assert victim.stats.get("serve/preempted") == 1.0
    assert all(np.isfinite(v) for v in victim.stats.values())
    if kvb:
        assert eng.kv.stats()["parked_tables"] == 1
    pending.append(victim)
    for _ in range(200):
        eng.schedule(pending)
        if eng.step() == 0 and not pending:
            break
    assert all(r.done for r in reqs)
    assert eng.n_preempted == eng.n_resumed == 1
    assert "serve/preempted" not in victim.stats
    outs = {r.rid: r.out for r in reqs}
    assert outs == uninterrupted_tokens(pair, "preempt", kvb)
    if kvb:
        assert outs == {r.rid: r.out
                        for r in reference_runs["preempt", kvb][2]}
        assert eng.kv.stats()["parked_tables"] == 0


# 8 fuzzed preemption points (steps_a, slot, steps_b) drawn from a seed,
# on the paged and the contiguous engine in turn
FUZZ = [(int(a), int(s), int(b), 4 if i % 2 == 0 else 0) for i, (a, s, b)
        in enumerate(np.random.default_rng(23).integers(0, (5, 2, 5),
                                                        (8, 3)))]


@pytest.mark.parametrize("steps_a,slot,steps_b,kvb", FUZZ)
def test_fuzzed_preemption_points_token_identity(pair, steps_a, slot,
                                                 steps_b, kvb):
    """Preempt at fuzzed points: after ``steps_a`` steps evict ``slot``,
    run ``steps_b`` more, evict slot 0 again (perhaps a resumed request,
    perhaps mid-prefill); the tokens must be the uninterrupted run's."""
    _, tcfg, _, model = pair
    kw, spec, _ = scenario("preempt", kvb)
    reqs = [Request(rid=r, prompt=p, max_new=m)
            for r, p, m, _, _ in spec[0]]
    eng = ServeEngine(tcfg, model, device="cpu", **kw)
    pending = eng.enqueue(reqs)

    def run_steps(n):
        for _ in range(n):
            eng.schedule(pending)
            if eng.step() == 0 and not pending:
                return
    run_steps(steps_a)
    if eng.n_active > slot:
        pending.append(eng.preempt(slot))
    run_steps(steps_b)
    if eng.n_active > 0:
        pending.append(eng.preempt(0))
    run_steps(300)
    assert all(r.done for r in reqs)
    assert {r.rid: r.out for r in reqs} \
        == uninterrupted_tokens(pair, "preempt", kvb)
    assert eng.n_resumed == eng.n_preempted


def test_park_reclaim_falls_back_to_replay(pair):
    """Under pool pressure the paged cache reclaims the parked table (LRU)
    instead of failing an allocation; the request still resumes, by
    replay, with the same tokens."""
    eng, obs, reqs = port_run(pair, "preempt", 4)
    assert eng.kv.park_reclaims >= 1
    assert obs.metrics.counter_value("kv/park_reclaims") \
        == eng.kv.park_reclaims
    assert "kv/park_reclaim" in {e["name"] for e in obs.tracer.events}
    assert {r.rid: r.out for r in reqs} \
        == uninterrupted_tokens(pair, "preempt", 4)


def test_park_resume_reclaim_bookkeeping_matches_reference():
    """``park_slot``, ``resume_slot``, ``drop_parked``, the reclaim under
    pressure and the relabelling of parked tables, call for call against
    the reference's ``PagedKVCache``."""
    jcfg = jax_reduced(jax_get_config("moonshot-v1-16b-a3b"), layers=2)
    tcfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=2)
    j = JaxPagedKVCache(jcfg, 2, 8, 4, prefix_cache=False)
    t = PagedKVCache(tcfg, 2, 8, 4, prefix_cache=False, device="cpu")

    def both(method, *args):
        a, b = getattr(j, method)(*args), getattr(t, method)(*args)
        assert a == b, method
        np.testing.assert_array_equal(t.tables, j.tables)
        np.testing.assert_array_equal(t.n_alloc, j.n_alloc)
        np.testing.assert_array_equal(t.refcount, j.refcount)
        assert t.free == j.free and t.stats() == j.stats()
        assert list(t._parked) == list(j._parked)
        return b
    both("ensure_allocated", 0, 7)              # both blocks of slot 0
    both("ensure_allocated", 1, 3)
    both("park_slot", 0, "a")
    assert both("resume_slot", 0, "a") is True
    assert both("resume_slot", 0, "a") is False     # nothing parked
    both("park_slot", 0, "a")
    both("park_slot", 1, "b")
    both("drop_parked", "b")
    perm = np.random.default_rng(0).permutation(t.n_blocks)
    both("permute_physical_blocks", perm)
    both("ensure_allocated", 1, 7)              # 2 free blocks
    both("ensure_allocated", 0, 3)              # reclaims "a"
    assert t.stats()["park_reclaims"] == 1
    assert both("resume_slot", 1, "a") is False
