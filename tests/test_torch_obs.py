"""The port's observability layer (``repro_torch.obs``) against
``repro.obs``: the metrics registry, the span tracer and Chrome-trace
validation, the latency timelines, the straggler wiring, the sink
registry; then the serve path on reduced moonshot-v1-16b-a3b (2 layers: 1
dense + 1 MoE; fp32):

* greedy tokens bitwise the same with observability on and off, and the
  same calls of the kernels' wrappers (on the card each call is one
  launch);
* ``Request.stats`` with one key schema (``lat/*``, ``serve/*``, the plan
  aux with ``sched/*``) for the paged and the contiguous engine, equal to
  the reference engine's keys, with the reference's tokens, ``serve/*``
  and ``sched/*`` values and counters (module fixture: one reference run
  per layout);
* the engine's counters, gauges, histograms and spans; steps at a new
  shape (``serve/recompiles``) and the plans built in them
  (``moe/plans_traced``); the plan hook; the quantized-bytes gauge; drop
  accounting; the train loop's spans; the ``torch.profiler`` bracket; the
  launcher's trace and metrics files."""
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.execution.base import set_plan_hook as jax_set_plan_hook
from repro.models.lm import RunConfig as JaxRunConfig
from repro.models.lm import init_params as jax_init_params
from repro.obs import LAT_KEYS as JAX_LAT_KEYS
from repro.obs import MetricsRegistry as JaxMetricsRegistry
from repro.obs import Observability as JaxObservability
from repro.obs import RequestTimeline as JaxRequestTimeline
from repro.obs import SpanTracer as JaxSpanTracer
from repro.obs import latency_summary as jax_latency_summary
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.execution.base import set_plan_hook
from repro_torch.kernels import ops
from repro_torch.models.lm import RunConfig, n_moe_layers
from repro_torch.obs import (LAT_KEYS, NOOP, MetricsRegistry, NullMetrics,
                             Observability, RequestTimeline, SpanTracer,
                             aggregate, available_sinks, device_trace,
                             drop_summary, get_sink, latency_summary,
                             percentile, validate_chrome_trace)
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

WIDTH = dict(layers=2, d_model=64, vocab=128)
JAX_RC = JaxRunConfig(executor="xla", schedule_policy="dynamic",
                      moe_stats=True, q_chunk=64, kv_chunk=64)
SPANS = ("serve/admit", "serve/step", "serve/assemble", "serve/forward",
         "serve/host_sync", "serve/postprocess", "serve/retire")


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


class StepClock:
    """A clock that moves only at a step's start: ``stepped`` makes the
    bundle advance it by 1 s just after the straggler monitor reads the
    step's start (by ``slow`` s in step ``jump_at``).  Every engine step
    then lasts exactly 1 s (or ``slow``) on the port and on the reference
    alike, whatever the host's load, so the flagged steps are the same on
    both."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def stepped(obs, clock, jump_at=None, slow=10.0):
    """``obs`` (built on ``clock``) with its step bracket moving ``clock``
    as ``StepClock`` says."""
    begin = obs.step_begin

    def step_begin(step):
        begin(step)
        clock.t += slow if step == jump_at else 1.0
    obs.step_begin = step_begin
    return obs


def stepped_memory(factory, jump_at=None):
    clock = StepClock()
    return stepped(factory.memory(clock=clock), clock, jump_at)


class VirtualClock:
    """Deterministic injectable clock: advances ``dt`` per read."""

    def __init__(self, dt=1.0):
        self.t = 0.0
        self.dt = dt

    def __call__(self):
        self.t += self.dt
        return self.t


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------
def test_counters_and_labels_are_separate_series():
    m = MetricsRegistry()
    m.inc("serve/admitted")
    m.inc("serve/admitted", 2.0)
    m.inc("serve/recompiles", kind="decode_step")
    m.inc("serve/recompiles", kind="prefill_step")
    assert m.counter_value("serve/admitted") == 3.0
    assert m.counter_value("serve/recompiles", kind="decode_step") == 1.0
    assert m.counter_value("serve/recompiles", kind="prefill_step") == 1.0
    assert m.counter_value("serve/recompiles") == 0.0   # unlabeled series


def test_gauges_overwrite():
    m = MetricsRegistry()
    m.set_gauge("kv/blocks_in_use", 3)
    m.set_gauge("kv/blocks_in_use", 7)
    assert m.gauge_value("kv/blocks_in_use") == 7.0


def test_histogram_percentiles_nearest_rank():
    m, jm = MetricsRegistry(), JaxMetricsRegistry()
    for v in range(1, 101):
        m.observe("lat", float(v))
        jm.observe("lat", float(v))
    (h,) = m.snapshot()["histograms"]
    assert h["count"] == 100 and h["min"] == 1.0 and h["max"] == 100.0
    assert h["p50"] == 50.0 and h["p99"] == 99.0
    assert percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert percentile([5.0], 99) == 5.0
    assert m.snapshot() == jm.snapshot()


def test_snapshot_json_roundtrip(tmp_path):
    m = MetricsRegistry()
    m.inc("serve/steps", 4)
    m.observe("serve/ttft_s", 0.25)
    p = tmp_path / "metrics.json"
    text = m.to_json(p, extra={"latency": {"ttft_s": {"p50": 0.25}}})
    doc = json.loads(p.read_text())
    assert doc == json.loads(text)
    assert doc["counters"][0]["name"] == "serve/steps"
    assert doc["latency"]["ttft_s"]["p50"] == 0.25


def test_null_metrics_absorbs_everything():
    n = NullMetrics()
    n.inc("x")
    n.observe("y", 1.0)
    n.set_gauge("z", 2.0)
    n.observe_many("w/", {"a": 1.0})
    assert n.snapshot() == {"counters": [], "gauges": [], "histograms": []}
    assert n.counter_value("x") == 0.0


def test_sink_registry():
    assert {"null", "memory"} <= set(available_sinks())
    assert get_sink("null") is NOOP and not NOOP.enabled
    assert get_sink("memory").enabled
    with pytest.raises(ValueError, match="unknown observability sink"):
        get_sink("nope")


# ---------------------------------------------------------------------------
# Span tracer
# ---------------------------------------------------------------------------
def test_tracer_emits_valid_chrome_trace():
    docs = []
    for cls in (SpanTracer, JaxSpanTracer):
        tr = cls(clock=VirtualClock(dt=0.5))
        with tr.span("serve/step", step=0):
            with tr.span("serve/forward", tokens=2):
                pass
            tr.instant("recompile", kind="paged_step")
        docs.append(tr.to_chrome_trace())
    doc = docs[0]
    assert doc == docs[1]                    # the reference's, event for event
    v = validate_chrome_trace(
        doc, required_names=("serve/step", "serve/forward", "recompile"))
    assert v["events"] == 3
    spans = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    # inner span closed before the outer: strictly shorter duration
    assert spans["serve/forward"]["dur"] < spans["serve/step"]["dur"]
    assert spans["serve/forward"]["args"] == {"tokens": 2}


def test_validate_chrome_trace_rejects_garbage():
    with pytest.raises(AssertionError):
        validate_chrome_trace({"no": "envelope"})
    ok = SpanTracer(clock=VirtualClock())
    with ok.span("a"):
        pass
    with pytest.raises(AssertionError, match="missing"):
        validate_chrome_trace(ok.to_chrome_trace(), required_names=("b",))


def test_null_tracer_spans_are_free(tmp_path):
    with NOOP.tracer.span("anything", deep=1):
        NOOP.tracer.instant("x")
    assert NOOP.tracer.save(tmp_path / "never" / "written.json") is None
    assert not (tmp_path / "never").exists()


def test_device_trace_writes_the_profilers_trace(tmp_path):
    """The ``torch.profiler`` bracket (CPU activity here; CPU and CUDA on
    the card) writes a Chrome trace naming the ops it saw."""
    with device_trace(None) as prof:
        assert prof is None
    with device_trace(str(tmp_path)) as prof:
        torch.matmul(torch.ones(8, 8), torch.ones(8, 8))
    doc = json.loads((tmp_path / "device_trace.json").read_text())
    assert any("matmul" in e.get("name", "") for e in doc["traceEvents"])


# ---------------------------------------------------------------------------
# Latency accounting
# ---------------------------------------------------------------------------
def test_request_timeline_virtual_clock():
    tl, jtl = RequestTimeline(submit=0.0, admit=1.0), \
        JaxRequestTimeline(submit=0.0, admit=1.0)
    for t in (3.0, 4.0, 6.0):
        tl.on_token(t)
        jtl.on_token(t)
    s = tl.finalize(end=7.0)
    assert s == jtl.finalize(end=7.0)
    assert set(s) == set(LAT_KEYS) == set(JAX_LAT_KEYS)
    assert s["lat/queue_wait_s"] == 1.0
    assert s["lat/ttft_s"] == 3.0            # first token - submit
    assert s["lat/tpot_s"] == 1.5            # (6 - 3) / 2 inter-token gaps
    assert s["lat/e2e_s"] == 7.0
    assert s["lat/decode_tokens"] == 3.0


def test_single_token_tpot_is_finite_zero():
    tl = RequestTimeline(submit=0.0, admit=0.0)
    tl.on_token(2.0)
    s = tl.finalize(end=2.0)
    assert s["lat/tpot_s"] == 0.0 and np.isfinite(s["lat/tpot_s"])


def test_aggregate_nearest_rank():
    a = aggregate([0.1 * i for i in range(1, 101)])
    assert a["n"] == 100
    assert a["p50"] == pytest.approx(5.0)
    assert a["p99"] == pytest.approx(9.9)
    assert aggregate([]) is None


# ---------------------------------------------------------------------------
# Straggler wiring
# ---------------------------------------------------------------------------
def test_slow_step_flagged_on_virtual_clock():
    clk = VirtualClock(dt=0.0)
    obs = Observability.memory(clock=clk, straggler_window=8,
                               straggler_factor=2.0)
    for step, dur in enumerate([1.0, 1.0, 1.0, 1.0, 10.0]):
        obs.step_begin(step)
        clk.t += dur
        obs.step_end(step, scope="serve")
    assert obs.metrics.counter_value("serve/slow_steps") == 1.0
    (ev,) = [e for e in obs.tracer.events if e["name"] == "slow_step"]
    assert ev["args"]["step"] == 4 and ev["args"]["slowdown"] == 10.0


# ---------------------------------------------------------------------------
# Serve path
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    jcfg = jax_reduced(jax_get_config("moonshot-v1-16b-a3b"), **WIDTH)
    tcfg = reduced(get_config("moonshot-v1-16b-a3b"), **WIDTH)
    params = seeded_params(jcfg)
    model = from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    return jcfg, tcfg, params, model


def _proto(n=4, max_new=4):
    """Prompts of one length (the reference compiles few step shapes)."""
    rng = np.random.default_rng(0)
    return [(i, rng.integers(0, 128, 5).astype(np.int32), max_new)
            for i in range(n)]


def _run(tcfg, model, *, obs=None, kv_block_size=None, rc=None, n=4):
    eng = ServeEngine(tcfg, model, slots=2, capacity=32, rc=rc,
                      kv_block_size=kv_block_size, prefill_chunk=4, obs=obs,
                      device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=m) for i, p, m in _proto(n)]
    try:
        done = eng.run(reqs, max_steps=256)
    finally:
        set_plan_hook(None)         # the engine installs a process hook
    assert len(done) == len(reqs)
    return reqs, eng


@pytest.fixture(scope="module")
def reference_runs(pair):
    """The reference engine on the same requests, paged and contiguous,
    with the memory bundle on a ``StepClock``: {kv_block_size: (requests,
    engine, obs)}."""
    jcfg, _, params, _ = pair
    runs = {}
    try:
        for kvb in (None, 0):
            obs = stepped_memory(JaxObservability)
            eng = JaxServeEngine(jcfg, params, slots=2, capacity=32,
                                 rc=JAX_RC, kv_block_size=kvb,
                                 prefill_chunk=4, obs=obs)
            reqs = [JaxRequest(rid=i, prompt=p, max_new=m)
                    for i, p, m in _proto()]
            eng.run(reqs, max_steps=256)
            runs[kvb] = (reqs, eng, obs)
    finally:
        jax_set_plan_hook(None)
    return runs


def counted_wrappers(monkeypatch):
    """Count the calls of the MoE kernels' ops wrappers (here they run the
    plain versions; on the card each call is one launch)."""
    calls = {}
    for name in ("router_topk", "permute", "unpermute", "fused_gate_up",
                 "grouped_gemm"):
        fn = getattr(ops, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, wrapped)
    return calls


@pytest.mark.parametrize("kv_block", [None, 0], ids=["paged", "contiguous"])
def test_greedy_bitwise_identity_obs_on_off(pair, monkeypatch, kv_block):
    """Attaching the full in-memory bundle changes no generated token, no
    plan stat and no call of a kernel's wrapper: it adds no device work."""
    _, tcfg, _, model = pair
    calls = counted_wrappers(monkeypatch)
    base, _ = _run(tcfg, model, kv_block_size=kv_block)
    calls_off = dict(calls)
    calls.clear()
    inst, eng = _run(tcfg, model, obs=Observability.memory(),
                     kv_block_size=kv_block)
    assert calls == calls_off and calls["router_topk"] > 0
    assert [r.out for r in base] == [r.out for r in inst]
    for a, b in zip(base, inst):
        assert {k: v for k, v in a.stats.items() if not k.startswith("lat/")} \
            == {k: v for k, v in b.stats.items() if not k.startswith("lat/")}
    assert eng.obs.metrics.counter_value("serve/completed") == len(inst)


def test_request_stats_schema_parity_paged_vs_contiguous(pair,
                                                         reference_runs):
    """Both layouts give every request the same stats keys, the reference
    engine's keys; tokens, serve/* and sched/* values are the
    reference's."""
    _, tcfg, _, model = pair
    paged, eng = _run(tcfg, model, kv_block_size=None)
    contig, _ = _run(tcfg, model, kv_block_size=0)
    assert eng.paged and eng.rc.moe_stats
    for kvb, reqs in ((None, paged), (0, contig)):
        jreqs = reference_runs[kvb][0]
        assert [r.out for r in reqs] == [r.out for r in jreqs]
        for r, jr in zip(reqs, jreqs):
            assert set(r.stats) == set(jr.stats), (r.stats, jr.stats)
            for k, v in jr.stats.items():
                if k.startswith(("serve/", "sched/")):
                    assert r.stats[k] == pytest.approx(v, rel=1e-6,
                                                       abs=1e-6), k
    for rp, rc_ in zip(paged, contig):
        assert set(rp.stats) == set(rc_.stats)
        assert set(LAT_KEYS) <= set(rp.stats)
        assert any(k.startswith("sched/") for k in rp.stats)
        assert {"serve/prefix_hit_tokens", "serve/prefill_forwards"} \
            <= set(rp.stats)
        for r in (rp, rc_):
            assert all(np.isfinite(v) for v in r.stats.values()), r.stats
            assert r.stats["lat/decode_tokens"] == len(r.out)
            assert r.stats["lat/ttft_s"] <= r.stats["lat/e2e_s"]


def test_latency_summary_shape(pair, reference_runs):
    _, tcfg, _, model = pair
    reqs, _ = _run(tcfg, model)
    lat = latency_summary(reqs)
    assert set(lat) == set(jax_latency_summary(reference_runs[None][0]))
    assert set(lat) == {"ttft_s", "tpot_s", "queue_wait_s", "e2e_s"}
    for agg in lat.values():
        assert set(agg) == {"n", "mean", "p50", "p99"}
        assert agg["n"] == len(reqs)
    assert drop_summary(reqs) is None


@pytest.mark.parametrize("kv_block", [None, 0], ids=["paged", "contiguous"])
def test_engine_metrics_and_trace_absorbed(pair, reference_runs, kv_block):
    """Both bundles run on a ``StepClock``: on the wall clock a step the
    host happened to slow down was flagged on one side only and the
    counter names differed (``serve/slow_steps``)."""
    _, tcfg, _, model = pair
    obs = stepped_memory(Observability)
    reqs, eng = _run(tcfg, model, obs=obs, kv_block_size=kv_block)
    _, jeng, jobs = reference_runs[kv_block]
    m = obs.metrics
    assert m.counter_value("serve/admitted") == len(reqs)
    assert m.counter_value("serve/completed") == len(reqs)
    assert m.counter_value("serve/steps") > 0
    # the serve/* and kv/* counters and the gauges are the reference's
    names = {c["name"] for c in m.snapshot()["counters"]}
    assert names == {c["name"] for c in jobs.metrics.snapshot()["counters"]}
    for n in names:
        if n.startswith(("serve/", "kv/")):
            assert m.counter_value(n) == jobs.metrics.counter_value(n), n
    assert m.snapshot()["gauges"] == jobs.metrics.snapshot()["gauges"]
    if eng.paged:
        assert m.gauge_value("kv/blocks_total") == eng.kv.n_blocks
        assert m.counter_value("kv/blocks_allocated") > 0
    # latencies and the plan stats absorbed into histograms at retirement
    hists = {h["name"]: h for h in m.snapshot()["histograms"]}
    jhists = {h["name"]: h for h in jobs.metrics.snapshot()["histograms"]}
    assert set(hists) == set(jhists)
    assert hists["serve/ttft_s"]["count"] == len(reqs)
    assert hists["sched/useful_rows"]["sum"] \
        == jhists["sched/useful_rows"]["sum"]
    # the step timeline: a valid Chrome trace with the span skeleton
    v = validate_chrome_trace(obs.tracer.to_chrome_trace(),
                              required_names=SPANS + (
                                  ("serve/prefix_probe",) if eng.paged
                                  else ("serve/prefill",)))
    assert v["events"] > 0
    # the straggler monitor saw every engine step
    assert len(obs.straggler.window) == m.counter_value("serve/steps")


@pytest.mark.parametrize("kv_block", [None, 0], ids=["paged", "contiguous"])
def test_forced_slow_step_flagged_alike(pair, kv_block):
    """Step 4 lasts 10 s on a ``StepClock`` (every other step 1 s): the
    port and the reference both count one ``serve/slow_steps`` and leave
    the same ``slow_step`` instant."""
    jcfg, tcfg, params, model = pair
    obs = stepped_memory(Observability, jump_at=4)
    _run(tcfg, model, obs=obs, kv_block_size=kv_block)
    jobs = stepped_memory(JaxObservability, jump_at=4)
    try:
        JaxServeEngine(jcfg, params, slots=2, capacity=32, rc=JAX_RC,
                       kv_block_size=kv_block, prefill_chunk=4,
                       obs=jobs).run([JaxRequest(rid=i, prompt=p, max_new=m)
                                      for i, p, m in _proto()],
                                     max_steps=256)
    finally:
        jax_set_plan_hook(None)
    for m in (obs.metrics, jobs.metrics):
        assert m.counter_value("serve/slow_steps") == 1
        assert m.counter_value("serve/steps") > 4

    def flags(o):
        return [(e["ts"], e["args"]) for e in o.tracer.events
                if e["name"] == "slow_step"]
    assert flags(obs) == flags(jobs)
    (_, args), = flags(obs)
    assert args == {"scope": "serve", "step": 4, "duration_s": 10.0,
                    "slowdown": 10.0}


def test_recompile_and_plan_trace_events(pair, reference_runs):
    """A step at a new shape counts once under serve/recompiles and the
    plans built inside it under moe/plans_traced (one per MoE layer); both
    leave instants.  On this model (one MoE layer) the counts equal the
    reference's jit traces.  With two MoE layers the port counts two plans
    a shape where the reference's layer scan traces one (ROADMAP.md C)."""
    _, tcfg, _, model = pair
    obs = Observability.memory()
    _, eng = _run(tcfg, model, obs=obs)
    m = obs.metrics
    shapes = {e["args"]["tokens"] for e in obs.tracer.events
              if e["name"] == "serve/forward"}
    assert m.counter_value("serve/recompiles", kind="paged_step") \
        == len(shapes) >= 2
    assert m.counter_value("moe/plans_traced", executor="cuda",
                           policy="dynamic") \
        == len(shapes) * n_moe_layers(tcfg) == len(shapes)
    jm = reference_runs[None][2].metrics
    assert m.counter_value("serve/recompiles", kind="paged_step") \
        == jm.counter_value("serve/recompiles", kind="paged_step")
    assert m.counter_value("moe/plans_traced", executor="cuda",
                           policy="dynamic") \
        == jm.counter_value("moe/plans_traced", executor="xla",
                            policy="dynamic")
    names = {e["name"] for e in obs.tracer.events}
    assert {"recompile", "plan_trace"} <= names
    # a second run on the same engine counts only the shapes it adds
    set_plan_hook(obs.on_plan)
    eng.run([Request(rid=9, prompt=np.arange(5, dtype=np.int32) + 3,
                     max_new=4)])
    set_plan_hook(None)
    shapes = {e["args"]["tokens"] for e in obs.tracer.events
              if e["name"] == "serve/forward"}
    assert m.counter_value("serve/recompiles", kind="paged_step") \
        == m.counter_value("moe/plans_traced", executor="cuda",
                           policy="dynamic") == len(shapes)
    # two MoE layers: two plans per new shape
    cfg3 = tcfg.replace(n_layers=3)
    from repro_torch.models.lm import init_params
    obs3 = Observability.memory()
    _run(cfg3, init_params(cfg3, 0, device="cpu"), obs=obs3, n=2)
    m3 = obs3.metrics
    assert m3.counter_value("moe/plans_traced", executor="cuda",
                            policy="dynamic") \
        == 2 * m3.counter_value("serve/recompiles", kind="paged_step")


def test_plan_hook_restores_previous():
    calls = []
    prev = set_plan_hook(lambda **kw: calls.append(kw))
    try:
        assert prev is None
        restored = set_plan_hook(None)
        assert callable(restored)
    finally:
        set_plan_hook(None)


def test_quantized_expert_bytes_gauge(pair):
    """Set at construction, when the engine quantizes the routed experts;
    the reference's gauge for the same scheme and model."""
    jcfg, tcfg, params, model = pair
    import copy
    obs, jobs = Observability.memory(), JaxObservability.memory()
    try:
        eng = ServeEngine(tcfg, copy.deepcopy(model), slots=2, capacity=32,
                          rc=RunConfig(quant="int8_expert"), obs=obs,
                          device="cpu")
        JaxServeEngine(jcfg, params, slots=2, capacity=32,
                       rc=JAX_RC._replace(quant="int8_expert"), obs=jobs)
    finally:
        set_plan_hook(None)
        jax_set_plan_hook(None)
    got = obs.metrics.gauge_value("serve/quant_expert_bytes",
                                  scheme="int8_expert")
    assert got == eng.quant_expert_bytes > 0
    assert got == jobs.metrics.gauge_value("serve/quant_expert_bytes",
                                           scheme="int8_expert")


def test_dropped_requests_counted(pair):
    _, tcfg, _, model = pair
    obs = Observability.memory()
    eng = ServeEngine(tcfg, model, slots=1, capacity=32, obs=obs,
                      device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=8) for i, p, _ in _proto(2)]
    try:
        eng.run(reqs, max_steps=3)
    finally:
        set_plan_hook(None)
    assert eng.dropped
    assert obs.metrics.counter_value("serve/dropped") == len(eng.dropped)
    assert "serve/step_budget_exhausted" in \
        {e["name"] for e in obs.tracer.events}
    for r in eng.dropped:
        assert r.stats["serve/dropped"] == 1.0
        assert all(np.isfinite(v) for v in r.stats.values())
    ds = drop_summary(reqs)
    assert ds["n"] == len(eng.dropped) and ds["wait_s"]
    # a later run resumes them
    eng.run(reqs, max_steps=64)
    set_plan_hook(None)
    assert all(r.done and "serve/dropped" not in r.stats for r in reqs)


# ---------------------------------------------------------------------------
# Train loop and launcher
# ---------------------------------------------------------------------------
def test_train_loop_emits_spans_and_metrics(tmp_path):
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.loop import train

    cfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=2, d_model=32,
                  vocab=64)
    obs = Observability.memory()
    out = train(cfg, RunConfig(), OptConfig(lr=1e-3), steps=3, batch=2,
                seq=8, log_every=1, log=lambda s: None, device="cpu",
                ckpt_dir=str(tmp_path), save_every=2, obs=obs)
    assert len(out["history"]) == 3
    names = {e["name"] for e in obs.tracer.events}
    assert {"train/data", "train/step", "train/checkpoint"} <= names
    assert obs.metrics.counter_value("train/steps_logged") == 3
    hists = {h["name"]: h for h in obs.metrics.snapshot()["histograms"]}
    assert hists["train/loss"]["count"] == 3
    assert len(obs.straggler.window) == 3


def test_launcher_writes_trace_and_metrics(tmp_path, capsys, monkeypatch):
    """The launcher's observability flags on a reduced-width config: the
    trace and the metrics file, the latency table, the plan stats and,
    under a step budget too small, the drop warning."""
    import repro_torch.configs as configs
    from repro_torch.launch.serve import main as launch_main
    small = reduced(get_config("moonshot-v1-16b-a3b"), **WIDTH)
    monkeypatch.setattr(configs, "get_config", lambda name: small)
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    base = ["--arch", "moonshot-v1-16b-a3b", "--layers", "2", "--requests",
            "3", "--max-new", "2", "--slots", "2", "--dtype", "fp32",
            "--device", "cpu"]
    try:
        done = launch_main(base + ["--admission", "slo", "--slo-ttft", "5",
                                   "--trace", str(trace), "--metrics-out",
                                   str(metrics)])
    finally:
        set_plan_hook(None)
    out = capsys.readouterr().out
    assert len(done) == 3 and "3/3 requests completed" in out
    assert "slo admission" in out and "plan stats" in out
    assert "ttft_s" in out and "paged-cache stats" in out
    validate_chrome_trace(json.loads(trace.read_text()),
                          required_names=SPANS)
    doc = json.loads(metrics.read_text())
    assert doc["latency"]["ttft_s"]["n"] == 3 and "kv_stats" in doc
    done = launch_main(base + ["--max-steps", "2"])
    out = capsys.readouterr().out
    assert len(done) < 3 and "WARNING" in out and "INCOMPLETE" in out
