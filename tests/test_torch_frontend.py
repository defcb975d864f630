"""The port's open-stream front end (``repro_torch.serve.frontend``) and
load generator (``repro_torch.serve.loadgen``) against
``repro.serve.frontend`` and ``repro.serve.loadgen``, on reduced
smollm-360m (1 layer, fp32):

* streamed tokens equal to ``run``'s (paged and contiguous, greedy and
  ``temperature``); each completion reported once; a duplicate in-flight
  rid refused; ``drain`` under a short budget gives the unfinished
  requests censored ``lat/*`` stats and a later drain finishes them with
  an uninterrupted run's tokens;
* ``synth_trace``: the reference's arrival times and prompts for all four
  patterns at several seeds;
* ``replay`` on a fixed ``step_time`` (``burst`` under ``slo`` admission,
  ``poisson`` under ``fcfs``): the reference's completions, admission
  order, tokens, ``lat/*`` within 1e-9, goodput, attainment, counters and
  record keys; the calibrated mode (``step_time=None``) records its
  measured EWMA."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models.lm import RunConfig as JaxRunConfig  # noqa: E402
from repro.models.lm import init_params as jax_init_params  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
import repro.serve.loadgen as jlg  # noqa: E402
from repro_torch.configs import get_config, reduced
from repro_torch.obs import drop_summary
from repro_torch.sampling import SamplingConfig
from repro_torch.serve import (PATTERNS, Request, ServeEngine,
                               ServingFrontend, VirtualClock,
                               make_virtual_obs, replay, synth_trace)
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

WIDTH = dict(layers=1, d_model=32)
JAX_RC = JaxRunConfig(executor="xla", q_chunk=16, kv_chunk=16)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_reduced(jax_get_config("smollm-360m"), **WIDTH)
    tcfg = reduced(get_config("smollm-360m"), **WIDTH)
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: jax_init_params(jcfg, jax.random.key(0)))

    def leaf(path, s):
        if "scale" in jax.tree_util.keystr(path):
            return np.ones(s.shape, s.dtype)
        return (rng.standard_normal(s.shape) * 0.3).astype(s.dtype)
    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            from_jax_params(tcfg, tree, device="cpu"))


def engine(pair, **kw):
    _, _, tcfg, model = pair
    return ServeEngine(tcfg, model, device="cpu", **kw)


def prompts(n=4, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(3, 9))).astype(np.int32)
            for _ in range(n)]


# ---------------------------------------------------------------------------
# Front end
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kvb,method", [(None, "greedy"), (0, "greedy"),
                                        (None, "temperature")],
                         ids=["paged", "contiguous", "paged-temperature"])
def test_streamed_tokens_equal_run(pair, kvb, method):
    sampling = SamplingConfig(method=method, temperature=0.8, seed=3)
    kw = dict(slots=2, capacity=32, kv_block_size=kvb, prefill_chunk=4,
              sampling=sampling)
    ref = [Request(rid=i, prompt=p, max_new=5)
           for i, p in enumerate(prompts())]
    engine(pair, **kw).run(ref)
    fe = ServingFrontend(engine(pair, **kw))
    streamed = {}
    handles = [fe.submit(p, max_new=5, rid=i,
                         on_token=lambda r, t: streamed.setdefault(
                             r.rid, []).append(t))
               for i, p in enumerate(prompts())]
    done = fe.drain()
    assert sorted(r.rid for r in done) == [0, 1, 2, 3]
    assert streamed == {r.rid: r.out for r in handles} \
        == {r.rid: r.out for r in ref}


def test_each_completion_reported_once(pair):
    fe = ServingFrontend(engine(pair, slots=2, capacity=32))
    handles = [fe.submit(p, max_new=3) for p in prompts()]
    assert fe.outstanding == 4
    assert len({r.rid for r in handles}) == 4        # auto rids distinct
    seen = []
    for _ in range(200):
        seen += [r.rid for r in fe.poll()]
        if not fe.outstanding:
            break
    assert sorted(seen) == sorted(r.rid for r in handles)
    assert len(seen) == len(set(seen))
    assert all(r.done and r.out for r in handles)


def test_duplicate_inflight_rid_refused(pair):
    fe = ServingFrontend(engine(pair, slots=1, capacity=32))
    fe.submit(np.asarray([1, 2, 3], np.int32), max_new=2, rid=7)
    with pytest.raises(ValueError, match="in flight"):
        fe.submit(np.asarray([4, 5], np.int32), max_new=2, rid=7)
    # an automatic rid skips the one in flight
    fe2 = ServingFrontend(engine(pair, slots=1, capacity=32))
    fe2.submit(np.asarray([1, 2], np.int32), rid=0)
    assert fe2.submit(np.asarray([3, 4], np.int32)).rid == 1


def test_drain_censors_then_resumes(pair):
    ps = prompts(3, seed=1)
    ref = [Request(rid=i, prompt=p, max_new=4) for i, p in enumerate(ps)]
    engine(pair, slots=1, capacity=32).run(ref)
    fe = ServingFrontend(engine(pair, slots=1, capacity=32))
    handles = [fe.submit(p, max_new=4, rid=i) for i, p in enumerate(ps)]
    fe.drain(max_steps=2)
    undone = [r for r in handles if not r.done]
    assert undone
    for r in undone:
        assert r.stats.get("serve/dropped") == 1.0
        assert all(np.isfinite(v) for v in r.stats.values())
    ds = drop_summary(handles)
    assert ds and ds["n"] == len(undone) and ds["wait_s"]
    fe.drain(max_steps=300)
    assert all(r.done and "serve/dropped" not in r.stats for r in handles)
    assert {r.rid: r.out for r in handles} == {r.rid: r.out for r in ref}


# ---------------------------------------------------------------------------
# Load generator
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pattern", PATTERNS)
def test_synth_trace_equals_reference(pattern):
    assert PATTERNS == jlg.PATTERNS
    for seed, kw in ((0, {}), (3, dict(burst_size=6, prompt_hi=40)),
                     (7, dict(prefix_len=6, tail_len=20, tail_frac=0.5))):
        a = synth_trace(pattern, seed=seed, n=12, rate=8.0, vocab=100,
                        max_new=5, slo_ttft=0.4, **kw)
        b = jlg.synth_trace(pattern, seed=seed, n=12, rate=8.0, vocab=100,
                            max_new=5, slo_ttft=0.4, **kw)
        assert [(e.t, e.prompt.tolist(), e.max_new, e.slo_ttft, e.slo_tpot)
                for e in a] == [(e.t, e.prompt.tolist(), e.max_new,
                                 e.slo_ttft, e.slo_tpot) for e in b]
        assert all(e.prompt.dtype == np.int32 for e in a)
        assert all(x.t <= y.t for x, y in zip(a, a[1:]))
    with pytest.raises(ValueError, match="unknown trace pattern"):
        synth_trace("nope", seed=0, n=1, rate=1.0, vocab=10)


def admit_order(obs):
    return [e["args"]["rid"] for e in obs.tracer.events
            if e["name"] == "serve/admit"]


REPLAYS = {"burst-slo": dict(pattern="burst", admission="slo", slots=2,
                             burst_size=4),
           "poisson-fcfs": dict(pattern="poisson", admission="fcfs",
                                slots=2, burst_size=4)}


@pytest.mark.parametrize("case", list(REPLAYS))
def test_replay_fixed_step_equals_reference(pair, case):
    jcfg, params, tcfg, model = pair
    c = REPLAYS[case]
    trace_kw = dict(seed=2, n=8, rate=8.0, vocab=tcfg.vocab_size, max_new=4,
                    slo_ttft=0.4, burst_size=c["burst_size"], prompt_hi=24)
    eng_kw = dict(slots=c["slots"], capacity=64, kv_block_size=4,
                  prefill_chunk=4, admission=c["admission"])
    clock, obs = make_virtual_obs(enabled=True)
    eng = ServeEngine(tcfg, model, obs=obs, device="cpu", **eng_kw)
    rec = replay(eng, synth_trace(c["pattern"], **trace_kw), clock=clock,
                 step_time=0.05, seed=2, pattern=c["pattern"])
    jclock, jobs = jlg.make_virtual_obs(enabled=True)
    jeng = JaxServeEngine(jcfg, params, obs=jobs, rc=JAX_RC, **eng_kw)
    jrec = jlg.replay(jeng, jlg.synth_trace(c["pattern"], **trace_kw),
                      clock=jclock, step_time=0.05, seed=2,
                      pattern=c["pattern"])
    assert set(rec) == set(jrec)
    for key in ("pattern", "n_requests", "offered", "steps", "step_time_s",
                "step_time_mode", "completed", "dropped", "slo_good",
                "preempted", "resumed", "outputs", "kv_stats",
                "obs_counters"):
        assert rec[key] == jrec[key], key
    for key in ("makespan_s", "slo_attainment", "goodput_rps",
                "throughput_rps", "ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
                "tpot_p99_s"):
        assert rec[key] == pytest.approx(jrec[key], abs=1e-9), key
    for fam, agg in jrec["latency"].items():
        for stat, v in agg.items():
            assert rec["latency"][fam][stat] == pytest.approx(
                v, abs=1e-9), (fam, stat)
    assert admit_order(obs) == admit_order(jobs) and admit_order(obs)
    assert rec["completed"] == 8 and rec["goodput_rps"] > 0
    for key in ("admission", "kv_block_size", "prefill_chunk", "sampling",
                "seed", "step_calibration"):
        assert rec["config"][key] == jrec["config"][key], key
    assert obs.metrics.gauge_value("slo/goodput_rps") == rec["goodput_rps"]


def test_replay_calibrated_records_measured_step(pair):
    _, _, tcfg, model = pair
    clock, obs = make_virtual_obs()
    eng = ServeEngine(tcfg, model, obs=obs, slots=2, capacity=64,
                      kv_block_size=4, prefill_chunk=4, device="cpu")
    streamed = {}
    trace = synth_trace("poisson", seed=0, n=6, rate=8.0,
                        vocab=tcfg.vocab_size, max_new=3)
    rec = replay(eng, trace, clock=clock, step_time=None, pattern="poisson",
                 on_token=lambda r, t: streamed.setdefault(
                     r.rid, []).append(t))
    cal = rec["config"]["step_calibration"]
    assert rec["step_time_mode"] == cal["mode"] == "calibrated"
    assert cal["measured_step_ewma_s"] > 0 and cal["ewma_alpha"] == 0.3
    assert rec["completed"] == 6 and streamed == rec["outputs"]
    assert "obs_counters" not in rec           # null sinks on the clock


def test_virtual_clock_and_virtual_obs():
    c = VirtualClock(1.0)
    assert c() == 1.0 and c.advance(0.25) == 1.25 and c() == 1.25
    clock, obs = make_virtual_obs(enabled=True)
    clock.advance(2.0)
    assert obs.clock() == 2.0 and obs.enabled
    assert not make_virtual_obs()[1].enabled


def test_launcher_sampling_spec_stream_and_loadgen(tmp_path, capsys,
                                                   monkeypatch):
    """The launcher's new flags on reduced configs on the CPU: sampled and
    streamed serving, speculative serving with a reduced smollm-360m
    draft, and ``--loadgen burst --smoke``, whose record lands under
    results/serve."""
    from repro_torch.launch.serve import main as launch_main
    monkeypatch.chdir(tmp_path)
    common = ["--reduce", "--requests", "2", "--max-new", "3", "--dtype",
              "fp32", "--device", "cpu"]
    done = launch_main(["--arch", "smollm-360m", *common, "--sampling",
                        "top_p", "--top-p", "0.9", "--temperature", "0.8",
                        "--stream"])
    out = capsys.readouterr().out
    assert len(done) == 2 and "top_p sampling" in out
    assert out.count("stream rid=") == 6 and "2/2 requests completed" in out
    done = launch_main(["--arch", "moonshot-v1-16b-a3b", *common,
                        "--spec-draft", "smollm-360m", "--spec-k", "2"])
    out = capsys.readouterr().out
    assert len(done) == 2 and "speculation:" in out
    assert "draft smollm-360m (2 layers) proposes k=2" in out
    rec = launch_main(["--arch", "smollm-360m", "--reduce", "--dtype",
                       "fp32", "--device", "cpu", "--max-new", "3",
                       "--loadgen", "burst", "--smoke"])
    path = tmp_path / "results/serve/loadgen_smollm-360m_smoke.json"
    import json
    doc = json.loads(path.read_text())
    assert doc["records"][0]["offered"] == 12 == rec["offered"]
    assert rec["completed"] == 12 and rec["step_time_mode"] == "fixed"
    assert "loadgen burst: 12/12 completed" in capsys.readouterr().out
