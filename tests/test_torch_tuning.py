"""The port's kernel tuning (``repro_torch.tuning``) against the reference's
(``repro.tuning``) on the CPU: key and bucket strings equal for the same
arguments; the cache's round trip, versioning, corrupt and missing files and
the local-over-packaged overlay; ``plan_schedule`` under ``autotune`` with a
``sub_block`` record integer-equal to the reference's reading the same
record from its own cache; a ``moe_ffn`` call at T hitting the keys that
``tune_moe_layer(tokens=T)`` wrote (the reference's sweep and lookup key
different M, ROADMAP C9; the port keys both on T·k); ``RunConfig.autotune``
reaching every MoE layer of a model; the Hopper work lists at 128 and 256
rows; ``autotune=False`` looking nothing up; and a tile shape outside the
instantiated set raising."""
import json
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

import repro.tuning as rt  # noqa: E402
from repro.core.dispatch import MoEDispatchConfig as JaxDispatchConfig
from repro.execution.base import plan_schedule as jax_plan_schedule
from repro.scheduling.fixed import schedule_capacity
from repro_torch import tuning
from repro_torch.configs import get_config, reduced
from repro_torch.core.dispatch import MoEDispatchConfig, moe_ffn
from repro_torch.execution import plan_schedule
from repro_torch.kernels import expert_tiles as et
from repro_torch.kernels import grouped_gemm as gg
from repro_torch.kernels.fused_gate_up import fused_gate_up
from repro_torch.models.lm import RunConfig, forward, init_params, n_moe_layers
from repro_torch.scheduling import build_schedule, sub_block
from repro_torch.tuning import cache as tcache
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

FIELDS = ("counts", "group_offsets", "src_tok", "pos", "block_expert",
          "block_active", "seg_start")


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Both packages' local caches pointed at fresh files; the port's
    packaged defaults at an empty file, so only what a test writes is
    read."""
    port, ref = tmp_path / "port.json", tmp_path / "ref.json"
    monkeypatch.setenv(tcache.ENV_CACHE, str(port))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(ref))
    monkeypatch.setattr(tcache, "_PACKAGED", tmp_path / "packaged.json")
    tuning.reset_cache()
    rt.reset_cache()
    tuning.reset_stats()
    yield port, ref
    tuning.reset_cache()
    rt.reset_cache()


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m", [-1, 0, 1, 7, 8, 9, 12, 16, 17, 60, 384, 1000,
                               1024, 1025, 24576, 40000])
def test_shape_bucket_equals_reference(m):
    assert tuning.shape_bucket(m) == rt.shape_bucket(m)


@pytest.mark.parametrize("kernel,M,K,N,E,dtype,scheme", [
    ("grouped_gemm", 12, 1408, 2048, 64, "bfloat16", "dense"),
    ("fused_gate_up", 60, 2048, 1408, 64, "bfloat16", "int8"),
    ("fused_gate_up", 24576, 5120, 1536, 160, "bfloat16", "int4"),
    ("grouped_gemm", 4096, 14336, 4096, 8, "float32", "dense"),
    ("sub_block", 12, 128, 0, 64, "float32", "dense"),
    ("sub_block", 384, 128, 0, 160, "bfloat16", "dense"),
])
def test_make_key_equals_reference(kernel, M, K, N, E, dtype, scheme):
    kw = dict(M=M, K=K, N=N, E=E, dtype=dtype, scheme=scheme)
    assert tuning.make_key(kernel, **kw) == rt.make_key(
        kernel, executor="cuda", **kw)
    assert tuning.make_key(kernel, **kw).endswith("|cuda")


# ---------------------------------------------------------------------------
# Cache persistence (as tests/test_tuning.py holds the reference's)
# ---------------------------------------------------------------------------
def test_cache_roundtrip(tmp_path):
    c = tuning.TuneCache(device="NVIDIA H100 80GB HBM3")
    key = tuning.make_key("grouped_gemm", M=100, K=64, N=32, E=4,
                          dtype="bfloat16")
    c.put(key, block_m=128, block_n=256, block_k=64, us=12.5,
          default_us=20.0)
    c.save(tmp_path / "c.json")
    back = tuning.TuneCache.load(tmp_path / "c.json")
    assert back.device == "NVIDIA H100 80GB HBM3"
    assert back.entries == c.entries
    assert back.lookup(key)["block_n"] == 256
    # the file the reference's loader reads is the same document
    assert rt.TuneCache.load(tmp_path / "c.json").entries == c.entries


def test_version_mismatch_invalidates(tmp_path):
    doc = tuning.TuneCache().to_doc()
    doc["version"] = tuning.CACHE_VERSION + 1
    (tmp_path / "c.json").write_text(json.dumps(doc))
    assert tuning.TuneCache.load(tmp_path / "c.json") is None
    with pytest.raises(ValueError, match="stale"):
        tuning.TuneCache.from_doc(doc)


def test_corrupt_or_missing_file_returns_none(tmp_path):
    (tmp_path / "c.json").write_text("{not json")
    assert tuning.TuneCache.load(tmp_path / "c.json") is None
    assert tuning.TuneCache.load(tmp_path / "absent.json") is None


def test_local_file_overlays_packaged(caches, tmp_path):
    port, _ = caches
    key = tuning.make_key("grouped_gemm", M=8, K=16, N=16, E=2,
                          dtype="bfloat16")
    other = tuning.make_key("grouped_gemm", M=8, K=16, N=32, E=2,
                            dtype="bfloat16")
    tuning.TuneCache({key: {"block_m": 256, "block_n": 128},
                      other: {"block_m": 256, "block_n": 64}},
                     device="packaged").save(tmp_path / "packaged.json")
    tuning.TuneCache({key: {"block_m": 128, "block_n": 256}},
                     device="local").save(port)
    tuning.reset_cache()
    c = tuning.get_cache()
    assert c.lookup(key)["block_n"] == 256          # local wins
    assert c.lookup(other)["block_n"] == 64         # packaged kept
    assert c.device == "local"


def test_packaged_cache_is_the_h100s():
    """The shipped defaults load, name the card they were swept on, and
    hold only timed winners at or below the default tile's time."""
    shipped = tuning.TuneCache.load(
        pathlib.Path(tcache.__file__).with_name("default_cache.json"))
    assert shipped is not None and "H100" in shipped.device
    assert shipped.entries and all(
        r["source"] == "swept" and r["us"] <= r["default_us"]
        for r in shipped.entries.values())


# ---------------------------------------------------------------------------
# plan_schedule's sub_block record, against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("floor", [16, 32])
def test_plan_schedule_sub_block_record_equals_reference(caches, floor):
    port, ref = caches
    T, E, k, M = 24, 16, 4, 64
    rng = np.random.default_rng(floor)
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]
                   ).astype(np.int32)
    for cache_cls, path, executor in ((tuning.TuneCache, port, "cuda"),
                                      (rt.TuneCache, ref, "pallas")):
        c = cache_cls(device="test")
        c.put(rt.make_key("sub_block", M=T * k, K=M, N=0, E=E,
                          executor=executor),
              block_m=sub_block(M, floor), block_n=0, block_k=0,
              block_m_min=floor)
        c.save(path)
    tuning.reset_cache()
    rt.reset_cache()
    kw = dict(n_experts=E, top_k=k, block_m=M, schedule_policy="dynamic",
              autotune=True)
    ts = plan_schedule(torch.from_numpy(idx), MoEDispatchConfig(**kw),
                       torch.float32)
    js = jax_plan_schedule(jnp.asarray(idx),
                           JaxDispatchConfig(executor="pallas", **kw))
    assert ts.block_m == js.block_m == sub_block(M, floor) != sub_block(M)
    assert ts.capacity == js.capacity
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    assert tuning.STATS == {"lookups": 1, "hits": 1}
    # without autotune: the configured floor, no lookup
    plain = plan_schedule(torch.from_numpy(idx),
                          MoEDispatchConfig(**{**kw, "autotune": False}))
    assert plain.block_m == sub_block(M) and tuning.STATS["lookups"] == 1


# ---------------------------------------------------------------------------
# C9: the sweep writes the keys a real call reads
# ---------------------------------------------------------------------------
def layer(T, E, d, f, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((T, d), generator=g).to(dtype),
            torch.randn((d, E), generator=g),
            *((torch.randn(s, generator=g) * s[1] ** -0.5).to(dtype)
              for s in ((E, d, f), (E, d, f), (E, f, d))))


@pytest.mark.parametrize("policy,T", [("dynamic", 6), ("fixed", 40)])
def test_moe_ffn_hits_the_keys_its_sweep_wrote(caches, policy, T):
    port, _ = caches
    E, k, d, f, M = 8, 2, 32, 48, 16
    c = tuning.TuneCache(device="cpu")
    res = tuning.tune_moe_layer(
        E=E, top_k=k, d_model=d, d_ffn=f, tokens=T, reps=1, cache=c,
        policy=policy, schedule_block_m=M,
        block_m=M if policy == "dynamic" else None, device="cpu")
    assert {r["key"] for r in res} == set(c.entries)
    assert all(r["winner"]["us"] <= r["default"]["us"] for r in res)
    c.save(port)
    tuning.reset_cache()
    x, router, wg, wu, wd = layer(T, E, d, f)
    cfg = MoEDispatchConfig(n_experts=E, top_k=k, block_m=M,
                            schedule_policy=policy)
    y0, _ = moe_ffn(x, router, wg, wu, wd, cfg)
    assert tuning.STATS["lookups"] == 0           # autotune off: no lookup
    y1, _ = moe_ffn(x, router, wg, wu, wd, cfg._replace(autotune=True))
    assert torch.equal(y0, y1)
    n = 3 if policy == "dynamic" else 2           # + the sub_block floor
    assert tuning.STATS == {"lookups": n, "hits": n}


def test_reference_sweep_and_lookup_keys_differ():
    """ROADMAP C9, the arithmetic: the reference records M = bucket(T·k),
    its kernels look up the schedule's capacity."""
    for (T, k, E, M), (swept, looked_up) in (
            ((256, 2, 8, 128), (512, 2048)),          # mixtral-8x7b
            ((2, 6, 64, 128), (16, 16384))):          # moonshot decode
        cap = schedule_capacity(T, k, E, M)
        assert (rt.shape_bucket(T * k), rt.shape_bucket(cap)) == (
            swept, looked_up)
        assert tuning.make_key("grouped_gemm", M=T * k, K=1, N=1, E=E) \
            != tuning.make_key("grouped_gemm", M=cap, K=1, N=1, E=E)


def test_run_config_autotune_reaches_every_moe_layer(caches):
    port, _ = caches
    cfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=3)
    model = init_params(cfg, 0, param_dtype=torch.bfloat16, device="cpu")
    B, S = 1, 8
    moe, T = cfg.moe, B * S
    c = tuning.TuneCache(device="test")
    key = dict(M=T * moe.top_k, E=moe.n_experts, dtype="bfloat16")
    c.put(tuning.make_key("fused_gate_up", K=cfg.d_model,
                          N=moe.d_ff_expert, **key),
          block_m=128, block_n=128, block_k=64)
    c.put(tuning.make_key("grouped_gemm", K=moe.d_ff_expert, N=cfg.d_model,
                          **key), block_m=128, block_n=256, block_k=64)
    c.save(port)
    tuning.reset_cache()
    tokens = torch.arange(T, dtype=torch.long).reshape(B, S) % cfg.vocab_size
    rc = RunConfig(compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    with torch.no_grad():
        want, _, _ = forward(model, cfg, rc, {"tokens": tokens})
        got, _, _ = forward(model, cfg, rc._replace(autotune=True),
                            {"tokens": tokens})
    assert torch.equal(want, got)
    assert tuning.STATS["hits"] == 2 * n_moe_layers(cfg)


# ---------------------------------------------------------------------------
# Work lists and tile shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tile_rows", [128, 256])
@pytest.mark.parametrize("policy,T", [("fixed", 2), ("dynamic", 64),
                                      ("fixed", 700), ("dynamic", 700)])
def test_work_lists_cover_every_row_once(policy, T, tile_rows):
    E, k, M = 8, 2, 128
    rng = np.random.default_rng(T)
    p = 1.0 / np.arange(1, E + 1) ** 1.5                 # skewed: long runs
    idx = np.stack([rng.choice(E, k, replace=False, p=p / p.sum())
                    for _ in range(T)]).astype(np.int32)
    sched = build_schedule(torch.from_numpy(idx), E, M, policy=policy)
    runs, tiles = et.expert_tiles_plain(
        sched.seg_start, sched.block_expert, sched.block_active,
        block_m=sched.block_m, capacity=sched.capacity, tile_rows=tile_rows)
    assert tiles.shape[0] <= et.max_tiles(sched.capacity, E, tile_rows)
    seen = np.zeros(sched.capacity, np.int64)
    for e, r0, n in tiles.tolist():
        assert 0 < n <= tile_rows
        seen[r0:r0 + n] += 1
        if e >= 0:
            s, t = runs[e].tolist()
            assert s <= r0 and r0 + n <= t
    assert (seen == 1).all()
    if T == 700:               # runs past 128 rows: cut at 128 or 256
        assert any(t - s > 128 for s, t in runs.tolist())


def test_unknown_tile_shape_raises():
    E, K, N, M = 4, 32, 64, 8
    idx = torch.tensor([[0], [1], [1], [3]], dtype=torch.int32)
    sched = build_schedule(idx, E, M, policy="fixed")
    x = torch.randn((sched.capacity, K)).to(torch.bfloat16)
    w = torch.randn((E, K, N)).to(torch.bfloat16)
    args = (sched.block_expert, sched.block_active)
    ok = gg.grouped_gemm(x, w, *args, block_m=M, tile_rows=128, block_n=256)
    assert torch.equal(ok, gg.grouped_gemm(x, w, *args, block_m=M))
    for kern, bad in (
            (lambda t: gg.grouped_gemm(x, w, *args, block_m=M, tile_rows=t[0],
                                       block_n=t[1]), (64, 128)),
            # B2 at 256 rows x 128 columns would need 256 registers a thread
            (lambda t: fused_gate_up(x, w, w, *args, block_m=M,
                                     tile_rows=t[0], block_n=t[1]),
             (256, 128)),
            # fp32 runs one tile: the default alone
            (lambda t: gg.grouped_gemm(x.float(), w.float(), *args,
                                       block_m=M, tile_rows=t[0],
                                       block_n=t[1]), (128, 128))):
        with pytest.raises(ValueError, match="tile shapes"):
            kern(bad)
