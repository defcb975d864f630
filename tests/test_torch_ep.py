"""The port's expert-parallel serving path (``repro_torch.core.distributed``,
``repro_torch.distributed``, ``repro_torch.serve.distributed``, the
launcher's ``--distributed``) against the reference's, on the CPU.

* In process, against ``repro.core.distributed``: ``a2a_send_rows``,
  ``a2a_send_rows_static`` and ``_recv_schedule`` integer-equal over a grid
  of (T, k, E, ep, policy); ``_static_schedule`` integer-equal, with the
  guard's ValueErrors; ``_resolve_capacity_factor``'s order;
  ``_sharded_send_phase``'s send rows and local expert ids bitwise on a
  seeded plan; ``_merge_chunk_aux``.
* Spawned gloo ranks, one group per world size (2 and 4) running every
  case, its body in ``torch_ep_worker`` (no JAX in a rank): layouts
  ``sharded``, ``sharded_static`` and ``replicated`` under ``fixed``,
  ``dynamic`` and ``capacity_factor`` (``sharded`` with ``overlap`` 2
  too), the reference's drop case, and ``int8_expert`` / ``int4_packed``
  experts through ``sharded`` and ``replicated``; held against the
  reference's ``apply_moe_ep`` (run once, in a subprocess with 8 forced
  host devices, as tests/test_distributed.py runs it): outputs within the
  reference's 2e-4, ``sched/*`` counts equal and ratios within 1e-6,
  ``lb_loss`` / ``router_z`` within 1e-6, every rank's output bitwise the
  same; and against the port's single-device ``apply_moe``.
* Under autograd, every layout the reference differentiates (``sharded``
  with ``overlap`` 0 and 2, ``replicated``, ``sharded_static``, the ragged
  (3, 5) x that falls back to ``replicated``, the drop case under
  ``replicated``) x policy, on ``cuda`` (the plain versions here) and on
  ``blocks`` under ``capacity_factor``: the gradients of
  ``sum(y * dy)``, ``lb_loss`` and ``router_z`` apart, with respect to
  x, the router, the shared experts and each rank's own experts, within
  1e-4 of the reference's ``jax.vjp`` on ``xla``; dx bitwise the same on
  every rank.  Quantized experts under autograd raise in every layout.
* Serving: ``partition_requests`` and ``DistributedServeLoop`` against the
  reference's; a 2-rank EP engine on reduced moonshot in fp32 on
  ``capacity_factor`` 0.5 with ``moe_stats``: greedy tokens, each
  request's ``sched/dropped_rows`` and ``serve/ep_dropped_tokens`` equal
  to the reference's EP engine under ``make_ep_mesh(2)``; the launcher
  with ``--distributed --ep-devices 2 --hosts 2 --device cpu`` and
  ``python -m repro_torch.launch.mp_serve_smoke`` complete 3/3 requests.
"""
import json
import os
import pathlib
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core.moe_layer import dispatch_config as jax_dispatch_config  # noqa: E402
from repro.models.lm import init_params as jax_init_params  # noqa: E402
from repro.serve import distributed as jserve_dist  # noqa: E402
from repro_torch.configs import get_config, reduced
from repro_torch.core import distributed as tdist
from repro_torch.core.moe_layer import apply_moe, dispatch_config
from repro_torch.distributed import EPGroup, current_ep_group, spawn_ranks
from repro_torch.models.lm import RunConfig, init_params
from repro_torch.quantization import quantize_moe_params
from repro_torch.serve.distributed import (DistributedServeLoop,
                                           partition_requests)
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.weights import shard_experts

import torch_ep_worker as W
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
WORLDS = (2, 4)
OUT_TOL = dict(rtol=2e-4, atol=2e-4)         # tests/test_distributed.py:41
COUNT_KEYS = ("sched/useful_rows", "sched/dropped_rows", "sched/padded_rows",
              "sched/n_blocks_active")
ENGINE_ARCH = "moonshot-v1-16b-a3b"
ENGINE_CF = 0.5
# (prompt tokens, max_new) of the engine's requests: request 0 retires in
# the step that carries request 1's second prompt chunk (29 rows), whose
# capacity_factor buckets drop
ENGINE_REQUESTS = ((5, 2), (60, 3), (7, 3))
ENGINE_CAPACITY = 64


def _cases() -> dict:
    cases = {}
    for pol in ("fixed", "dynamic", "capacity_factor"):
        for lay in ("sharded", "sharded_static", "replicated"):
            cases[f"main-{pol}-{lay}"] = dict(shape="main", policy=pol,
                                              layout=lay)
        cases[f"main-{pol}-overlap2"] = dict(shape="main", policy=pol,
                                             layout="sharded", overlap=2)
    # the reference's drop case: capacity 0.25 drops, 8.0 keeps everything
    for lay in ("sharded", "replicated"):
        for cf in (0.25, 8.0):
            cases[f"drop-cf{cf}-{lay}"] = dict(
                shape="drop", policy="capacity_factor", layout=lay,
                capacity_factor=cf)
    for scheme in ("int8_expert", "int4_packed"):
        for lay in ("sharded", "replicated"):
            cases[f"{scheme}-{lay}"] = dict(shape="main", policy="fixed",
                                            layout=lay, scheme=scheme,
                                            capacity_factor=8.0)
    # under autograd: every layout the reference differentiates, each
    # policy on cuda, capacity_factor on blocks too (held against the same
    # reference run), and the drop case under replicated
    for pol in ("fixed", "dynamic", "capacity_factor"):
        for lay, kw in GRAD_LAYOUTS.items():
            cases[f"grad-{pol}-{lay}"] = dict(shape="main", policy=pol,
                                              grad=True, **kw)
            if pol == "capacity_factor":
                cases[f"grad-blocks-{pol}-{lay}"] = dict(
                    shape="main", policy=pol, grad=True, executor="blocks",
                    ref=f"grad-{pol}-{lay}", **kw)
    cases["grad-drop-cf0.25-replicated"] = dict(
        shape="drop", policy="capacity_factor", layout="replicated",
        capacity_factor=0.25, grad=True)
    # a forward case with a gradient twin is held against the twin's
    # reference run, which returns y and aux too: one compile, not two
    for name, case in cases.items():
        twin = "grad-" + name.removeprefix("main-")
        if twin in cases:
            case["ref"] = twin
    return cases


# the gradient cases' layouts; "ragged" is the (3, 5) x on "main"'s
# weights, which neither B nor S splits over ep 2 or 4: replicated
GRAD_LAYOUTS = {"sharded": dict(layout="sharded"),
                "overlap2": dict(layout="sharded", overlap=2),
                "replicated": dict(layout="replicated"),
                "sharded_static": dict(layout="sharded_static"),
                "ragged": dict(layout="sharded", x="ragged")}
CASES = _cases()
X_SHAPES = {"main": (4, 32, 16), "drop": (1, 64, 8)}   # (B, S, d)
RAGGED = (3, 5, 16)
TERMS = ("out", "lb_loss", "router_z")
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def make_inputs() -> dict:
    """Seeded numpy weights (the reference's init scales) and x of both
    MoE shapes, flat ``"<shape>.<leaf>"`` keys; then the ragged x
    (``"ragged.x"``) and each x's output cotangent (``"<name>.dy"``)."""
    rng = np.random.default_rng(0)
    out = {}

    def normal(*shp, scale):
        return (rng.standard_normal(shp) * scale).astype(np.float32)
    for shape, (B, S, d) in X_SHAPES.items():
        m = W.moe_config(shape)
        E, f = m.n_experts, m.d_ff_expert
        out[f"{shape}.router"] = normal(d, E, scale=d ** -0.5)
        out[f"{shape}.w_gate"] = normal(E, d, f, scale=d ** -0.5)
        out[f"{shape}.w_up"] = normal(E, d, f, scale=d ** -0.5)
        out[f"{shape}.w_down"] = normal(E, f, d, scale=f ** -0.5)
        if m.n_shared_experts:
            fs = m.n_shared_experts * f
            out[f"{shape}.shared.w_gate"] = normal(d, fs, scale=d ** -0.5)
            out[f"{shape}.shared.w_up"] = normal(d, fs, scale=d ** -0.5)
            out[f"{shape}.shared.w_down"] = normal(fs, d, scale=fs ** -0.5)
        out[f"{shape}.x"] = normal(B, S, d, scale=1.0)
    out["ragged.x"] = normal(*RAGGED, scale=1.0)
    for name, shp in {**X_SHAPES, "ragged": RAGGED}.items():
        out[f"{name}.dy"] = normal(*shp, scale=1.0)
    return out


def engine_requests():
    """[(prompt, max_new)] of the EP engine case, seeded."""
    rng = np.random.default_rng(0)
    V = reduced(get_config(ENGINE_ARCH)).vocab_size
    return [(rng.integers(0, V, n).astype(np.int32).tolist(), m)
            for n, m in ENGINE_REQUESTS]


# The reference's side, in one subprocess with 8 forced host devices: every
# case at both world sizes, and the EP engine under make_ep_mesh(2).
REFERENCE = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.compat import set_mesh
from repro.configs import get_config, reduced
from repro.configs.base import MoEConfig
from repro.core.distributed import apply_moe_ep
from repro.core.moe_layer import dispatch_config
from repro.launch.mesh import make_debug_mesh, make_ep_mesh
from repro.models import RunConfig, init_params
from repro.obs import Observability
from repro.quantization import quantize_moe_params
from repro.serve.distributed import DistributedServeLoop
from repro.serve.engine import Request, ServeEngine

spec = json.load(open(sys.argv[1]))
inputs = dict(np.load(spec["inputs"]))
ys, auxes, grads = {}, {}, {}

def params_of(shape):
    p = {k[len(shape) + 1:]: jnp.asarray(v) for k, v in inputs.items()
         if k.startswith(shape + ".") and not k.endswith((".x", ".dy"))}
    out = {k: v for k, v in p.items() if not k.startswith("shared.")}
    sh = {k[7:]: v for k, v in p.items() if k.startswith("shared.")}
    if sh:
        out["shared"] = sh
    return out

for ep in spec["worlds"]:
    mesh = make_debug_mesh(data=1, model=ep)
    for name, case in spec["cases"].items():
        if "ref" in case:                  # another case's reference run
            continue
        moe = MoEConfig(**spec["shapes"][case["shape"]])
        dcfg = dispatch_config(moe, executor="xla",
                               schedule_policy=case["policy"],
                               emit_stats=True)
        params = params_of(case["shape"])
        if case.get("scheme"):
            params = quantize_moe_params(params, case["scheme"])
        kw = dict(token_layout=case["layout"],
                  overlap=case.get("overlap", 0))
        if case.get("capacity_factor") is not None:
            kw["capacity_factor"] = case["capacity_factor"]
        xname = case.get("x", case["shape"])
        x = jnp.asarray(inputs[xname + ".x"])
        if case.get("grad"):
            # the vjp of each term of sum(y * dy) + lb_loss + router_z
            dy = jnp.asarray(inputs[xname + ".dy"])

            def terms(p, x):
                y, aux = apply_moe_ep(p, x, dcfg, **kw)
                return ((jnp.sum(y * dy), aux["lb_loss"], aux["router_z"]),
                        (y, aux))

            def run(p, x):
                out, vjp, (y, aux) = jax.vjp(terms, p, x, has_aux=True)
                return y, aux, jax.vmap(lambda c: vjp((c[0], c[1], c[2])))(
                    jnp.eye(3, dtype=jnp.float32))
            with set_mesh(mesh):
                y, aux, (gp3, gx3) = jax.jit(run)(params, x)
            for t, term in enumerate(("out", "lb_loss", "router_z")):
                gp, gx = jax.tree.map(lambda a: a[t], (gp3, gx3))
                flat = {"x": gx, **{k: v for k, v in gp.items()
                                    if k != "shared"},
                        **{"shared." + k: v
                           for k, v in gp.get("shared", {}).items()}}
                for leaf, g in flat.items():
                    grads[f"{ep}/{name}/{term}/{leaf}"] = np.asarray(g)
        else:
            with set_mesh(mesh):
                y, aux = jax.jit(lambda p, x: apply_moe_ep(p, x, dcfg,
                                                           **kw))(params, x)
        ys[f"{ep}/{name}"] = np.asarray(y)
        auxes[f"{ep}/{name}"] = {k: float(v) for k, v in aux.items()}

cfg = reduced(get_config(spec["arch"]))
params = init_params(cfg, jax.random.key(0))
rc = RunConfig(q_chunk=64, kv_chunk=64, ep=True, moe_stats=True,
               schedule_policy="capacity_factor",
               capacity_factor=spec["capacity_factor"])
obs = Observability.memory()
with set_mesh(make_ep_mesh(2)):
    eng = ServeEngine(cfg, params, slots=2, capacity=spec["capacity"],
                      rc=rc, obs=obs)
    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new=m)
            for i, (p, m) in enumerate(spec["requests"])]
    done = DistributedServeLoop(eng, n_hosts=2).run(reqs, max_steps=64)
counters = {c["name"]: c["value"] for c in obs.metrics.snapshot()["counters"]}
engine = {"done": len(done), "out": [list(map(int, r.out)) for r in reqs],
          "dropped_rows": [float(r.stats["sched/dropped_rows"])
                           for r in reqs],
          "ep_dropped_tokens": counters.get("serve/ep_dropped_tokens")}
np.savez(spec["out"] + ".npz", **ys)
np.savez(spec["out"] + "_grads.npz", **grads)
json.dump({"aux": auxes, "engine": engine}, open(spec["out"] + ".json", "w"))
print("OK")
"""


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": (ys, aux, engine), ep: rank results} for every case: the
    reference subprocess runs while the gloo ranks do."""
    tmp = tmp_path_factory.mktemp("ep")
    inputs = make_inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    requests = engine_requests()
    spec = {"inputs": str(tmp / "inputs.npz"), "out": str(tmp / "ref"),
            "worlds": list(WORLDS), "cases": CASES,
            "shapes": W.MOE_SHAPES, "arch": ENGINE_ARCH,
            "capacity_factor": ENGINE_CF, "requests": requests,
            "capacity": ENGINE_CAPACITY}
    (tmp / "spec.json").write_text(json.dumps(spec))
    # unoptimized XLA code: 36 small programs compile about 1.3x faster
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8 "
                        "--xla_backend_optimization_level=0 "
                        "--xla_llvm_disable_expensive_passes=true",
           "PYTHONPATH": SRC, "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", str(tmp)), "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE,
                            str(tmp / "spec.json")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        tree = _numpy_tree(jax_init_params(
            jax_reduced(jax_get_config(ENGINE_ARCH)), jax.random.key(0)))
        engine = {"arch": ENGINE_ARCH, "tree": tree, "requests": requests,
                  "capacity_factor": ENGINE_CF, "capacity": ENGINE_CAPACITY}
        out = {ep: spawn_ranks(W.rank_main, ep, "cpu", inputs, CASES,
                               engine if ep == 2 else None, timeout=600)
               for ep in WORLDS}
        log, _ = ref.communicate(timeout=900)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, log
    meta = json.loads((tmp / "ref.json").read_text())
    grads = {}
    for key, g in np.load(tmp / "ref_grads.npz").items():
        case, term, leaf = key.rsplit("/", 2)
        grads.setdefault(case, {}).setdefault(term, {})[leaf] = g
    out["ref"] = (dict(np.load(tmp / "ref.npz")), meta["aux"], meta["engine"],
                  grads)
    out["inputs"] = inputs
    return out


def _check_aux(aux, ref, tag):
    assert set(aux) == set(ref), (tag, sorted(aux), sorted(ref))
    for k, v in ref.items():
        if k in COUNT_KEYS:
            assert aux[k] == v, (tag, k, aux[k], v)
        else:
            assert abs(aux[k] - v) <= 1e-6, (tag, k, aux[k], v)


@pytest.mark.parametrize("ep", WORLDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_apply_moe_ep_matches_reference(runs, name, ep):
    ys, auxes, _, _ = runs["ref"]
    res = runs[ep]
    y, aux = res[0]["moe"][name][:2]
    for r, other in enumerate(res[1:], 1):     # the same global y everywhere
        np.testing.assert_array_equal(other["moe"][name][0], y,
                                      err_msg=f"rank {r}")
        assert other["moe"][name][1] == aux, r
    key = f"{ep}/{CASES[name].get('ref', name)}"
    np.testing.assert_allclose(y, ys[key], **OUT_TOL, err_msg=name)
    _check_aux(aux, auxes[key], name)
    if name == "drop-cf0.25-sharded":
        assert aux["sched/dropped_rows"] > 0, "cf=0.25 must drop"


@pytest.mark.parametrize("ep", WORLDS)
@pytest.mark.parametrize("name", sorted(
    n for n, c in CASES.items()
    if c["layout"] != "sharded_static" and c["shape"] == "main"
    and not c.get("scheme") and not c.get("grad")))
def test_apply_moe_ep_matches_single_device(runs, name, ep):
    """Every policy's EP output and drop set equal the port's single-device
    ``apply_moe`` (``sharded_static`` ignores the policy: not held)."""
    case = CASES[name]
    y, aux = runs[ep][0]["moe"][name]
    _, dcfg, _ = W.case_config(case)
    params = W.torch_params(runs["inputs"], case["shape"])
    x = torch.from_numpy(runs["inputs"][case["shape"] + ".x"])
    y1, aux1 = apply_moe(params, x, dcfg)
    np.testing.assert_allclose(y, y1.numpy(), **OUT_TOL, err_msg=name)
    for k in ("sched/useful_rows", "sched/dropped_rows"):
        assert aux[k] == float(aux1[k]), (name, k)
    if case["policy"] == "capacity_factor":
        assert aux["sched/dropped_rows"] > 0, "cf=0.5 must drop"


@pytest.mark.parametrize("ep", WORLDS)
@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items()
                                        if c.get("grad")))
def test_apply_moe_ep_grads_match_reference(runs, name, ep):
    """Each term of ``sum(y * dy) + lb_loss + router_z`` apart (a wrong
    count of the router losses' gradient hides in the sum): the gradient
    of x, the router and the shared experts on every rank, and of each
    rank's own experts, against the reference's; dx bitwise the same on
    every rank."""
    case = CASES[name]
    want = runs["ref"][3][f"{ep}/{case.get('ref', name)}"]
    E = W.moe_config(case["shape"]).n_experts
    n = E // ep
    dx0 = {t: runs[ep][0]["moe"][name][2][t]["x"] for t in TERMS}
    for r, res in enumerate(runs[ep]):
        grads = res["moe"][name][2]
        for term in TERMS:
            np.testing.assert_array_equal(grads[term]["x"], dx0[term],
                                          err_msg=f"rank {r} {term}")
            for leaf, ref in want[term].items():
                if leaf in ("w_gate", "w_up", "w_down"):   # routed stacks
                    ref = ref[r * n:(r + 1) * n]
                got = grads[term].get(leaf, np.zeros_like(ref))
                np.testing.assert_allclose(
                    got, ref, **GRAD_TOL, err_msg=f"rank {r} {term} {leaf}")
    # every term reaches x and the router by more than the tolerance, so a
    # gradient counted twice (or not at all) shows
    for term in TERMS:
        for leaf in ("x", "router"):
            assert np.abs(want[term][leaf]).max() > 3 * GRAD_TOL["atol"], \
                (term, leaf)


def test_ep_engine_matches_reference_engine(runs):
    """2 gloo ranks, reduced moonshot in fp32, capacity_factor 0.5: greedy
    tokens, each request's sched/dropped_rows and the
    serve/ep_dropped_tokens counter equal the reference's EP engine."""
    ref = runs["ref"][2]
    got = [r["engine"] for r in runs[2]]
    assert got[0] == got[1]                      # both ranks agree
    got = got[0]
    assert got["done"] == ref["done"] == 3
    assert got["out"] == ref["out"]
    assert got["dropped_rows"] == ref["dropped_rows"]
    assert got["ep_dropped_tokens"] == ref["ep_dropped_tokens"]
    assert ref["ep_dropped_tokens"] > 0


# ----------------------------------------------------------------------
# In process, against repro.core.distributed
# ----------------------------------------------------------------------
GRID = [(T, k, E, ep, pol)
        for T, k, E, ep in ((1, 2, 8, 2), (2, 6, 64, 2), (3, 2, 8, 4),
                            (16, 6, 64, 4), (64, 6, 160, 2), (100, 1, 4, 4))
        for pol in ("fixed", "dynamic", "capacity_factor")]


@pytest.mark.parametrize("T,k,E,ep,pol", GRID)
def test_send_rows_equal(T, k, E, ep, pol):
    for M, cf in ((8, 0.5), (128, 1.25), (16, 2.0)):
        assert tdist.a2a_send_rows(T, k, E, ep, M, cf, pol) \
            == jdist.a2a_send_rows(T, k, E, ep, M, cf, pol)
        assert tdist.a2a_send_rows_static(T, k, E, M, cf) \
            == jdist.a2a_send_rows_static(T, k, E, M, cf)


@pytest.mark.parametrize("T,k,E,ep,pol", [g for g in GRID if g[0] in (3, 64)])
def test_recv_schedule_equal(T, k, E, ep, pol):
    """The receive side's schedule (E_local experts and the sentinel) on
    random received expert ids, every field integer-equal; the port's
    ``seg_start`` keeps the real experts only."""
    rng = np.random.default_rng(T * 1000 + E)
    E_local = E // ep
    C = tdist.a2a_send_rows(T, k, E, ep, 8, 0.5, pol)
    e_recv = rng.integers(0, E_local + 1, ep * C).astype(np.int32)
    moe = dict(n_experts=E, top_k=k, d_ff_expert=16, block_m=8)
    cap = 8 if pol == "capacity_factor" else None
    jcfg = jax_dispatch_config(JaxMoEConfig(**moe), executor="xla",
                               schedule_policy=pol)
    tcfg = dispatch_config(W.MoEConfig(**moe), schedule_policy=pol)
    js = jdist._recv_schedule(jnp.asarray(e_recv), jcfg, E_local, cap)
    ts = tdist._recv_schedule(torch.from_numpy(e_recv), tcfg, E_local, cap)
    for f in ("counts", "group_offsets", "src_tok", "pos", "block_expert",
              "block_active"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    assert (ts.capacity, ts.block_m) == (int(js.capacity), int(js.block_m))
    assert ts.seg_start.shape == (E_local,)


def test_static_schedule_equal():
    ts, js = tdist._static_schedule(32, 4, 8, 8), jdist._static_schedule(
        32, 4, 8, 8)
    for f in ("counts", "group_offsets", "src_tok", "pos", "block_expert",
              "block_active"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    assert ts.capacity == int(js.capacity) == 32


@pytest.mark.parametrize("args", [(36, 4, 8, 9), (34, 2, 8, 16)])
def test_static_schedule_alignment_guard(args):
    for fn in (tdist._static_schedule, jdist._static_schedule):
        with pytest.raises(ValueError, match="block_m-aligned"):
            fn(*args)


def test_capacity_factor_resolution_order():
    moe = dict(n_experts=8, top_k=2, d_ff_expert=32, block_m=8,
               capacity_factor=1.5)
    for mk, dc, resolve in (
            (W.MoEConfig, dispatch_config, tdist._resolve_capacity_factor),
            (JaxMoEConfig, lambda m, **kw: jax_dispatch_config(
                m, executor="xla", **kw), jdist._resolve_capacity_factor)):
        cfg = dc(mk(**moe))
        assert cfg.capacity_factor == 1.5
        assert resolve(cfg, None) == 1.5
        assert resolve(cfg, 0.25) == 0.25
        assert resolve(dc(mk(**moe), capacity_factor=3.0), None) == 3.0


class _Plan(NamedTuple):
    indices: object


@pytest.mark.parametrize("ep", WORLDS)
@pytest.mark.parametrize("pol", ("dynamic", "capacity_factor"))
def test_sharded_send_phase_bitwise(pol, ep):
    rng = np.random.default_rng(ep)
    Tl, k, E, d = 24, 2, 8, 16
    idx = np.stack([rng.permutation(E)[:k] for _ in range(Tl)]).astype(
        np.int32)
    x = rng.standard_normal((Tl, d)).astype(np.float32)
    keep = np.ones(Tl * k, bool) if pol == "dynamic" \
        else rng.random(Tl * k) < 0.6
    cap = None if pol == "dynamic" else 8
    moe = dict(n_experts=E, top_k=k, d_ff_expert=16, block_m=8)
    js, je, jst = jdist._sharded_send_phase(
        jnp.asarray(x), jax_dispatch_config(JaxMoEConfig(**moe),
                                            executor="xla",
                                            schedule_policy=pol),
        ep, _Plan(jnp.asarray(idx)), jnp.asarray(keep), cap)
    ts, te, tst = tdist._sharded_send_phase(
        torch.from_numpy(x), dispatch_config(W.MoEConfig(**moe),
                                             schedule_policy=pol),
        ep, _Plan(torch.from_numpy(idx)), torch.from_numpy(keep), cap)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    for key in ("tkeep", "send_pos", "counts_local"):
        np.testing.assert_array_equal(tst[key].numpy(), np.asarray(jst[key]),
                                      err_msg=key)
    assert tst["C"] == jst["C"]


def test_merge_chunk_aux_equal():
    rng = np.random.default_rng(3)
    keys = ["lb_loss", "router_z", "sched/useful_rows", "sched/dropped_rows",
            "sched/padded_rows", "sched/n_blocks_active", "sched/top1_share",
            "sched/pad_waste", "sched/drop_fraction", "sched/occupancy"]
    for n in (1, 2, 3):
        chunks = [{key: (rng.integers(0, 100) if key in COUNT_KEYS
                         else rng.random()) for key in keys}
                  for _ in range(n)]
        tm = tdist._merge_chunk_aux([
            {k: torch.tensor(v, dtype=torch.int32 if k in COUNT_KEYS
                             else torch.float32) for k, v in c.items()}
            for c in chunks])
        jm = jdist._merge_chunk_aux([
            {k: jnp.asarray(v, dtype=jnp.int32 if k in COUNT_KEYS
                            else jnp.float32) for k, v in c.items()}
            for c in chunks])
        assert set(tm) == set(jm)
        for k in jm:
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-6, (n, k)


def test_ep_refusals():
    """Outside a group, quantized experts under autograd in every layout
    (the ragged fallback's too, and the grid path's entry), and with ep
    not dividing E."""
    with pytest.raises(RuntimeError, match="EP group"):
        current_ep_group()
    inputs = make_inputs()
    params = shard_experts(quantize_moe_params(
        W.torch_params(inputs, "main"), "int8_expert"), 0, 2)
    cfg = dispatch_config(W.moe_config("main"))
    g = EPGroup(0, 2, None, "gloo", torch.device("cpu"))
    for xname in ("main", "ragged"):
        x = torch.from_numpy(inputs[f"{xname}.x"]).requires_grad_()
        for layout in ("sharded", "sharded_static", "replicated"):
            with pytest.raises(NotImplementedError, match="no backward"):
                tdist.apply_moe_ep(params, x, cfg, group=g,
                                   token_layout=layout)
    x = torch.from_numpy(inputs["main.x"]).requires_grad_()
    with pytest.raises(NotImplementedError, match="no backward"):
        tdist.apply_moe_ep_local(params, x, cfg, group=g,
                                 gtok=torch.arange(x.shape[0] * x.shape[1]))
    with pytest.raises(ValueError, match="must divide"):
        shard_experts(W.torch_params(inputs, "main"), 0, 3)


# ----------------------------------------------------------------------
# Serving: the loop in one process, the launcher and mp_serve_smoke
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n_hosts", (1, 2, 3, 5))
def test_partition_requests_equal(n_hosts):
    reqs = [Request(rid=i, prompt=np.arange(3, dtype=np.int32))
            for i in range(7)]
    got = [[r.rid for r in p] for p in partition_requests(reqs, n_hosts)]
    want = [[r.rid for r in p]
            for p in jserve_dist.partition_requests(reqs, n_hosts)]
    assert got == want
    for fn in (partition_requests, jserve_dist.partition_requests):
        with pytest.raises(ValueError):
            fn(reqs, 0)


def test_distributed_serve_loop_matches_reference_loop():
    """The port's loop and the reference's, each driving a port engine
    (one process, no EP): the same admissions in the same order and the
    same tokens as ``ServeEngine.run``."""
    cfg = reduced(get_config(ENGINE_ARCH))
    model = init_params(cfg, 0, device="cpu")
    rc = RunConfig(q_chunk=64, kv_chunk=64)

    def mk_reqs():
        return [Request(rid=i, prompt=np.arange(3 + i % 2, dtype=np.int32),
                        max_new=3) for i in range(4)]

    ref = ServeEngine(cfg, model, slots=2, capacity=32, rc=rc,
                      device="cpu").run(mk_reqs(), max_steps=64)
    runs = []
    for loop_cls in (DistributedServeLoop, jserve_dist.DistributedServeLoop):
        eng = ServeEngine(cfg, model, slots=2, capacity=32, rc=rc,
                          device="cpu")
        order = []
        admit = eng.admit
        eng.admit = lambda r, admit=admit: (order.append(r.rid), admit(r))[1]
        reqs = mk_reqs()
        done = loop_cls(eng, n_hosts=2).run(reqs, max_steps=64)
        runs.append((order, {r.rid: r.out for r in done}))
    assert runs[0] == runs[1]
    assert runs[0][1] == {r.rid: r.out for r in ref}
    assert len(ref) == 4


def _run(args, timeout=600):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, *args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def test_launcher_distributed_ep_devices_cpu():
    out = _run(["-m", "repro_torch.launch.serve", "--arch", ENGINE_ARCH,
                "--reduce", "--requests", "3", "--max-new", "3",
                "--distributed", "--ep-devices", "2", "--hosts", "2",
                "--device", "cpu"])
    assert out.returncode == 0, out.stdout + out.stderr
    assert "3/3 requests completed" in out.stdout, out.stdout
    assert out.stdout.count("requests completed") == 1, out.stdout
    assert "backend gloo" in out.stdout, out.stdout


def test_mp_serve_smoke():
    out = _run(["-m", "repro_torch.launch.mp_serve_smoke"])
    assert out.returncode == 0, out.stdout + out.stderr
    assert "mp serve smoke OK" in out.stdout, out.stdout
