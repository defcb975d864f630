"""The port's three executors against the reference's (counterpart of
tests/test_execution.py, with cases of tests/test_differential.py): the
registry ``["blocks", "cuda", "dense"]``; every executor x every policy
against the reference's dense oracle with the capacity drops zeroed; the
port's ``dense`` against the reference's ``dense`` and ``blocks`` against
the reference's ``xla`` on the same inputs, fused and unfused, folded and
unfolded, dense, int8 and int4 experts (schedules and indices equal, fp32
within 2e-5, bf16 within 2e-2); one plan on ``blocks`` and on ``cuda``
(its plain versions here) within ``FP_REORDER_FLOOR``; per-block dequant
bitwise the materialized stacks; ``sched/*`` only where a schedule
exists; a reduced moonshot's loss and every gradient on ``blocks`` and
``dense`` against ``jax.grad`` of the reference on ``xla`` and ``dense``;
EP at ep=2 over gloo on ``blocks`` against one rank's ``apply_moe``, and
its refusal of ``dense``; the served model's greedy tokens against the
reference engine's; the launchers' ``--executor`` with the reference's
spellings; the dry run's ``--executor dense``.  Inputs are numpy draws from
a seed, the same arrays on both sides."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.dispatch import MoEDispatchConfig as JaxDispatchConfig
from repro.core.dispatch import route as jax_route
from repro.execution import execute as jax_execute
from repro.execution import plan_dispatch as jax_plan_dispatch
from repro.kernels import ref as jax_ref
from repro.models.lm import RunConfig as JaxRunConfig
from repro.models.lm import loss_fn as jax_loss_fn
from repro.quantization import get_scheme as jax_get_scheme
from repro.scheduling import capacity_slots as jax_capacity_slots
from repro.scheduling import expert_capacity as jax_expert_capacity
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core.distributed import apply_moe_ep, apply_moe_ep_local
from repro_torch.core.dispatch import MoEDispatchConfig, moe_ffn
from repro_torch.core.moe_layer import apply_moe, dispatch_config
from repro_torch.distributed import EPGroup, spawn_ranks
from repro_torch.execution import (available_executors, execute,
                                   executor_cli_name, get_executor,
                                   plan_dispatch)
from repro_torch.launch import dryrun
from repro_torch.launch.serve import main as launch_main
from repro_torch.models.lm import RunConfig, loss_fn
from repro_torch.quantization import get_scheme
from repro_torch.scheduling import available_policies
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.weights import from_jax_params, from_jax_tree, shard_experts
from reference_init import numpy_init
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
import torch_ep_worker as W

T, K, E, M, D, F = 48, 2, 8, 8, 16, 24      # tests/test_execution.py
MATS = ("w_gate", "w_up", "w_down")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FP_REORDER_FLOOR = 5e-4                      # tests/test_differential.py
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
# the reference executor each port executor is held against
REF_NAME = {"blocks": "xla", "cuda": "pallas", "dense": "dense"}


def tol(dtype):                              # tests/test_kernels.py:31-33
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def layer_inputs(seed=2):
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=0.3):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"x": normal(T, D, scale=1.0), "router": normal(D, E),
            "w_gate": normal(E, D, F), "w_up": normal(E, D, F),
            "w_down": normal(E, F, D)}


def both_sides(inp, dtype):
    """(jax arrays, torch tensors) of ``inp``: the router fp32, the rest in
    ``dtype``."""
    jx = {k: jnp.asarray(v, jnp.float32 if k == "router" else JDT[dtype])
          for k, v in inp.items()}
    tx = {k: torch.from_numpy(v).to(torch.float32 if k == "router"
                                    else TDT[dtype])
          for k, v in inp.items()}
    return jx, tx


def dense_oracle(jx, cfg, needs_schedule):
    """tests/test_execution.py's oracle: the reference's dense layer on
    the reference's routing, with the capacity policy's drops zeroed for
    an executor that has a schedule."""
    weights, indices, _ = jax_route(jx["x"], jx["router"], cfg)
    if cfg.schedule_policy == "capacity_factor" and needs_schedule:
        cap = jax_expert_capacity(T, K, E, M, cfg.capacity_factor)
        slot, _ = jax_capacity_slots(indices.reshape(-1), E)
        weights = jnp.where((slot < cap).reshape(indices.shape), weights,
                            0.0)
    return jax_ref.moe_ffn_dense_ref(jx["x"], jx["w_gate"], jx["w_up"],
                                     jx["w_down"], weights, indices)


def test_registry_and_reference_spellings():
    assert available_executors() == ["blocks", "cuda", "dense"]
    for name in ("xla", "pallas", "triton"):
        with pytest.raises(ValueError, match=rf"unknown executor {name!r}; "
                                             r"available: \['blocks', "
                                             r"'cuda', 'dense'\]"):
            get_executor(name)
    assert [executor_cli_name(n) for n in
            ("pallas", "xla", "cuda", "blocks", "dense")] == \
        ["cuda", "blocks", "cuda", "blocks", "dense"]
    inp = layer_inputs()
    _, tx = both_sides(inp, "float32")
    with pytest.raises(ValueError, match="unknown executor 'xla'"):
        moe_ffn(tx["x"], tx["router"], tx["w_gate"], tx["w_up"],
                tx["w_down"], MoEDispatchConfig(E, K, M, executor="xla"))
    assert MoEDispatchConfig(E, K).executor == "cuda"
    assert RunConfig().executor == "cuda"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", sorted(available_policies()))
@pytest.mark.parametrize("executor", ["blocks", "cuda", "dense"])
def test_every_executor_every_policy_matches_oracle(executor, policy, dtype):
    jx, tx = both_sides(layer_inputs(), dtype)
    kw = dict(n_experts=E, top_k=K, block_m=M, schedule_policy=policy,
              capacity_factor=0.5)            # real drops
    cfg = MoEDispatchConfig(executor=executor, **kw)
    needs = get_executor(executor).needs_schedule
    oracle = dense_oracle(jx, JaxDispatchConfig(executor=REF_NAME[executor],
                                                **kw), needs)
    y, aux = moe_ffn(tx["x"], tx["router"], tx["w_gate"], tx["w_up"],
                     tx["w_down"], cfg)
    assert y.dtype == TDT[dtype] and y.shape == (T, D)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(oracle, np.float32), **tol(dtype))
    assert set(aux) >= {"lb_loss", "router_z"}
    plan = plan_dispatch(tx["x"], tx["router"], cfg)
    assert (plan.schedule is not None) == needs
    y2 = execute(plan, tx["x"], {k: tx[k] for k in MATS}, cfg)
    np.testing.assert_array_equal(y2.to(y.dtype).float().numpy(),
                                  y.float().numpy())


def _ref_plan_pair(executor, policy, dtype, fuse=True, fold=True,
                   scheme="none", seed=2):
    """(port output, reference output, port plan, reference plan) of one
    executor pair on the same inputs."""
    inp = layer_inputs(seed)
    jx, tx = both_sides(inp, dtype)
    kw = dict(n_experts=E, top_k=K, block_m=M, schedule_policy=policy,
              capacity_factor=0.5, fuse_gate_up=fuse, fold_combine=fold)
    jcfg = JaxDispatchConfig(executor=REF_NAME[executor], **kw)
    tcfg = MoEDispatchConfig(executor=executor, **kw)
    jw = {k: jx[k] for k in MATS}
    tw = {k: tx[k] for k in MATS}
    if scheme != "none":
        jw = {k: jax_get_scheme(scheme).quantize(
            jnp.asarray(inp[k])).with_dtype(JDT[dtype]) for k in MATS}
        tw = {k: get_scheme(scheme).quantize(
            torch.from_numpy(inp[k])).with_dtype(TDT[dtype]) for k in MATS}
        for k in MATS:
            np.testing.assert_array_equal(tw[k].q.numpy(),
                                          np.asarray(jw[k].q))
    jplan = jax_plan_dispatch(jx["x"], jx["router"], jcfg)
    tplan = plan_dispatch(tx["x"], tx["router"], tcfg)
    y_j = jax_execute(jplan, jx["x"], jw, jcfg).astype(jx["x"].dtype)
    y_t = execute(tplan, tx["x"], tw, tcfg).to(tx["x"].dtype)
    return y_t, y_j, tplan, jplan


def _assert_plans_equal(tplan, jplan):
    np.testing.assert_array_equal(tplan.indices.numpy(),
                                  np.asarray(jplan.indices))
    assert (tplan.schedule is None) == (jplan.schedule is None)
    if tplan.schedule is not None:
        for f in ("counts", "group_offsets", "src_tok", "pos",
                  "block_expert", "block_active"):
            np.testing.assert_array_equal(
                getattr(tplan.schedule, f).numpy(),
                np.asarray(getattr(jplan.schedule, f)), err_msg=f)
        assert tplan.schedule.capacity == jplan.schedule.capacity


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("policy", sorted(available_policies()))
def test_blocks_matches_reference_xla(policy, fuse, fold, dtype):
    """The loop over blocks is the reference's scan: the same schedule and
    products, the folded combine weights rounded to the output dtype."""
    y_t, y_j, tplan, jplan = _ref_plan_pair("blocks", policy, dtype, fuse,
                                            fold)
    _assert_plans_equal(tplan, jplan)
    np.testing.assert_allclose(y_t.float().numpy(),
                               np.asarray(y_j, np.float32), **tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", sorted(available_policies()))
def test_dense_matches_reference_dense(policy, dtype):
    y_t, y_j, tplan, jplan = _ref_plan_pair("dense", policy, dtype)
    _assert_plans_equal(tplan, jplan)
    assert tplan.schedule is None and tplan.combine_scale is None
    np.testing.assert_allclose(y_t.float().numpy(),
                               np.asarray(y_j, np.float32), **tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", ["int8_expert", "int8_channel",
                                    "int4_packed"])
@pytest.mark.parametrize("executor", ["blocks", "dense"])
def test_quantized_experts_match_reference(executor, scheme, dtype):
    """``blocks`` dequantizes each gathered expert, ``dense`` the whole
    stack up front, as the reference's ``xla`` and ``dense``."""
    y_t, y_j, _, _ = _ref_plan_pair(executor, "dynamic", dtype,
                                    scheme=scheme)
    np.testing.assert_allclose(y_t.float().numpy(),
                               np.asarray(y_j, np.float32), **tol(dtype))


def test_bf16_row_scale_rounded_as_the_reference():
    """``blocks`` rounds the folded combine weights to bf16 before the
    multiply (``grouped_gemm_xla``), bitwise the reference's here; held in
    fp32 instead the output moves by more than bf16 rounding."""
    y_t, y_j, tplan, _ = _ref_plan_pair("blocks", "fixed", "bfloat16")
    np.testing.assert_array_equal(y_t.float().numpy(),
                                  np.asarray(y_j, np.float32))
    scale = tplan.combine_scale
    assert not torch.equal(scale, scale.to(torch.bfloat16).float())


@pytest.mark.parametrize("scheme", ["none", "int8_expert", "int4_packed"])
@pytest.mark.parametrize("policy", sorted(available_policies()))
def test_one_plan_blocks_and_cuda_agree(policy, scheme):
    """tests/test_differential.py:109-131: one plan on both schedule
    executors, within the fp32 reorder floor of each other."""
    inp = layer_inputs(seed=5)
    _, tx = both_sides(inp, "float32")
    cfg = MoEDispatchConfig(n_experts=E, top_k=K, block_m=M,
                            executor="blocks", schedule_policy=policy,
                            capacity_factor=0.5)
    w = {k: tx[k] for k in MATS}
    if scheme != "none":
        w = {k: get_scheme(scheme).quantize(tx[k]) for k in MATS}
    plan = plan_dispatch(tx["x"], tx["router"], cfg)
    y_b = execute(plan, tx["x"], w, cfg)
    y_c = execute(plan, tx["x"], w, cfg, executor="cuda")
    scale = float(y_c.abs().max()) or 1.0
    assert float((y_b - y_c).abs().max()) / scale <= FP_REORDER_FLOOR
    torch.testing.assert_close(execute(plan, tx["x"], w, cfg), y_b,
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", ["int8_expert", "int4_packed"])
def test_blocks_per_block_dequant_equals_materialized(scheme, dtype):
    """tests/test_differential.py:152-167: executing on compressed stacks
    (one expert dequantized a block) is bitwise executing on the
    materialized stacks."""
    inp = layer_inputs(seed=7)
    _, tx = both_sides(inp, dtype)
    cfg = MoEDispatchConfig(n_experts=E, top_k=K, block_m=M,
                            executor="blocks", schedule_policy="dynamic")
    w = {k: get_scheme(scheme).quantize(torch.from_numpy(inp[k]))
         .with_dtype(TDT[dtype]) for k in MATS}
    plan = plan_dispatch(tx["x"], tx["router"], cfg)
    y_lazy = execute(plan, tx["x"], w, cfg)
    y_mat = execute(plan, tx["x"], {k: v.materialize() for k, v in w.items()},
                    cfg)
    torch.testing.assert_close(y_lazy, y_mat, rtol=0, atol=0)


def test_schedule_free_plan_and_dense_phases_refused():
    _, tx = both_sides(layer_inputs(), "float32")
    w = {k: tx[k] for k in MATS}
    cfg = MoEDispatchConfig(n_experts=E, top_k=K, block_m=M,
                            executor="dense")
    plan = plan_dispatch(tx["x"], tx["router"], cfg)      # no schedule
    assert plan.schedule is None
    for name in ("blocks", "cuda"):
        with pytest.raises(ValueError, match="with_schedule=True"):
            execute(plan, tx["x"], w, cfg, executor=name)
    lean = plan_dispatch(tx["x"], tx["router"], cfg._replace(
        executor="blocks"), with_schedule=False)
    assert lean.schedule is None and lean.combine_scale is None
    full = plan_dispatch(tx["x"], tx["router"], cfg, with_schedule=True)
    assert full.schedule is not None
    dense = get_executor("dense")
    with pytest.raises(NotImplementedError, match="dense"):
        dense.permute(torch.zeros(8, 4), None, cfg)
    with pytest.raises(NotImplementedError, match="dense"):
        dense.expert_ffn(torch.zeros(8, 4), {}, None, cfg)
    with pytest.raises(NotImplementedError, match="dense"):
        dense.unpermute(torch.zeros(8, 4), None, None, cfg)


# ----------------------------------------------------------------------
# The model: stats, training, serving
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def moonshot():
    """Reduced moonshot (2 layers: 1 dense + 1 MoE) on both sides."""
    jcfg = jax_reduced(jax_get_config("moonshot-v1-16b-a3b"), layers=2)
    tcfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=2)
    tree = numpy_init(jcfg, 0)
    model = from_jax_params(tcfg, tree, device="cpu")
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), model


def test_sched_stats_only_where_a_schedule_exists(moonshot):
    """tests/test_execution.py::test_moe_stats_flow_through_model_scan."""
    _, tcfg, _, model = moonshot
    batch = {"tokens": torch.ones((2, 16), dtype=torch.int32)}
    rc = RunConfig(moe_stats=True, schedule_policy="dynamic", loss_chunk=16)
    with torch.no_grad():
        for name in ("blocks", "cuda"):
            _, m = loss_fn(model, tcfg, rc._replace(executor=name), batch)
            assert "sched/pad_waste" in m and "sched/occupancy" in m
            assert float(m["sched/useful_rows"]) > 0
        _, m = loss_fn(model, tcfg, rc._replace(executor="dense"), batch)
    assert not any(k.startswith("sched/") for k in m)


@pytest.mark.parametrize("executor", ["blocks", "dense"])
def test_loss_and_every_gradient_match_jax(moonshot, executor):
    """Autograd through the plain ops alone against ``jax.grad`` of the
    reference on its counterpart executor, fp32."""
    jcfg, tcfg, params, model = moonshot
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    jrc = JaxRunConfig(executor=REF_NAME[executor], schedule_policy="dynamic",
                       loss_chunk=8)
    (loss_j, m_j), g_j = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, jcfg, jrc, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(params)
    model = model.requires_grad_(True)
    rc = RunConfig(executor=executor, schedule_policy="dynamic", loss_chunk=8)
    try:
        loss_t, m_t = loss_fn(model, tcfg, rc,
                              {"tokens": torch.from_numpy(toks)})
        named = dict(model.named_parameters())
        grads = torch.autograd.grad(loss_t, list(named.values()))
    finally:
        model.requires_grad_(False)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               **LOSS_TOL)
    for key in ("ce", "lb_loss", "router_z"):
        np.testing.assert_allclose(float(m_t[key].detach()), float(m_j[key]),
                                   **LOSS_TOL)
    want = from_jax_tree(tcfg, jax.tree.map(np.asarray, g_j))
    assert set(want) == set(named)
    for name, g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=name,
                                   **GRAD_TOL)
    assert np.abs(want["layers.1.moe.w_down"]).max() > 0


@pytest.mark.parametrize("executor", ["blocks", "dense"])
def test_greedy_tokens_identical_to_reference_engine(moonshot, executor):
    jcfg, tcfg, params, model = moonshot
    rng = np.random.default_rng(3)
    # one prompt length: the reference engine compiles one prefill shape
    prompts = [rng.integers(0, tcfg.vocab_size, 8).astype(np.int32)
               for _ in range(3)]
    max_new = (4, 3, 5)
    jeng = JaxServeEngine(jcfg, params, slots=2, capacity=24,
                          rc=JaxRunConfig(executor=REF_NAME[executor],
                                          schedule_policy="fixed",
                                          q_chunk=64, kv_chunk=64),
                          kv_block_size=0)
    jreqs = [JaxRequest(rid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, max_new))]
    jeng.run(jreqs, max_steps=64)
    teng = ServeEngine(tcfg, model, slots=2, capacity=24, kv_block_size=0,
                       rc=RunConfig(executor=executor,
                                    schedule_policy="fixed", moe_stats=True),
                       device="cpu")
    treqs = [Request(rid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, max_new))]
    done = teng.run(treqs, max_steps=64)
    assert len(done) == 3
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    has_sched = [any(k.startswith("sched/") for k in r.stats) for r in treqs]
    assert has_sched == [executor == "blocks"] * 3


def test_executor_carried_to_the_draft_and_the_plan_hook(moonshot):
    """The speculative engine's draft runs the target's executor (the
    reference's ``spec/engine.py:97``), and the plan hook is told which."""
    from repro_torch.execution import set_plan_hook
    from repro_torch.models.lm import init_params
    from repro_torch.spec import SpecEngine, make_draft_config
    _, tcfg, _, model = moonshot
    dcfg = make_draft_config(tcfg, "moonshot-v1-16b-a3b", reduce=True)
    eng = SpecEngine(tcfg, model, draft_cfg=dcfg,
                     draft_model=init_params(dcfg, 1, device="cpu"),
                     spec_k=2, slots=2, capacity=32, kv_block_size=4,
                     rc=RunConfig(executor="dense"), device="cpu")
    assert eng.rc.executor == eng.drc.executor == "dense"
    seen = []
    prev = set_plan_hook(lambda **kw: seen.append(kw["executor"]))
    try:
        _, tx = both_sides(layer_inputs(), "float32")
        for name in ("blocks", "dense"):
            moe_ffn(tx["x"], tx["router"], tx["w_gate"], tx["w_up"],
                    tx["w_down"], MoEDispatchConfig(E, K, M, executor=name))
    finally:
        set_plan_hook(prev)
    assert seen == ["blocks", "dense"]


# ----------------------------------------------------------------------
# Expert parallelism
# ----------------------------------------------------------------------
EP_CASES = {f"blocks-{pol}-{lay}": dict(shape="main", policy=pol,
                                        layout=lay, executor="blocks")
            for pol in ("fixed", "capacity_factor")
            for lay in ("sharded", "replicated")}
EP_CASES["blocks-int8_expert-sharded"] = dict(
    shape="main", policy="fixed", layout="sharded", executor="blocks",
    scheme="int8_expert", capacity_factor=8.0)


def ep_inputs():
    rng = np.random.default_rng(0)
    m = W.moe_config("main")
    d, f, e = 16, m.d_ff_expert, m.n_experts
    return {"main.router": (rng.standard_normal((d, e)) * d ** -0.5
                            ).astype(np.float32),
            "main.w_gate": (rng.standard_normal((e, d, f)) * d ** -0.5
                            ).astype(np.float32),
            "main.w_up": (rng.standard_normal((e, d, f)) * d ** -0.5
                          ).astype(np.float32),
            "main.w_down": (rng.standard_normal((e, f, d)) * f ** -0.5
                            ).astype(np.float32),
            "main.x": rng.standard_normal((2, 16, d)).astype(np.float32)}


@pytest.fixture(scope="module")
def ep_runs():
    inputs = ep_inputs()
    return inputs, spawn_ranks(W.rank_main, 2, "cpu", inputs, EP_CASES,
                               None, timeout=600)


@pytest.mark.parametrize("name", sorted(EP_CASES))
def test_ep_on_blocks_matches_one_rank(ep_runs, name):
    """ep=2 over gloo on ``blocks``: both ranks the same y, within 2e-4 of
    the single-device layer on ``blocks``, the same kept and dropped
    rows."""
    inputs, res = ep_runs
    case = EP_CASES[name]
    y, aux = res[0]["moe"][name]
    np.testing.assert_array_equal(res[1]["moe"][name][0], y)
    _, dcfg, _ = W.case_config(case)
    assert dcfg.executor == "blocks"
    params = W.torch_params(inputs, "main")
    if case.get("scheme"):
        from repro_torch.quantization import quantize_moe_params
        params = quantize_moe_params(params, case["scheme"])
    with torch.no_grad():
        y1, aux1 = apply_moe(params, torch.from_numpy(inputs["main.x"]),
                             dcfg)
    np.testing.assert_allclose(y, y1.numpy(), rtol=2e-4, atol=2e-4)
    for k in ("sched/useful_rows", "sched/dropped_rows"):
        assert aux[k] == float(aux1[k]), (name, k)
    if case["policy"] == "capacity_factor":
        assert aux["sched/dropped_rows"] > 0


def test_ep_refuses_dense():
    inputs = ep_inputs()
    params = shard_experts(W.torch_params(inputs, "main"), 0, 2)
    x = torch.from_numpy(inputs["main.x"])
    cfg = dispatch_config(W.moe_config("main"), executor="dense")
    g = EPGroup(0, 2, None, "gloo", torch.device("cpu"))
    with pytest.raises(ValueError, match="'blocks' or 'cuda'"):
        apply_moe_ep(params, x, cfg, group=g)
    with pytest.raises(ValueError, match="'blocks' or 'cuda'"):
        apply_moe_ep_local(params, x, cfg, gtok=torch.arange(32), group=g)


# ----------------------------------------------------------------------
# The launchers
# ----------------------------------------------------------------------
REF_ARGV = ["--arch", "moonshot-v1-16b-a3b", "--reduce", "--requests", "2",
            "--max-new", "3", "--slots", "2", "--kv-block-size", "16",
            "--schedule-policy", "fixed"]


@pytest.mark.parametrize("spelling,name", [("pallas", "cuda"),
                                           ("dense", "dense")])
def test_launcher_executor_flag(capsys, spelling, name):
    """The reference's ``--executor pallas`` names ``cuda``; ``dense``
    serves the same greedy tokens as ``cuda`` in fp32."""
    argv = REF_ARGV + ["--dtype", "fp32", "--device", "cpu"]
    done = launch_main(argv + ["--executor", spelling])
    out = capsys.readouterr().out
    assert len(done) == 2 and f"fixed schedule, {name} executor" in out
    assert ("plan stats" in out) == (name != "dense")
    base = launch_main(argv)
    assert [r.out for r in done] == [r.out for r in base]


def test_launcher_refuses_dense_under_ep(monkeypatch):
    """``--executor dense --distributed`` exits before a rank or a weight
    exists."""
    import repro_torch.distributed as dist_mod

    def boom(*a, **k):
        raise AssertionError("ranks spawned")
    monkeypatch.setattr(dist_mod, "spawn_ranks", boom)
    with pytest.raises(SystemExit, match="--executor dense has no "
                                         "schedule"):
        launch_main(REF_ARGV + ["--executor", "dense", "--distributed",
                                "--device", "cpu"])


def test_dryrun_executor_dense_counts_every_expert():
    """A reduced moonshot prefill cell on 1x1: ``dense`` and ``blocks``
    cells ``ok``; dense FLOPs above the ``cuda`` cell's, which count
    every scheduled row; on a 'model' axis of 2 the ``dense`` cell is
    ``skip``."""
    cfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=2)
    shape = ShapeConfig("prefill_small", 32, 2, "prefill")
    recs = {ex: dryrun.run_cell("moonshot-v1-16b-a3b", shape, "1x1",
                                cfg=cfg, executor=ex)
            for ex in (None, "blocks", "dense")}
    for ex, rec in recs.items():
        assert rec["status"] == "ok", (ex, rec.get("error"))
    assert "executor" not in recs[None] and recs["dense"]["executor"] == \
        "dense"
    flops = {ex: rec["cost"]["flops"] for ex, rec in recs.items()}
    assert flops["dense"] > flops[None] > 0 and flops["blocks"] > 0
    skip = dryrun.run_cell("moonshot-v1-16b-a3b", shape, "1x2", cfg=cfg,
                           executor="dense")
    assert skip["status"] == "skip" and "blocks or cuda" in skip["reason"]
