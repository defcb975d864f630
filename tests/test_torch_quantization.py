"""The port's expert-weight quantization (``repro_torch.quantization``)
against ``repro.quantization`` on the same numpy inputs:

* the registry (names, bits, declared error bounds, kernel formats);
* ``pack_int4`` / ``unpack_int4`` and every scheme's payload and scales,
  bitwise, on fp32 and bf16 stacks, on a stacked (G, E, K, N) input sliced
  per layer, and on an odd-K int4 input (pad row tagged, then stripped);
* ``QuantTensor``'s logical shape, stored bytes, materialization and
  per-expert indexing;
* the plain quantized ``fused_gate_up`` and ``grouped_gemm`` (with the
  folded combine rows) on the ``fixed`` and ``dynamic`` schedules against
  the Pallas kernels in interpret mode, with tests/test_kernels.py's cases
  and tolerances (fp32 2e-5, bf16 2e-2);
* ``apply_moe`` under each scheme within the scheme's declared
  ``rel_error_bound`` of the fp32 dense output (``none`` bitwise equal to
  unquantized), and within 2e-5 of the reference's quantized layer;
* the engine quantizing from ``RunConfig.quant`` (idempotent), no dense
  routed stack left after ``quantize_model``, the launcher's flags;
* greedy tokens identical to ``repro.serve.ServeEngine`` with the same
  ``rc.quant`` on reduced moonshot (paged, ``dynamic``).

(The CUDA kernels' int8/int4 formats are held against these plain versions
on the card: test_torch_gpu.py and chip_smoke.py.)"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

import repro.quantization as jq  # noqa: E402
from repro.core.dispatch import MoEDispatchConfig as JaxDispatchConfig
from repro.core.dispatch import combine_scale_rows as jax_combine_rows
from repro.core.moe_layer import apply_moe as jax_apply_moe
from repro.core.quant import quantize_expert as jax_quantize_expert
from repro.core.schedule import build_schedule as jax_build_schedule
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.scheduling.dynamic import build_dynamic_schedule as jax_dynamic
import repro_torch.quantization as tq
from repro_torch.core.dispatch import MoEDispatchConfig
from repro_torch.core.moe_layer import apply_moe
from repro_torch.core.quant import effective_expert_weights, quantize_expert
from repro_torch.execution import (Executor, combine_scale_rows,
                                   register_executor)
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.scheduling import build_dynamic_schedule, build_fixed_schedule
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

SCHEMES = ["int8_expert", "int8_channel", "int4_packed"]
CASES = [
    # (T, E, k, d, f, block_m), as tests/test_kernels.py
    (32, 4, 1, 16, 32, 8),
    (64, 8, 2, 32, 48, 8),
    (128, 16, 4, 64, 64, 16),
    (256, 8, 2, 128, 256, 128),
]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def np32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(a, np.float32)


def both(a, dtype):
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def same_bits(t: torch.Tensor, j) -> None:
    """Bitwise equality of a torch tensor and a JAX array (dtypes too)."""
    jn = np.asarray(j)
    tn = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()
    if t.dtype == torch.bfloat16:
        jn = jn.view(np.int16)
    assert tn.dtype == jn.dtype and tn.shape == jn.shape, \
        (tn.dtype, jn.dtype, tn.shape, jn.shape)
    np.testing.assert_array_equal(tn, jn)


def stack(shape, seed=0, scale=0.2):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def test_registry_matches_reference():
    assert tq.available_schemes() == jq.available_schemes()
    for name in jq.available_schemes():
        js, ts = jq.get_scheme(name), tq.get_scheme(name)
        assert (ts.name, ts.bits, ts.rel_error_bound, ts.kernel_format) == \
            (js.name, js.bits, js.rel_error_bound, js.kernel_format)
    with pytest.raises(ValueError, match="unknown quant scheme"):
        tq.get_scheme("fp8_block")


def test_pack_unpack_int4_bitwise():
    q4 = np.random.default_rng(3).integers(-8, 8, (3, 10, 7)).astype(np.int32)
    packed_t = tq.pack_int4(torch.from_numpy(q4))
    packed_j = jq.pack_int4(jnp.asarray(q4))
    same_bits(packed_t, packed_j)
    same_bits(tq.unpack_int4(packed_t), jq.unpack_int4(packed_j))
    np.testing.assert_array_equal(tq.unpack_int4(packed_t).numpy(), q4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_quantize_bitwise_equal_to_reference(scheme, dtype):
    w = stack((5, 24, 40), seed=1)
    w[2] *= 30.0                         # experts of very different ranges
    wj, wt = both(w, dtype)
    qj = jq.get_scheme(scheme).quantize(wj)
    qt = tq.get_scheme(scheme).quantize(wt)
    same_bits(qt.q, qj.q)
    same_bits(qt.s, qj.s)
    assert qt.shape == qj.shape == (5, 24, 40)
    assert qt.nbytes == qj.nbytes and qt.meta == qj.meta == ()
    assert qt.dtype == TDT[dtype]
    same_bits(qt.materialize(), qj.materialize())
    same_bits(qt[3], qj[3])
    same_bits(qt[torch.tensor([4, 0, 2])], qj[jnp.array([4, 0, 2])])
    q32 = qt.with_dtype(torch.float32)
    assert q32.q is qt.q and q32.s is qt.s
    same_bits(q32.materialize(), qj.with_dtype(jnp.float32).materialize())


@pytest.mark.parametrize("scheme", SCHEMES)
def test_stacked_layers_quantize_per_layer_bitwise(scheme):
    """The reference quantizes a (G, E, K, N) body stack in one call; the
    port quantizes each layer's (E, K, N) slice: the same bits."""
    w = stack((3, 4, 16, 24), seed=2)
    qj = jq.get_scheme(scheme).quantize(jnp.asarray(w))
    q_stacked = tq.get_scheme(scheme).quantize(torch.from_numpy(w))
    same_bits(q_stacked.q, qj.q)
    same_bits(q_stacked.s, qj.s)
    for g in range(3):
        qt = tq.get_scheme(scheme).quantize(torch.from_numpy(w[g]))
        same_bits(qt.q, qj.q[g])
        same_bits(qt.s, qj.s[g])


def test_int4_odd_k_pads_then_strips():
    w = stack((3, 9, 16), seed=4)
    qj = jq.get_scheme("int4_packed").quantize(jnp.asarray(w))
    qt = tq.get_scheme("int4_packed").quantize(torch.from_numpy(w))
    assert qt.meta == qj.meta == (("pad_k", 1),)
    assert tuple(qt.q.shape) == (3, 5, 16) and qt.shape == qj.shape \
        == (3, 9, 16)
    same_bits(qt.q, qj.q)
    same_bits(qt.materialize(), qj.materialize())
    same_bits(qt[1], qj[1])
    # no in-kernel path for the padded layout: the wrappers get a dense one
    wq, ws, fmt = tops._weight_operands(qt)
    assert fmt == "dense" and ws is None and tuple(wq.shape) == (3, 9, 16)


def test_core_quant_aliases():
    w = stack((4, 16, 8), seed=5)
    q, s = quantize_expert(torch.from_numpy(w))
    qj, sj = jax_quantize_expert(jnp.asarray(w))
    same_bits(q, qj)
    same_bits(s, sj)
    p = tq.quantize_moe_params({"w_gate": torch.from_numpy(w),
                                "w_up": torch.from_numpy(w),
                                "w_down": torch.from_numpy(w)})
    out = effective_expert_weights(p, torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 and v.q is p[k].q
               for k, v in out.items())


def make_inputs(T, E, k, d, f, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    x = (rng.standard_normal((T, d)) * 0.5).astype(np.float32)
    wg = (rng.standard_normal((E, d, f)) * 0.2).astype(np.float32)
    wu = (rng.standard_normal((E, d, f)) * 0.2).astype(np.float32)
    wd = (rng.standard_normal((E, f, d)) * 0.2).astype(np.float32)
    return logits, x, wg, wu, wd


@pytest.mark.parametrize("policy", ["fixed", "dynamic"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("T,E,k,d,f,M", CASES)
def test_quantized_gemms_plain_match_pallas(T, E, k, d, f, M, scheme, dtype,
                                            policy):
    logits, x, wg, wu, wd = make_inputs(T, E, k, d, f, seed=T + E)
    w, idx = jref.router_ref(jnp.asarray(logits), k)
    if policy == "fixed":
        js = jax_build_schedule(idx, E, M)
        ts = build_fixed_schedule(torch.from_numpy(np.array(idx)), E, M)
    else:
        js = jax_dynamic(idx, E, M, block_m_min=8)
        ts = build_dynamic_schedule(torch.from_numpy(np.array(idx)), E, M)
    jsch, tsch = jq.get_scheme(scheme), tq.get_scheme(scheme)
    (wgj, wgt), (wuj, wut), (wdj, wdt) = (both(a, dtype) for a in (wg, wu,
                                                                   wd))
    qgj, qgt = jsch.quantize(wgj), tsch.quantize(wgt)
    quj, qut = jsch.quantize(wuj), tsch.quantize(wut)
    qdj, qdt = jsch.quantize(wdj), tsch.quantize(wdt)
    xj, xt = both(x, dtype)
    xpj, xpt = jref.permute_ref(xj, js), tref.permute_ref(xt, ts)
    h_t = tops.fused_gate_up(xpt, qgt, qut, ts)
    hj = jops.fused_gate_up(xpj, qgj, quj, js, block_n=min(f, 128),
                            block_k=min(d, 128))
    np.testing.assert_allclose(np32(h_t), np32(hj), **tol(dtype))
    ht = torch.from_numpy(np32(hj)).to(TDT[dtype])
    sj = jax_combine_rows(js, w)
    st = combine_scale_rows(ts, torch.from_numpy(np.array(w)))
    y_t = tops.grouped_gemm(ht, qdt, ts, row_scale=st)
    yj = jops.grouped_gemm(hj, qdj, js, row_scale=sj, block_n=min(d, 128),
                           block_k=min(f, 128))
    np.testing.assert_allclose(np32(y_t), np32(yj), **tol(dtype))
    dead = (ts.block_active == 0).repeat_interleave(ts.block_m).numpy()
    assert not np32(h_t)[dead].any() and not np32(y_t)[dead].any()


def layer(E=8, d=32, f=48, T=64, seed=7):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((T, d)).astype(np.float32),
        "router": (rng.standard_normal((d, E)) * d ** -0.5).astype(np.float32),
        "w_gate": (rng.standard_normal((E, d, f)) * d ** -0.5).astype(np.float32),
        "w_up": (rng.standard_normal((E, d, f)) * d ** -0.5).astype(np.float32),
        "w_down": (rng.standard_normal((E, f, d)) * f ** -0.5).astype(np.float32),
        "shared": {
            "w_gate": (rng.standard_normal((d, f)) * d ** -0.5).astype(np.float32),
            "w_up": (rng.standard_normal((d, f)) * d ** -0.5).astype(np.float32),
            "w_down": (rng.standard_normal((f, d)) * f ** -0.5).astype(np.float32),
        },
    }


def to_torch(tree):
    return {k: to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def to_jax(tree):
    return {k: to_jax(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("scheme", ["none"] + SCHEMES)
def test_apply_moe_within_declared_bound(scheme):
    """fp32: each scheme's layer output within its rel_error_bound (inf
    norm) of the dense one, and within 2e-5 of the reference's layer on
    the same quantized params (xla executor)."""
    inp = layer()
    kw = dict(n_experts=8, top_k=2, block_m=8, gating="softmax")
    tcfg = MoEDispatchConfig(executor="cuda", schedule_policy="dynamic", **kw)
    jcfg = JaxDispatchConfig(executor="xla", schedule_policy="dynamic", **kw)
    params = to_torch(inp)
    x = params.pop("x")
    y_dense, _ = apply_moe(params, x, tcfg)
    qparams = tq.quantize_moe_params(params, scheme)
    assert tq.params_scheme(qparams) == scheme
    assert tq.is_quantized(qparams) == (scheme != "none")
    y_q, _ = apply_moe(qparams, x, tcfg)
    if scheme == "none":
        assert torch.equal(y_q, y_dense)
        return
    rel = (y_q - y_dense).abs().max() / y_dense.abs().max()
    assert float(rel) <= tq.get_scheme(scheme).rel_error_bound, float(rel)
    assert float(rel) > 0
    jparams = to_jax(inp)
    xj = jparams.pop("x")
    y_j, _ = jax_apply_moe(jq.quantize_moe_params(jparams, scheme), xj, jcfg)
    np.testing.assert_allclose(y_q.numpy(), np.asarray(y_j), rtol=2e-5,
                               atol=2e-5)


def test_unsupported_scheme_raises():
    class DenseOnly(Executor):
        def supports_scheme(self, scheme):
            return scheme == "none"

    register_executor("dense_only_test")(DenseOnly)
    params = to_torch(layer())
    x = params.pop("x")
    cfg = MoEDispatchConfig(n_experts=8, top_k=2, block_m=8,
                            executor="dense_only_test")
    qparams = tq.quantize_moe_params(params, "int8_expert")
    with pytest.raises(ValueError, match="does not support quant scheme"):
        apply_moe(qparams, x, cfg)
    with pytest.raises(ValueError, match="already quantized"):
        tq.quantize_moe_params(qparams, "int4_packed")
    assert tq.quantize_moe_params(qparams, "int8_expert")["w_gate"] \
        is qparams["w_gate"]


@pytest.fixture(scope="module")
def reduced_moonshot():
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced as jax_reduced
    from repro.models.lm import init_params as jax_init_params
    from repro_torch.configs import get_config, reduced
    jcfg = jax_reduced(jax_get_config("moonshot-v1-16b-a3b"), layers=3)
    tcfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=3)
    params = jax_init_params(jcfg, jax.random.key(0))
    return jcfg, tcfg, params, jax.tree.map(np.asarray, params)


def port_model(tcfg, np_params):
    from repro_torch.weights import from_jax_params
    return from_jax_params(tcfg, np_params, device="cpu")


def test_quantize_model_leaves_no_dense_routed_stack(reduced_moonshot):
    _, tcfg, _, np_params = reduced_moonshot
    model = port_model(tcfg, np_params)
    dense = tq.routed_expert_bytes(model)
    tq.quantize_model(model, "int4_packed")
    names = dict(model.named_parameters())
    routed = [n for n in names if ".moe." in n and ".shared." not in n
              and n.split(".")[-1] in tq.EXPERT_MATS]
    assert routed == []
    assert any(".moe.router" in n for n in names)            # stays dense
    assert any(".moe.shared.w_gate" in n for n in names)     # stays dense
    sd = model.state_dict()
    moe_layers = [i for i, b in enumerate(model.layers) if b.kind == "moe"]
    for i in moe_layers:
        for m in tq.EXPERT_MATS:
            assert sd[f"layers.{i}.moe.{m}_q"].dtype == torch.int8
            assert sd[f"layers.{i}.moe.{m}_s"].dtype == torch.float32
        p = model.layers[i].moe.params()
        assert tq.params_scheme(p) == "int4_packed"
    # int4: 1/8 of the fp32 bytes plus one fp32 scale per expert matrix
    E = tcfg.moe.n_experts
    assert tq.routed_expert_bytes(model) == \
        dense // 8 + len(moe_layers) * 3 * E * 4
    assert tq.quantize_model(model, "int4_packed") is model   # idempotent
    with pytest.raises(ValueError, match="already quantized"):
        tq.quantize_model(model, "int8_expert")


def test_engine_quantizes_from_run_config_idempotently(reduced_moonshot):
    from repro_torch.models.lm import RunConfig
    from repro_torch.serve.engine import ServeEngine
    _, tcfg, _, np_params = reduced_moonshot
    model = port_model(tcfg, np_params)
    eng = ServeEngine(tcfg, model, device="cpu")
    assert eng.quant_expert_bytes is None
    rc = RunConfig(schedule_policy="dynamic", quant="int8_expert")
    eng = ServeEngine(tcfg, model, rc=rc, device="cpu")
    moe = next(b.moe for b in model.layers if b.kind == "moe")
    q_before = moe.expert_weight("w_gate").q
    assert eng.quant_expert_bytes == tq.routed_expert_bytes(model)
    eng2 = ServeEngine(tcfg, model, rc=rc, device="cpu")
    assert moe.expert_weight("w_gate").q is q_before
    assert eng2.quant_expert_bytes == eng.quant_expert_bytes
    with pytest.raises(ValueError, match="already quantized"):
        ServeEngine(tcfg, model, rc=rc._replace(quant="int4_packed"),
                    device="cpu")


def shared_prefix_prompts(vocab):
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, 9)
    return [(np.concatenate([shared, rng.integers(0, vocab, n)])
             if i % 2 == 0 else rng.integers(0, vocab, n + 3)
             ).astype(np.int32) for i, n in enumerate((2, 6, 4, 1, 5))]


@pytest.mark.parametrize("scheme", ["int8_expert", "int4_packed"])
def test_quantized_greedy_tokens_identical_to_reference_engine(
        reduced_moonshot, scheme):
    """Paged, dynamic, blocks of 4, prefill chunks of 4, five requests on
    two slots; the reference's xla executor dequantizes each gathered
    block in its scan (JAX's tests hold xla == pallas)."""
    from repro.models.lm import RunConfig as JaxRunConfig
    from repro.serve.engine import Request as JaxRequest
    from repro.serve.engine import ServeEngine as JaxServeEngine
    from repro_torch.models.lm import RunConfig
    from repro_torch.serve.engine import Request, ServeEngine
    jcfg, tcfg, params, np_params = reduced_moonshot
    prompts = shared_prefix_prompts(tcfg.vocab_size)
    max_new = (6, 4, 7, 5, 3)
    jeng = JaxServeEngine(jcfg, params, slots=2, capacity=32,
                          rc=JaxRunConfig(executor="xla",
                                          schedule_policy="dynamic",
                                          quant=scheme,
                                          q_chunk=64, kv_chunk=64),
                          kv_block_size=4, prefill_chunk=4)
    jreqs = [JaxRequest(rid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, max_new))]
    jeng.run(jreqs, max_steps=128)
    assert all(r.done for r in jreqs)
    teng = ServeEngine(tcfg, port_model(tcfg, np_params), slots=2,
                       capacity=32, kv_block_size=4, prefill_chunk=4,
                       rc=RunConfig(schedule_policy="dynamic", quant=scheme),
                       device="cpu")
    treqs = [Request(rid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, max_new))]
    done = teng.run(treqs, max_steps=128)
    assert len(done) == len(treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    leaves = jax.tree.leaves(jeng.params,
                             is_leaf=lambda v: isinstance(v, jq.QuantTensor))
    assert teng.quant_expert_bytes == sum(
        v.nbytes for v in leaves if isinstance(v, jq.QuantTensor))


def test_launcher_quant_flags(capsys, monkeypatch):
    """--quant serves the routed experts compressed; --quant-experts is the
    deprecated alias for int8_expert (reduced width: the card runs full
    width)."""
    import repro_torch.configs as configs
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import main as launch_main
    small = reduced(get_config("moonshot-v1-16b-a3b"), layers=3)
    monkeypatch.setattr(configs, "get_config", lambda name: small)
    base = ["--arch", "moonshot-v1-16b-a3b", "--layers", "2", "--requests",
            "2", "--max-new", "2", "--dtype", "fp32", "--device", "cpu"]
    done = launch_main(base + ["--quant", "int4_packed"])
    out = capsys.readouterr().out
    assert len(done) == 2 and "routed experts: int4_packed scheme" in out
    assert "peak device memory" in out
    with pytest.warns(DeprecationWarning, match="--quant-experts"):
        launch_main(base + ["--quant-experts"])
    assert "routed experts: int8_expert scheme" in capsys.readouterr().out
    launch_main(base + ["--quant", "none", "--quant-experts"])
    assert "routed experts: none scheme" in capsys.readouterr().out
