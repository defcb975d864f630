"""The dry run (``repro_torch.launch.dryrun``) against real steps on the
CPU: at reduced configs, one rank's step on fake tensors counts the same
FLOPs as ``FlopCounterMode`` counts of the same step run for real (the
kernels' shape-only ops counting every scheduled row where the plain
versions compute only active blocks), the same argument bytes as the real
tensors hold, and, on a 2x2 grid, the same collectives (op, bytes, group
size) as a real gloo step's counters.  The kernels' shape-only ops give
their plain versions' shapes and dtypes.  The variants: a decode cell
under int8 or int4 experts holds a real quantized model's parameter bytes
(``quantize_model`` runs on fake tensors), a train cell under ``quant``
is ``skip``, ``capacity_factor`` moves the FLOPs by what ``cell_cost``
predicts, and ``--variant`` tags the record and its file.  No JAX
here."""
import contextlib

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.distributed import spawn_ranks
from repro_torch.distributed.group import dry_grid
from repro_torch.kernels import fused_gate_up as fgu_mod
from repro_torch.kernels import grouped_gemm as gg_mod
from repro_torch.kernels import grouped_wgrad as wg_mod
from repro_torch.kernels import ops, shapes
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.launch import dryrun, specs
from repro_torch.scheduling import build_schedule, combine_scale_rows

from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
import torch_dryrun_worker as W

# zamba2 at 7 layers: two groups (both shared blocks) and the suffix
LAYERS = {"moonshot-v1-16b-a3b": 2, "deepseek-v2-236b": 2, "qwen2-7b": 2,
          "zamba2-7b": 7, "rwkv6-1.6b": 2}
TRAIN = ShapeConfig("train_small", 32, 4, "train")
PREFILL = ShapeConfig("prefill_small", 32, 2, "prefill")
DECODE = ShapeConfig("decode_small", 32, 2, "decode")
ACCUM = {"qwen2-7b": 2}       # one case accumulates two microbatches
CASES = [(a, TRAIN) for a in LAYERS] + [
    (a, s) for a in ("moonshot-v1-16b-a3b", "deepseek-v2-236b", "qwen2-7b",
                     "zamba2-7b") for s in (PREFILL, DECODE)]
# the kernels' plain versions, whose FLOPs (active blocks only) the real
# step counts where the fake step counts the shape-only ops' (every row)
PLAINS = [(gg_mod, "grouped_gemm_plain"), (gg_mod, "grouped_gemm_t_plain"),
          (fgu_mod, "fused_gate_up_plain"), (wg_mod, "grouped_wgrad_plain")]


def _cfg(arch):
    return reduced(get_config(arch), layers=LAYERS[arch])


def _rc(cfg, shape):
    return specs.dryrun_runconfig(cfg, shape, ep=False)._replace(
        q_chunk=16 if cfg.family in ("ssm", "hybrid") else 0, kv_chunk=16,
        loss_chunk=16)


def _step(arch, shape, fake: bool, monkeypatch=None):
    """(total FLOPs, the kernels' FLOPs, argument bytes by group, the
    record's memory) of one 1x1 step."""
    kernel = [0]
    if monkeypatch is not None:
        for mod, name in PLAINS:
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, **k):
                with FlopCounterMode(display=False) as fc:
                    out = _fn(*a, **k)
                kernel[0] += fc.get_total_flops()
                return out
            monkeypatch.setattr(mod, name, counted)
    cfg = _cfg(arch)
    grid = dry_grid(1, 1)
    with (FakeTensorMode() if fake else contextlib.nullcontext()):
        torch.manual_seed(0)
        ci = specs.cell_inputs(arch, shape, grid, _rc(cfg, shape), cfg=cfg,
                               accum=ACCUM.get(arch, 1))
        res = dryrun.run_step(ci, grid)
    by_op = res["cost"]["flops_by_op"]
    if fake:
        kernel[0] = sum(v for k, v in by_op.items()
                        if k.startswith("repro_torch.") and "wkv" not in k)
    return (res["cost"]["flops"], kernel[0],
            res["memory"]["argument_parts"], res["memory"])


@pytest.mark.parametrize("arch,shape", CASES,
                         ids=[f"{a}-{s.kind}" for a, s in CASES])
def test_fake_step_counts_the_real_steps_flops_and_bytes(arch, shape,
                                                         monkeypatch):
    real, real_k, real_args, _ = _step(arch, shape, False, monkeypatch)
    fake, fake_k, fake_args, mem = _step(arch, shape, True)
    assert fake_args == real_args
    assert mem["temp_bytes"] > 0
    # everything outside the kernels: the same FLOPs exactly (rwkv6's
    # WKV loop included, through its shape-only op)
    assert fake - fake_k == real - real_k
    if get_config(arch).is_moe:
        # the kernels: every scheduled row, padding included, against the
        # plain versions' active blocks
        assert fake_k >= real_k > 0
    else:
        assert fake_k == real_k == 0


@pytest.fixture(scope="module")
def grid_runs():
    cases = [
        {"arch": "moonshot-v1-16b-a3b", "layers": 2, "accum": 1,
         "shape": dict(name="t", seq_len=32, global_batch=4, kind="train")},
        {"arch": "qwen2-7b", "layers": 2, "accum": 2,
         "shape": dict(name="t", seq_len=32, global_batch=8, kind="train")},
        {"arch": "moonshot-v1-16b-a3b", "layers": 2,
         "shape": dict(name="p", seq_len=32, global_batch=4,
                       kind="prefill")},
    ]
    return cases, spawn_ranks(W.rank_main, 4, "cpu", cases)[0]


@pytest.mark.parametrize("i", range(3))
def test_dry_grid_collectives_equal_a_real_gloo_step(grid_runs, i):
    cases, real = grid_runs
    case = cases[i]
    cfg = reduced(get_config(case["arch"]), layers=case["layers"])
    shape = ShapeConfig(**case["shape"])
    rec = dryrun.run_cell(case["arch"], shape, "2x2", cfg=cfg,
                          accum=case.get("accum"))
    assert rec["status"] == "ok", rec.get("error")
    assert rec["collectives"]["records"] == real[i]["records"]
    assert real[i]["records"], "the grid step ran no collective"
    assert rec["memory"]["argument_bytes"] == real[i]["argument_bytes"]
    if not cfg.is_moe:
        assert rec["cost"]["flops"] == real[i]["flops"]


def test_moe_step_runs_fake_to_ok():
    cfg = reduced(get_config("deepseek-v2-236b"), layers=3)
    rec = dryrun.run_cell("deepseek-v2-236b", TRAIN, "2x4", cfg=cfg,
                          accum=2)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 8 and rec["meta"]["ep"] == 4
    by_op = rec["cost"]["flops_by_op"]
    for op in ("fused_gate_up_shape", "grouped_gemm_shape",
               "grouped_gemm_t_shape", "grouped_wgrad_shape"):
        assert by_op[f"repro_torch.{op}"] > 0
    ops_seen = {(r["op"], r["g"]) for r in rec["collectives"]["records"]}
    assert ("all_to_all", 4) in ops_seen and ("all_gather", 2) in ops_seen
    assert rec["collectives"]["total_bytes"] > 0


def test_a_host_read_is_an_error_with_its_place(monkeypatch):
    """Without the shape-only path the plain B2 reads its active blocks on
    the host: the record says so and where, and fills in nothing."""
    monkeypatch.setattr(shapes, "is_fake", lambda *t: False)
    cfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=2)
    rec = dryrun.run_cell("moonshot-v1-16b-a3b", PREFILL, cfg=cfg)
    assert rec["status"] == "error"
    assert "nonzero" in rec["error"]
    assert rec["where"].startswith("repro_torch/kernels/grouped_gemm.py:")
    assert "memory" not in rec and "cost" not in rec


def test_argument_alloc_rounds_as_the_allocator():
    """Each storage once, its bytes rounded to 512 B, and a count of those
    past 1 MiB (whose unsplit remainder the allocator may keep)."""
    assert [dryrun.alloc_bytes(n) for n in (0, 1, 512, 513, 3 << 20)] == \
        [0, 512, 512, 1024, 3 << 20]
    big = torch.zeros((1 << 18) + 1)                 # 1 MiB + 4 bytes
    small = torch.zeros(3)
    parts, known, alloc = dryrun.argument_bytes(
        {"params": {"a": big, "b": big[:4], "c": small}, "opt": [small]})
    assert parts == {"params": big.nbytes + small.nbytes, "opt": 0,
                     "total": big.nbytes + small.nbytes}
    assert len(known) == 2
    assert alloc == {"params": {"tensors": 2, "large": 1,
                                "alloc_bytes": (1 << 20) + 512 + 512},
                     "opt": {"tensors": 0, "alloc_bytes": 0, "large": 0}}


def test_bytes_accessed_counts_operands_and_results():
    """Each op's operand and result bytes; a view moves nothing."""
    a, b = torch.ones((4, 4)), torch.ones((4, 4))
    with dryrun._live_bytes_mode() as live:
        c = a + b
        c.view(16)
        c.sum()
    assert live.accessed == 3 * 64 + 64 + 4


def test_encoder_cell_and_skip():
    cfg = reduced(get_config("hubert-xlarge"), layers=2)
    rec = dryrun.run_cell("hubert-xlarge", PREFILL, cfg=cfg)
    assert rec["status"] == "ok" and rec["meta"]["mode"] == "encode"
    assert rec["cost"]["flops"] > 0
    skip = dryrun.run_cell("hubert-xlarge", "decode_32k")
    assert skip["status"] == "skip" and "encoder" in skip["reason"]


# ----------------------------------------------------------------------
# The shape-only ops against the plain versions
# ----------------------------------------------------------------------
def _moe_case(T=24, E=8, k=2, d=32, f=48, block_m=8):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((T, d), generator=g)
    idx = torch.randint(0, E, (T, k), generator=g, dtype=torch.int32)
    w = torch.rand((T, k), generator=g)
    sched = build_schedule(idx, E, block_m)
    wg, wu = (torch.randn((E, d, f), generator=g) for _ in range(2))
    wd = torch.randn((E, f, d), generator=g)
    return x, idx, w, sched, wg, wu, wd


def _fake_copy(mode, tree):
    return [mode.from_tensor(t) if isinstance(t, torch.Tensor) else t
            for t in tree]


def _sched_fake(mode, sched):
    return type(sched)(*[mode.from_tensor(v) if isinstance(v, torch.Tensor)
                         else v for v in sched])


KERNEL_CALLS = {
    "router": lambda x, idx, w, s, wg, wu, wd: ops.router_topk(
        x @ torch.ones((x.shape[1], 8)), top_k=2),
    "permute": lambda x, idx, w, s, wg, wu, wd: ops.permute(x, s),
    "fused_gate_up": lambda x, idx, w, s, wg, wu, wd: ops.fused_gate_up(
        ops.permute(x, s), wg, wu, s),
    "grouped_gemm": lambda x, idx, w, s, wg, wu, wd: ops.grouped_gemm(
        ops.permute(x, s)[:, :1].expand(-1, wd.shape[1]).contiguous(), wd, s,
        row_scale=combine_scale_rows(s, w)),
    "unpermute": lambda x, idx, w, s, wg, wu, wd: ops.unpermute(
        ops.permute(x, s), s, w),
    "grouped_gemm_t": lambda x, idx, w, s, wg, wu, wd: ops.grouped_gemm_t(
        ops.permute(x, s), wd, s),
    "grouped_wgrad": lambda x, idx, w, s, wg, wu, wd: ops.grouped_wgrad(
        ops.permute(x, s), ops.permute(x, s), s, 8, torch.bfloat16),
}
EXPECTED_FLOPS = {   # capacity rows x K x N x 2 (B2: two products)
    "fused_gate_up": lambda cap: 2 * cap * 32 * 48 * 2,
    "grouped_gemm": lambda cap: 2 * cap * 48 * 32,
    "grouped_gemm_t": lambda cap: 2 * cap * 32 * 48,
    "grouped_wgrad": lambda cap: 2 * cap * 32 * 32,
}


@pytest.mark.parametrize("name", list(KERNEL_CALLS))
def test_shape_only_op_gives_the_plain_versions_shapes(name):
    case = _moe_case()
    real = KERNEL_CALLS[name](*case)
    mode = FakeTensorMode()
    x, idx, w, sched, wg, wu, wd = case
    with mode:
        fake_case = _fake_copy(mode, (x, idx, w)) + [_sched_fake(mode,
                                                                 sched)] \
            + _fake_copy(mode, (wg, wu, wd))
        with FlopCounterMode(display=False) as fc:
            out = KERNEL_CALLS[name](*fake_case)
    real_t = real if isinstance(real, tuple) else (real,)
    out_t = out if isinstance(out, tuple) else (out,)
    assert [(tuple(t.shape), t.dtype) for t in out_t] == \
        [(tuple(t.shape), t.dtype) for t in real_t]
    assert all(shapes.is_fake(t) for t in out_t)
    by_op = {str(k): v for k, v in fc.get_flop_counts()
             .get("Global", {}).items()}
    if name in EXPECTED_FLOPS:
        assert by_op[f"repro_torch.{name}_shape"] == \
            EXPECTED_FLOPS[name](sched.capacity)


@pytest.mark.parametrize("mla", [False, True])
def test_paged_attention_shape_only_op(mla):
    g = torch.Generator().manual_seed(1)
    B, Hkv, G, D, Dv, bs, nb, nblk = 2, 2, 3, 16, 16, 4, 3, 8
    D2 = 8 if mla else None
    q = torch.randn((B, Hkv, G, D), generator=g)
    k = torch.randn((nblk, bs, Hkv, D), generator=g)
    v = k if mla else torch.randn((nblk, bs, Hkv, Dv), generator=g)
    tables = torch.randint(0, nblk, (B, nb), generator=g, dtype=torch.int32)
    kw = {}
    if mla:
        kw = dict(q2=torch.randn((B, Hkv, G, D2), generator=g),
                  k2_pool=torch.randn((nblk, bs, Hkv, D2), generator=g))
    real = paged_decode_attention(q, k, v, tables, nb * bs - 1, **kw)
    mode = FakeTensorMode()
    with mode:
        fq, fk, fv, ft = _fake_copy(mode, (q, k, v, tables))
        fkw = {n: mode.from_tensor(t) for n, t in kw.items()}
        with FlopCounterMode(display=False) as fc:
            out = paged_decode_attention(fq, fk, fv, ft, nb * bs - 1, **fkw)
    assert (tuple(out.shape), out.dtype) == (tuple(real.shape), real.dtype)
    d_score = D + (D2 or 0)
    assert fc.get_total_flops() == 2 * B * Hkv * G * nb * bs * (d_score + Dv)


# ----------------------------------------------------------------------
# The variants: --quant, --capacity-factor, --variant
# ----------------------------------------------------------------------
def _stored_bytes(model) -> int:
    return sum(t.untyped_storage().nbytes()
               for t in list(model.parameters()) + list(model.buffers()))


@pytest.mark.parametrize("scheme", ["int8_expert", "int4_packed"])
def test_quantized_decode_cell_holds_the_quantized_models_bytes(scheme):
    """A decode cell under ``quant``: the fake parameters are quantized as
    the engine quantizes at load, so their bytes are a real CPU model's
    after ``quantize_model``; B1 and B2 take the payload and count the
    dense product's FLOPs over the same schedule."""
    from repro_torch.models.lm import init_params
    from repro_torch.quantization import quantize_model
    cfg = _cfg("moonshot-v1-16b-a3b")
    dense = dryrun.run_cell("moonshot-v1-16b-a3b", DECODE, cfg=cfg)
    rec = dryrun.run_cell("moonshot-v1-16b-a3b", DECODE, cfg=cfg,
                          quant=scheme)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["quant"] == rec["meta"]["quant"] == scheme
    real = quantize_model(init_params(cfg, 0, param_dtype=torch.bfloat16,
                                      device="cpu"), scheme)
    assert rec["memory"]["argument_parts"]["params"] == _stored_bytes(real)
    assert rec["memory"]["argument_parts"]["params"] \
        < dense["memory"]["argument_parts"]["params"]
    assert rec["cost"]["flops"] == dense["cost"]["flops"]
    for op in ("grouped_gemm_shape", "fused_gate_up_shape"):
        assert rec["cost"]["flops_by_op"][f"repro_torch.{op}"] > 0


def test_quantized_shape_ops_check_the_payload():
    """The shape-only B1 takes an int4 payload of K/2 rows and its scales,
    and refuses a payload that does not fit the rows."""
    mode = FakeTensorMode()
    with mode:
        x = torch.empty((16, 32), dtype=torch.bfloat16)
        w4 = torch.empty((4, 16, 24), dtype=torch.int8)
        s = torch.empty((4, 24))
        assert shapes.grouped_gemm_shape(x, w4, s, "int4").shape == (16, 24)
        with pytest.raises(ValueError, match="int8 weights"):
            shapes.grouped_gemm_shape(x, w4, s, "int8")
        with pytest.raises(ValueError, match="need their"):
            shapes.grouped_gemm_shape(x, w4, None, "int4")


def test_quant_train_cell_is_skip():
    cfg = _cfg("moonshot-v1-16b-a3b")
    rec = dryrun.run_cell("moonshot-v1-16b-a3b", TRAIN, cfg=cfg,
                          quant="int8_expert")
    assert rec["status"] == "skip"
    assert "trains no quantized experts" in rec["reason"]


def test_capacity_factor_moves_dispatch_flops_as_cell_cost_predicts():
    """The ``capacity_factor`` policy at 1.0 and 2.0 on a prefill of 1024
    tokens (reduced moonshot: E 8, top-2, blocks of 8, so every expert's
    capacity is 256 or 512 rows, tile-aligned and past cell_cost's floor
    of 128): the fake step's FLOPs move by exactly what ``cell_cost``'s
    static-capacity padding term moves by."""
    from repro_torch.analysis.flops import cell_cost
    cfg = _cfg("moonshot-v1-16b-a3b")
    shape = ShapeConfig("prefill_1k", 1024, 1, "prefill")
    got, want = {}, {}
    for cf in (1.0, 2.0):
        rec = dryrun.run_cell("moonshot-v1-16b-a3b", shape, cfg=cfg,
                              capacity_factor=cf)
        assert rec["status"] == "ok", rec.get("error")
        assert rec["capacity_factor"] == cf
        got[cf] = rec["cost"]["flops"]
        want[cf] = cell_cost(cfg, shape, chips=1, ep=1,
                             capacity_factor=cf).dispatch_flops
    assert got[2.0] - got[1.0] == want[2.0] - want[1.0] > 0


def test_variant_flags_tag_the_record_and_its_file(tmp_path, monkeypatch):
    """``--variant`` goes into the record and the file name; ``--quant``
    (``--quant-experts`` its alias) makes a train cell ``skip``."""
    import json
    import sys
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "qwen2-7b", "--shape", "train_4k",
        "--quant-experts", "--variant", "int8", "--out", str(tmp_path)])
    with pytest.warns(DeprecationWarning):
        assert dryrun.main() == 0
    path = tmp_path / "qwen2-7b.train_4k.1x1.int8.json"
    rec = json.loads(path.read_text())
    assert rec["variant"] == "int8" and rec["quant"] == "int8_expert"
    assert rec["status"] == "skip"
    assert dryrun.cell_file("a", "s", "2x4") == "a.s.2x4.json"


@pytest.mark.parametrize("scheme", ["int8_expert", "int8_channel",
                                    "int4_packed"])
def test_quantize_model_runs_on_fake_tensors(scheme):
    """``quantize_model`` under ``FakeTensorMode``: the fake model's routed
    experts are ``QuantTensor``s whose payloads and scales have a real
    quantized model's shapes and dtypes."""
    from repro_torch.models.lm import init_params
    from repro_torch.quantization import QuantTensor, quantize_model
    cfg = _cfg("moonshot-v1-16b-a3b")
    real = quantize_model(init_params(cfg, 0, param_dtype=torch.bfloat16,
                                      device="cpu"), scheme)
    with FakeTensorMode():
        fake = quantize_model(init_params(cfg, 0, param_dtype=torch.bfloat16,
                                          device="cpu"), scheme)
    want = {n: (tuple(t.shape), t.dtype) for n, t in real.named_buffers()}
    got = {n: (tuple(t.shape), t.dtype) for n, t in fake.named_buffers()}
    assert got == want and len(got) == 6
    assert all(shapes.is_fake(t) for _, t in fake.named_buffers())
    w = fake.layers[1].moe.expert_weight("w_gate")
    assert isinstance(w, QuantTensor) and w.scheme == scheme
    assert w.shape == real.layers[1].moe.expert_weight("w_gate").shape
