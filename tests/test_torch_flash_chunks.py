"""``flash_attention``'s fp32 working set and the serving engine's attention
chunks, on the CPU.

* ``flash_attention`` casts a query chunk, and a KV chunk of k and v, to
  fp32 as its loops reach them: under ``TorchDispatchMode`` one bf16 call
  allocates no fp32 tensor larger than one chunk's working set (the whole
  q in fp32 is 6x that here), and its output stays within ``FLASH_TOL`` of
  the reference's ``flash_attention`` on the same inputs.
* The port's engine and serve launcher run ``RunConfig``'s attention
  chunks of 512 positions, the reference's engine 64 (a difference by
  design, ROADMAP "Differences by design"): both defaults are pinned, and
  on a prompt of 256 tokens (4 of the reference's chunks, one of the
  port's) the port's contiguous prefill logits are within 1e-4 of the
  reference engine's."""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models.attention import flash_attention as jax_flash  # noqa: E402
from repro.models.lm import forward as jax_forward  # noqa: E402
from repro.models.lm import init_cache as jax_init_cache  # noqa: E402
from repro.models.lm import init_params as jax_init_params  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config, reduced
from repro_torch.launch.op_count import VIEWS
from repro_torch.launch.serve import main as serve_main
from repro_torch.models.attention import flash_attention
from repro_torch.models.lm import RunConfig, forward, init_cache
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import ServeEngine
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

BF16_TOL = dict(rtol=2e-2, atol=2e-2)      # test_torch_dense.FLASH_TOL
TOL = dict(rtol=1e-4, atol=1e-4)
LONG_PROMPT = 256


class Fp32Allocations(TorchDispatchMode):
    """The element counts of the fp32 tensors each non-view operation
    returns."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if str(func.overloadpacket) not in VIEWS:
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                    self.sizes.append(t.numel())
        return out


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_call_allocates_one_chunk_of_fp32_at_a_time(causal):
    B, S, Hq, Hkv, D, Dv, chunk = 1, 512, 8, 2, 48, 32, 64
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, Dv)))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    rec = Fp32Allocations()
    with torch.no_grad(), rec:
        out = flash_attention(tq, tk, tv, causal=causal, q_chunk=chunk,
                              kv_chunk=chunk)
    # a chunk's scores (B, Hq, chunk, chunk), its q (B, Hq, chunk, D) and
    # acc (B, Hq, chunk, Dv), a KV chunk of k or v
    one_chunk = B * Hq * chunk * max(chunk, D, Dv)
    assert max(rec.sizes) <= one_chunk < B * S * Hq * D
    want = jax_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                     causal=causal, q_chunk=chunk, kv_chunk=chunk)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(
        out.float(), torch.from_numpy(np.asarray(want, np.float32)),
        **BF16_TOL)


def test_engine_and_launcher_chunk_defaults(monkeypatch):
    cfg = reduced(get_config("qwen2-7b"), d_model=32, vocab=128)
    jcfg = jax_reduced(jax_get_config("qwen2-7b"), d_model=32, vocab=128)
    params = jax_init_params(jcfg, jax.random.key(0))
    jeng = JaxServeEngine(jcfg, params, slots=1, capacity=8)
    assert (jeng.rc.q_chunk, jeng.rc.kv_chunk) == (64, 64)
    model = from_jax_params(cfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    eng = ServeEngine(cfg, model, slots=1, capacity=8, device="cpu")
    assert (eng.rc.q_chunk, eng.rc.kv_chunk) == (512, 512)
    seen = []

    class Stop(Exception):
        pass

    def capture(self, cfg, model, **kw):
        seen.append(kw["rc"])
        raise Stop
    monkeypatch.setattr(engine_mod.ServeEngine, "__init__", capture)
    with pytest.raises(Stop):
        serve_main(["--arch", "qwen2-7b", "--reduce", "--device", "cpu"])
    assert (seen[0].q_chunk, seen[0].kv_chunk) == (512, 512)


def test_long_prompt_prefill_matches_reference_engine_chunks():
    """At 256 tokens the reference engine's chunks of 64 run 10 chunk
    pairs a layer, the port's chunks of 512 one: the sums differ in order
    only."""
    cfg = reduced(get_config("qwen2-7b"), d_model=32, vocab=128)
    jcfg = jax_reduced(jax_get_config("qwen2-7b"), d_model=32, vocab=128)
    params = jax_init_params(jcfg, jax.random.key(1))
    model = from_jax_params(cfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    cap = LONG_PROMPT + 1
    jrc = JaxServeEngine(jcfg, params, slots=1, capacity=cap).rc
    rc = ServeEngine(cfg, model, slots=1, capacity=cap, device="cpu").rc
    assert LONG_PROMPT > 3 * jrc.q_chunk and rc == RunConfig(
        schedule_policy="dynamic", moe_stats=True)
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, LONG_PROMPT)).astype(np.int32)
    want, _, _ = jax.jit(jax_forward, static_argnames=("cfg", "rc", "mode"))(
        params, cfg=jcfg, rc=jrc, batch={"tokens": jnp.asarray(prompt)},
        mode="prefill", cache=jax_init_cache(jcfg, 1, cap))
    got, _, _ = forward(model, cfg, rc,
                        {"tokens": torch.from_numpy(prompt).long()},
                        mode="prefill",
                        cache=init_cache(cfg, 1, cap, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
