"""The port's examples (``examples/torch/*.py``): each runs with
``--device cpu`` at a reduced size, and without it, where there is no
CUDA, refuses to run.  The skew study's draws and schedules are the
reference's at the same key (``repro_torch.sampling.skew`` against
``benchmarks/common.py``'s ``jax.random.choice``)."""
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples" / "torch"
# each example's reduced arguments for the CPU run
SMALL = {
    "quickstart": ["--tokens", "64"],
    "serve_moe": ["--requests", "4"],
    "train_lm": ["--steps", "3"],
    "observability": ["--requests", "3"],
    "streaming_serve": ["--trace-requests", "6"],
    "skew_study": ["--tokens", "128"],
}


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_example_is_tested():
    assert sorted(p.stem for p in EXAMPLES.glob("*.py")) == sorted(SMALL)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_example_runs_on_the_cpu(name, tmp_path, capsys):
    argv = SMALL[name] + ["--device", "cpu"]
    if name == "train_lm":
        argv += ["--ckpt-dir", str(tmp_path / "ckpt")]
    _load(name).main(argv)
    out = capsys.readouterr().out
    assert "on cpu" in out
    if name not in ("train_lm", "skew_study"):
        assert "OK" in out


@pytest.mark.parametrize("name", sorted(SMALL))
def test_example_refuses_without_cuda(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    argv = SMALL[name] + (["--ckpt-dir", str(tmp_path / "c")]
                          if name == "train_lm" else [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _load(name).main(argv)


def test_train_lm_resumes(tmp_path, capsys):
    mod = _load("train_lm")
    ck = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError):
        mod.main(["--steps", "4", "--fail-at", "3", "--ckpt-dir", ck,
                  "--device", "cpu"])
    capsys.readouterr()
    mod.main(["--steps", "4", "--resume", "--ckpt-dir", ck, "--device",
              "cpu"])
    assert "resumed_from=" in capsys.readouterr().out


ZIPF = [(seed, T, k, E, alpha) for seed in (0, 3)
        for T, k, E in ((512, 2, 8), (512, 4, 64), (96, 8, 256))
        for alpha in (0.0, 1.2, 2.0)]


@pytest.mark.parametrize("seed,T,k,E,alpha", ZIPF)
def test_zipf_draws_equal_reference(seed, T, k, E, alpha):
    jax = pytest.importorskip("jax")
    sys.path.insert(0, str(ROOT))
    from benchmarks.common import zipf_assignments as ref_zipf
    from repro_torch.sampling.skew import zipf_assignments
    rw, ri = ref_zipf(jax.random.key(seed), T, k, E, alpha)
    w, i = zipf_assignments(seed, T, k, E, alpha)
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(w.numpy(), np.asarray(rw))


def test_skew_study_schedules_equal_reference():
    jax = pytest.importorskip("jax")
    sys.path.insert(0, str(ROOT))
    from benchmarks.common import zipf_assignments as ref_zipf
    from repro.configs.paper import PAPER_CONFIGS
    from repro.scheduling import build_schedule, schedule_stats
    T = 128
    study = _load("skew_study").study(T, "cpu")
    for (name, dist), stats in study.items():
        pc = PAPER_CONFIGS[name]
        E, k = pc.n_experts, pc.top_k
        block_m = min(128, max(8, T * k // E))
        alpha = dict(_load("skew_study").DISTS)[dist]
        _, idx = ref_zipf(jax.random.key(3), T, k, E, alpha)
        for policy, kw in _load("skew_study").POLICIES:
            ref = schedule_stats(build_schedule(idx, E, block_m,
                                                policy=policy, **kw))
            got = stats[policy]
            for f in ("useful_rows", "dropped_rows", "padded_rows",
                      "n_blocks_active"):
                assert int(getattr(got, f)) == int(getattr(ref, f)), \
                    (name, dist, policy, f)
            for f in ("pad_waste", "occupancy", "drop_fraction",
                      "top1_share"):
                assert float(getattr(got, f)) == pytest.approx(
                    float(getattr(ref, f)), rel=1e-6), (name, dist, f)
