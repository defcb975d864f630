"""Import isolation: the port imports neither JAX nor the JAX package.

A subprocess imports every module of ``repro_torch`` and checks that
``jax`` and every ``repro`` / ``repro.*`` module stay out of
``sys.modules``; a static scan checks the port's sources and
``chip_smoke.py`` and the port's examples (``examples/torch``) for such
imports (whole module names, so ``repro_torch``
passes)."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|,|$)"
    r"|from\s+repro(\.|\s))", re.M)

PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
assert {"repro_torch.obs", "repro_torch.obs.trace",
        "repro_torch.serve.admission", "repro_torch.distributed",
        "repro_torch.distributed.group", "repro_torch.core.distributed",
        "repro_torch.serve.distributed",
        "repro_torch.launch.mp_serve_smoke",
        "repro_torch.distributed.sharding",
        "repro_torch.distributed.ctx"} <= set(names), names
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
"""


def test_importing_every_port_module_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 25, out.stdout


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + [p.relative_to(ROOT).as_posix()
       for p in (ROOT / "examples" / "torch").glob("*.py")]
    + ["chip_smoke.py"]))
def test_source_has_no_jax_or_reference_import(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.search(text), FORBIDDEN.search(text).group(0)


@pytest.mark.parametrize("module", [
    "repro_torch.distributed", "repro_torch.core.distributed",
    "repro_torch.serve.distributed", "repro_torch.distributed.sharding",
    "repro_torch.distributed.ctx", "repro_torch.distributed.group"])
def test_ep_module_alone_loads_no_jax_and_no_reference(module):
    """Each expert-parallel module, imported first and alone."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    probe = (f"import sys, {module}\n"
             "bad = sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith('jax.') or m == 'repro' or "
             "m.startswith('repro.'))\n"
             "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout


def test_scan_catches_what_it_must():
    for bad in ("import jax", "from jax import numpy", "import repro.kernels",
                "from repro.kernels import ops", "from repro import x",
                "import repro"):
        assert FORBIDDEN.search(bad), bad
    for good in ("import repro_torch", "from repro_torch.kernels import ops",
                 "import jaxlib_like_name_in_text = 1"):
        assert not FORBIDDEN.search(good), good
