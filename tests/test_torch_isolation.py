"""The port stands alone: no JAX and nothing of the JAX package.

The machine with the card has no JAX, so ``src/repro_torch/`` and
``chip_smoke.py`` must import neither ``jax`` nor ``repro`` (``repro_torch``
is fine). Checked twice: by importing every module of the port in a fresh
interpreter and inspecting ``sys.modules``, and by scanning the sources.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_FORBIDDEN = re.compile(
    r"^\s*(?:import\s+(?:jax|repro)\b(?!_)|from\s+(?:jax|repro)\b(?!_))"
    r"|(?:import_module|__import__)\(\s*['\"](?:jax|repro)\b(?!_)",
    re.MULTILINE,
)


def _module_names():
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    names = list(_module_names())
    for mod in ("kernels.policy_infer", "kernels.decay_accum",
                "kernels.flat_update", "kernels.dispatch", "optim.flat",
                "core.variation", "core.decay", "core.accounting",
                "core.strategies", "rl.env", "rl.policy", "rl.ppo",
                "rl.rollout", "rl.draws", "rl.fedrl", "core.topology",
                "core.consensus", "comm", "comm.transforms",
                "kernels.consensus_step", "kernels.consensus_gather",
                "kernels.topk_scatter", "kernels.wkv6", "configs",
                "configs.base", "configs.rwkv6_1_6b", "models",
                "models.layers", "models.rwkv6", "models.transformer",
                "launch", "launch.serve", "launch.serving_loop",
                "kernels.swa_attention", "configs.h2o_danube3_4b",
                "configs.phi4_mini_3_8b", "models.attention"):
        assert f"repro_torch.{mod}" in names, mod
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'\n"
        "             or m.startswith('jaxlib.') or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_names_no_jax_and_no_repro(path):
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path.relative_to(ROOT)}: {hits}"


def test_the_scan_catches_what_it_should():
    bad = ["import jax", "import jax.numpy as jnp", "from jax import lax",
           "from repro.serve import ServeEngine", "import repro.kernels",
           "  from repro import x", "importlib.import_module('repro.rl')"]
    good = ["import repro_torch", "from repro_torch.serve import ServeEngine",
            "# the JAX package repro.serve", "x = 'jax'"]
    assert all(_FORBIDDEN.search(s) for s in bad)
    assert not any(_FORBIDDEN.search(s) for s in good)
