"""The port stands alone: no JAX and nothing of the JAX package.

The machine with the card has no JAX, so ``src/repro_torch/``,
``chip_smoke.py``, the port's benches (``benchmarks/torch_*.py``) and its
examples (``examples/torch_*.py``) must import neither ``jax`` nor
``repro`` (``repro_torch`` is fine), and the benches not the JAX benches'
``benchmarks.common`` (whose ``time_us`` imports JAX). Checked twice: by
importing every module of the port, every port bench and every port example
in a fresh interpreter and inspecting ``sys.modules``, and by scanning the
sources. The port's quickstart also runs here, on the CPU, and its table
keeps the orderings the paper's theory predicts.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
BENCHES = sorted((ROOT / "benchmarks").glob("torch_*.py"))
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
SOURCES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + BENCHES
           + EXAMPLES)

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
                "configs.phi4_mini_3_8b", "models.attention", "sweep",
                "sweep.results", "sweep.spec", "sweep.overrides",
                "sweep.runner", "rl.scenarios", "core.fmarl", "core.bounds",
                "core.extensions", "kernels.ops", "utils", "utils.pytree",
                "data", "data.pipeline", "optim.optimizers",
                "optim.schedules", "launch.fedtrain", "launch.train",
                "kernels.swa_attention_bwd", "models.moe",
                "configs.kimi_k2_1t", "configs.arctic_480b"):
        assert f"repro_torch.{mod}" in names, mod
    benches = [f"benchmarks.{p.stem}" for p in BENCHES]
    for stem in ("torch_common", "torch_fmarl_bench", "torch_table2",
                 "torch_fig4_variation", "torch_fig5_decay",
                 "torch_fig6_consensus", "torch_bounds_bench"):
        assert f"benchmarks.{stem}" in benches, stem
    examples = [f"examples.{p.stem}" for p in EXAMPLES]
    assert "examples.torch_quickstart" in examples
    code = (
        "import importlib, sys\n"
        f"for name in {names + benches + examples!r}:\n"
        "    importlib.import_module(name)\n"
        "assert 'benchmarks.common' not in sys.modules\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'\n"
        "             or m.startswith('jaxlib.') or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_names_no_jax_and_no_repro(path):
    text = path.read_text()
    hits = _FORBIDDEN.findall(text)
    if path in BENCHES:
        hits += _BENCH_COMMON.findall(text)
    assert not hits, f"{path.relative_to(ROOT)}: {hits}"


_BENCH_COMMON = re.compile(
    r"^\s*(?:from\s+benchmarks(?:\.common\b|\s+import\s+common\b)"
    r"|import\s+benchmarks\.common\b)", re.MULTILINE)


def test_the_scan_catches_what_it_should():
    bad = ["import jax", "import jax.numpy as jnp", "from jax import lax",
           "from repro.serve import ServeEngine", "import repro.kernels",
           "  from repro import x", "importlib.import_module('repro.rl')"]
    good = ["import repro_torch", "from repro_torch.serve import ServeEngine",
            "# the JAX package repro.serve", "x = 'jax'"]
    assert all(_FORBIDDEN.search(s) for s in bad)
    assert not any(_FORBIDDEN.search(s) for s in good)
    assert all(_BENCH_COMMON.search(s) for s in (
        "from benchmarks.common import emit", "import benchmarks.common",
        "from benchmarks import common"))
    assert not any(_BENCH_COMMON.search(s) for s in (
        "from benchmarks.torch_common import emit",
        "from benchmarks import torch_common"))


def test_quickstart_runs_on_the_cpu_with_the_papers_orderings():
    """``examples/torch_quickstart.py --device cpu``: every strategy's row,
    the ledger's events (config-only: JAX's quickstart prints the same) and
    the orderings of ``tests/test_system.py`` and the bounds. Decay ends
    below periodic; consensus at most at periodic's value (a doubly
    stochastic gossip keeps the agents' mean, so on this quadratic the
    server follows periodic's path up to rounding: JAX's quickstart prints
    one value for both); variation-aware above it (its agents take fewer
    steps); T5 < T2 < T1."""
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}"}
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_quickstart.py"),
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    rows = {}
    for line in res.stdout.splitlines():
        m = re.match(r"^(\S.*?)\s+([0-9.]+)\s+(\d+)\s+(\d+)$", line)
        if m:
            rows[m.group(1)] = (float(m.group(2)), int(m.group(3)),
                                int(m.group(4)))
    assert set(rows) == {"sync (tau=1)", "periodic", "variation-aware",
                         "decay (lam=0.9)", "consensus (E=2)"}, res.stdout
    final = {k: v[0] for k, v in rows.items()}
    assert all(0.0 < v < 1.0 for v in final.values())
    assert final["decay (lam=0.9)"] < final["periodic"]
    assert final["consensus (E=2)"] <= final["periodic"] * (1 + 1e-3)
    assert final["variation-aware"] > final["periodic"]
    assert rows["sync (tau=1)"][1:] == (2240, 0)
    assert rows["periodic"][1:] == (280, 0)
    assert rows["consensus (E=2)"][1:] == (280, 16640)
    bounds = [float(x) for x in re.findall(r"T\d [^:]*: ([0-9.]+)",
                                            res.stdout)]
    assert len(bounds) == 3 and bounds[2] < bounds[1] < bounds[0]
