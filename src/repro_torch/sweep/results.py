"""Sweep results (``repro.sweep.results``): seed-axis reduction (mean /
confidence interval) and the versioned JSON/CSV artifacts under
``experiments/``.

Metric arrays come back from the runner shaped ``(*axis_lens, n_seeds,
*per_run)`` per static-point label. The reduction collapses the seed axis to
(mean, CI half-width) using a two-sided Student-t interval (small-seed-count
correct; normal fallback above the tabulated dfs), matching how the
seed-averaged curves in Xu et al. / Khodadadian et al. style figures are
reported.

Artifacts are versioned: the JSON payload carries ``schema_version`` and
``save()`` never overwrites — it allocates ``<name>.v<N>.json`` / ``.csv``
with the next free N, so a sweep's history accumulates in ``experiments/``.
The schema and keys are the JAX package's, letter for letter; the port's
files are named ``torch_<name>`` (``save`` adds the prefix), so they sit
beside the JAX package's artifacts and never replace one.
"""
from __future__ import annotations

import csv
import dataclasses
import itertools
import json
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

SCHEMA_VERSION = 1
PREFIX = "torch_"

# Two-sided Student-t critical values, df 1..30 (beyond: normal quantile).
_T_TABLE = {
    0.90: (6.314, 2.920, 2.353, 2.132, 2.015, 1.943, 1.895, 1.860, 1.833,
           1.812, 1.796, 1.782, 1.771, 1.761, 1.753, 1.746, 1.740, 1.734,
           1.729, 1.725, 1.721, 1.717, 1.714, 1.711, 1.708, 1.706, 1.703,
           1.701, 1.699, 1.697),
    0.95: (12.706, 4.303, 3.182, 2.776, 2.571, 2.447, 2.365, 2.306, 2.262,
           2.228, 2.201, 2.179, 2.160, 2.145, 2.131, 2.120, 2.110, 2.101,
           2.093, 2.086, 2.080, 2.074, 2.069, 2.064, 2.060, 2.056, 2.052,
           2.048, 2.045, 2.042),
    0.99: (63.657, 9.925, 5.841, 4.604, 4.032, 3.707, 3.499, 3.355, 3.250,
           3.169, 3.106, 3.055, 3.012, 2.977, 2.947, 2.921, 2.898, 2.878,
           2.861, 2.845, 2.831, 2.819, 2.807, 2.797, 2.787, 2.779, 2.771,
           2.763, 2.756, 2.750),
}
_Z = {0.90: 1.645, 0.95: 1.960, 0.99: 2.576}


def t_critical(df: int, confidence: float = 0.95) -> float:
    """Two-sided Student-t critical value (tabulated 0.90/0.95/0.99)."""
    if confidence not in _T_TABLE:
        raise ValueError(
            f"confidence must be one of {sorted(_T_TABLE)}, got {confidence}"
        )
    if df < 1:
        raise ValueError("need df >= 1 (at least two seeds) for a CI")
    table = _T_TABLE[confidence]
    return table[df - 1] if df <= len(table) else _Z[confidence]


def mean_ci(
    arr: np.ndarray, axis: int, confidence: float = 0.95
) -> Tuple[np.ndarray, np.ndarray]:
    """Mean and CI half-width over one axis (t-interval; zero hw for n=1)."""
    arr = np.asarray(arr)
    n = arr.shape[axis]
    mean = arr.mean(axis=axis)
    if n < 2:
        return mean, np.zeros_like(mean)
    sd = arr.std(axis=axis, ddof=1)
    hw = t_critical(n - 1, confidence) * sd / math.sqrt(n)
    return mean, hw


def _next_version(out_dir: str, name: str) -> int:
    v = 1
    while os.path.exists(os.path.join(out_dir, f"{name}.v{v}.json")):
        v += 1
    return v


@dataclasses.dataclass
class SweepResult:
    """Raw per-run metric arrays for every static point, plus sweep metadata.

    ``metrics[label][metric]`` has shape ``(*axis_lens, n_seeds, *per_run)``
    (per_run is usually the per-epoch curve). ``wall_s[label]`` is the
    end-to-end wall-clock of that static point's batched run and
    ``compile_s[label]`` its untimed warm-up call (there is no compile step
    in eager PyTorch); ``mode`` records whether the grid ran batched
    (``"vmapped"``, JAX's name for it) or as a Python loop.
    """

    name: str
    axes: Dict[str, List[float]]
    seeds: List[int]
    metrics: Dict[str, Dict[str, np.ndarray]]
    wall_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    compile_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    mode: str = "vmapped"
    meta: Dict = dataclasses.field(default_factory=dict)

    @property
    def labels(self) -> List[str]:
        return list(self.metrics)

    @property
    def seed_axis(self) -> int:
        return len(self.axes)

    def seed_mean_ci(
        self, label: str, metric: str, confidence: float = 0.95
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(mean, CI half-width) over seeds: shape ``(*axis_lens, *per_run)``."""
        return mean_ci(self.metrics[label][metric], self.seed_axis, confidence)

    def summary(self, confidence: float = 0.95) -> dict:
        """JSON-ready payload: seed-reduced curves per label/metric."""
        labels = {}
        for label, md in self.metrics.items():
            entry = {}
            for metric, arr in md.items():
                mean, hw = mean_ci(arr, self.seed_axis, confidence)
                entry[metric] = {
                    "mean": mean.tolist(),
                    "ci_hw": hw.tolist(),
                }
            labels[label] = entry
        return {
            "schema_version": SCHEMA_VERSION,
            "name": self.name,
            "mode": self.mode,
            "confidence": confidence,
            "axes": self.axes,
            "seeds": list(self.seeds),
            "n_seeds": len(self.seeds),
            "wall_s": dict(self.wall_s),
            "compile_s": dict(self.compile_s),
            "meta": dict(self.meta),
            "labels": labels,
        }

    def rows(self, confidence: float = 0.95) -> List[dict]:
        """Long-format rows (one per grid cell x curve step) for CSV output."""
        axis_names = list(self.axes)
        out = []
        for label, md in self.metrics.items():
            for metric, arr in md.items():
                mean, hw = mean_ci(arr, self.seed_axis, confidence)
                lead = mean.shape[: len(axis_names)]
                trail = mean.shape[len(axis_names):]
                for idx in itertools.product(*(range(s) for s in lead)):
                    coords = {}
                    for n, i in zip(axis_names, idx):
                        val = self.axes[n][i]
                        if isinstance(val, (tuple, list)):
                            # vector-valued point (e.g. a tau_i schedule):
                            # one compact CSV cell instead of a raw tuple
                            val = "[" + ",".join(f"{x:g}" for x in val) + "]"
                        coords[n] = val
                    m_curve = mean[idx].reshape(trail)
                    h_curve = hw[idx].reshape(trail)
                    if m_curve.ndim == 0:
                        m_curve, h_curve = m_curve[None], h_curve[None]
                    flat_m = np.asarray(m_curve).reshape(-1)
                    flat_h = np.asarray(h_curve).reshape(-1)
                    for step, (mv, hv) in enumerate(zip(flat_m, flat_h)):
                        out.append({
                            "label": label,
                            **coords,
                            "metric": metric,
                            "step": step,
                            "mean": float(mv),
                            "ci_hw": float(hv),
                            "n_seeds": len(self.seeds),
                        })
        return out

    @property
    def file_name(self) -> str:
        """The artifacts' base name: ``name`` with the ``torch_`` prefix."""
        return self.name if self.name.startswith(PREFIX) else PREFIX + self.name

    def save(
        self,
        out_dir: str = "experiments/sweeps",
        confidence: float = 0.95,
        version: Optional[int] = None,
    ) -> Tuple[str, str]:
        """Write versioned ``torch_<name>.v<N>.json`` + ``.csv``; returns the
        paths. An existing version is never overwritten."""
        os.makedirs(out_dir, exist_ok=True)
        name = self.file_name
        v = version if version is not None else _next_version(out_dir, name)
        jpath = os.path.join(out_dir, f"{name}.v{v}.json")
        cpath = os.path.join(out_dir, f"{name}.v{v}.csv")
        if os.path.exists(jpath) or os.path.exists(cpath):
            raise FileExistsError(f"SweepResult.save: {jpath} exists")
        payload = self.summary(confidence)
        payload["version"] = v
        with open(jpath, "w") as f:
            json.dump(payload, f, indent=2)
        rows = self.rows(confidence)
        if rows:
            fields = list(rows[0].keys())
            with open(cpath, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=fields)
                w.writeheader()
                w.writerows(rows)
        return jpath, cpath
