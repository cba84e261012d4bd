"""The statistical reproduction of Figs. 4-6: the port's figure CSVs against
the JAX package's committed ones.

  python benchmarks/torch_fig_parity.py [--bench-dir experiments/bench]

For each figure (``fig4_variation``, ``fig5_decay``, ``fig6_consensus``),
each (config, epoch) row and each of ``nas`` and ``grad_norm``, the rule
stated before the port's runs: the port's seed mean lies within the JAX
seed mean's 95% half-width plus the port's own,

    |port mean - JAX mean| <= JAX ci_hw + port ci_hw,

and at least 95% of these comparisons must hold; every ``bytes`` entry must
equal JAX's. Prints the share that held, every failing row with its values,
and a last JSON line ``{"share": ..., "holds": ..., "bytes_equal": ...}``;
exits 1 when the rule does not hold.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import sys

FIGS = ("fig4_variation", "fig5_decay", "fig6_consensus")
METRICS = ("nas", "grad_norm")
SHARE = 0.95


def _rows(path):
    with open(path, newline="") as f:
        return {(r["config"], int(r["epoch"])): r for r in csv.DictReader(f)}


def compare(bench_dir: str = "experiments/bench") -> dict:
    """The rule's comparisons over the three figures."""
    checks, failing, bytes_equal = 0, [], True
    for fig in FIGS:
        jax_rows = _rows(os.path.join(bench_dir, f"{fig}.csv"))
        port_rows = _rows(os.path.join(bench_dir, f"torch_{fig}.csv"))
        if set(jax_rows) != set(port_rows):
            raise SystemExit(f"{fig}: the (config, epoch) rows differ")
        for key in sorted(jax_rows):
            j, p = jax_rows[key], port_rows[key]
            if "bytes" in j and float(j["bytes"]) != float(p["bytes"]):
                bytes_equal = False
                failing.append({"fig": fig, "config": key[0],
                                "epoch": key[1], "metric": "bytes",
                                "jax": float(j["bytes"]),
                                "port": float(p["bytes"])})
            for mname in METRICS:
                jm, jh = float(j[mname]), float(j[f"{mname}_ci_hw"])
                pm, ph = float(p[mname]), float(p[f"{mname}_ci_hw"])
                checks += 1
                if abs(pm - jm) > jh + ph:
                    failing.append({"fig": fig, "config": key[0],
                                    "epoch": key[1], "metric": mname,
                                    "jax": jm, "jax_ci_hw": jh, "port": pm,
                                    "port_ci_hw": ph,
                                    "gap": abs(pm - jm) - (jh + ph)})
    failed = sum(1 for f in failing if f["metric"] != "bytes")
    share = (checks - failed) / checks
    return {"comparisons": checks, "held": checks - failed, "share": share,
            "holds": share >= SHARE and bytes_equal,
            "bytes_equal": bytes_equal, "failing": failing}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench-dir", default="experiments/bench")
    out = compare(ap.parse_args().bench_dir)
    for f in out["failing"]:
        print(json.dumps(f))
    print(f"{out['held']} of {out['comparisons']} comparisons hold "
          f"(share {out['share']:.4f}, rule >= {SHARE}); bytes equal: "
          f"{out['bytes_equal']}")
    print(json.dumps({k: out[k] for k in ("share", "holds", "bytes_equal",
                                          "comparisons", "held")}))
    return 0 if out["holds"] else 1


if __name__ == "__main__":
    sys.exit(main())
