"""Full statistical-equivalence run: BASELINE config 1.

ER(n=1000, p=0.1), 20 seeds: sequential reference-semantics chain vs the
device-parallel chain, compared on outcome metrics (used colors,
iterations-to-converge, balance index, class-size std) — the match
criterion of BASELINE.md ("within Monte-Carlo error").

Usage: python scripts/validate_stats.py [--seeds N] [--out report.json]
Runs on whatever the default JAX backend is (CPU fine).
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mcmc_colorer_tpu.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu.graph.generate import erdos_renyi
from mcmc_colorer_tpu.models.base import check_coloring
from mcmc_colorer_tpu.models.mcmc import MCMCColorer
from mcmc_colorer_tpu.models.mcmc_sequential import SequentialMCMCColorer


def summarize(rows):
    arr = {k: np.array([r[k] for r in rows], dtype=float) for k in rows[0]}
    return {
        k: {"mean": float(v.mean()), "std": float(v.std())}
        for k, v in arr.items()
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--p", type=float, default=0.1)
    ap.add_argument("--out", default="validate_stats.json")
    args = ap.parse_args()

    g = erdos_renyi(args.n, args.p, seed=777)
    params = MCMCParams(
        n_colors=g.max_degree, proposal=ProposalKind.STANDARD
    )
    print(
        f"graph n={g.n} m={g.n_edges} maxdeg={g.max_degree} "
        f"nCol={params.n_colors}",
        flush=True,
    )

    def run(factory, label):
        rows = []
        for s in range(args.seeds):
            r = factory().run(seed=1000 + s)
            ok = check_coloring(g, r.colors)
            rows.append(
                {
                    "used_colors": r.used_colors,
                    "iterations": r.iterations,
                    "balance_index": r.balance_index(args.p),
                    "class_std": r.class_stats()["std"],
                    "converged": float(r.converged),
                    "valid": float(ok),
                }
            )
            print(f"{label} seed {s}: {rows[-1]}", flush=True)
        return rows

    seq = run(lambda: SequentialMCMCColorer(g, params), "seq")
    par = run(lambda: MCMCColorer(g, params), "device")

    report = {
        "config": {
            "n": args.n,
            "p": args.p,
            "n_colors": params.n_colors,
            "seeds": args.seeds,
        },
        "sequential": summarize(seq),
        "parallel": summarize(par),
    }
    # verdicts
    s, p_ = report["sequential"], report["parallel"]
    checks = {
        "all_valid": all(r["valid"] for r in seq + par),
        "all_converged_within_budget": all(
            r["converged"] for r in seq + par
        ),
        "used_colors_within_15pct": abs(
            s["used_colors"]["mean"] - p_["used_colors"]["mean"]
        )
        <= 0.15 * max(s["used_colors"]["mean"], p_["used_colors"]["mean"]),
        "balance_index_within_2std": abs(
            s["balance_index"]["mean"] - p_["balance_index"]["mean"]
        )
        <= 2 * (s["balance_index"]["std"] + p_["balance_index"]["std"])
        + 0.5,
    }
    report["checks"] = checks
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(checks, indent=1))
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
