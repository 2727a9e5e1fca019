"""Time-limited HiGHS MILP bound runner for the distribution table (CPU).

Produces the reference table's "Gurobi 1h / obj bound" columns
(`README.md:356-371`, bound definition `README.md:335`) with the
out-of-the-box HiGHS backend (`rlsolver_tpu/solvers/milp.py`). Appends rows

    dist,n,id,alg,obj,seconds   (alg in {milp, milp_bound})

to the same CSV as scripts/quality_table.py (resumable).
"""

from __future__ import annotations

import _bootstrap  # noqa: F401  (puts the repo root on sys.path)

import argparse
import time

from quality_table import append_row, existing_rows  # same scripts/ dir


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--sizes", default="100,200,300,400,500,600,700,800,900,1000")
    p.add_argument("--dists", default="BA,ER,PL")
    p.add_argument("--ids", type=int, default=10)
    p.add_argument("--time-limit", type=float, default=60.0)
    p.add_argument("--out", default="results_quality/dist_table.csv")
    args = p.parse_args()

    from rlsolver_tpu.core.generate import graph_from_name
    from rlsolver_tpu.solvers.milp import solve_maxcut

    sizes = [int(s) for s in args.sizes.split(",")]
    done = existing_rows(args.out)
    for n in sizes:
        for dist in args.dists.split(","):
            for i in range(args.ids):
                if (dist, n, i, "milp") in done:
                    continue
                g = graph_from_name(f"{dist}_{n}_ID{i}")
                t0 = time.time()
                try:
                    r = solve_maxcut(g, time_limit=args.time_limit)
                except Exception as e:
                    print(f"!! {dist}_{n}_ID{i} milp failed: {e!r}", flush=True)
                    continue
                dt = time.time() - t0
                append_row(args.out, dist, n, i, "milp", r.obj, dt)
                append_row(args.out, dist, n, i, "milp_bound", r.bound, dt)
                print(f"{dist}_{n}_ID{i}: obj={r.obj:.0f} bound={r.bound:.0f} "
                      f"({dt:.0f}s)", flush=True)
    print("done", flush=True)


if __name__ == "__main__":
    main()
