"""Symmetric convergence pass for narrow-margin campaign cells.

Round-3 advisor finding (ADVICE.md, medium): `boost_l2a.py` gave L2A a
best-of-k fresh-seed retry protocol while MCPG rows stayed single runs,
so a flagship win could rest on selection bias. This tool replaces it
with a SYMMETRIC protocol: for each given (dist, N) cell it runs the
SAME number of attempts for BOTH l2a and mcpg, each attempt at the
matched "converged" budget, appends per-instance rows only where a
method improves its own current value (monotone best, later-rows-win
summarizer), and records every attempt — seeds, wall-clock, per-cell
averages — in ``results_quality/boost_log.csv`` so the table footnote
can disclose exactly how much compute each column received.

Reference claim being reproduced: dREINFORCE >= every baseline on the
distribution tables (/root/reference/README.md:356-371).

Usage: python scripts/standing_pass.py --cells BA:500,BA:600,BA:700 \
           [--attempts 2] [--algs l2a,mcpg]
"""

from __future__ import annotations

import _bootstrap  # noqa: F401  (puts the repo root on sys.path)

import argparse
import csv
import os
import time

OUT = "results_quality/dist_table.csv"
BOOST_LOG = "results_quality/boost_log.csv"


def current_vals(path, dist, n, alg):
    vals = {}
    for r in csv.reader(open(path)):
        if r and r[0] == dist and r[1] == str(n) and r[3] == alg:
            vals[int(r[2])] = float(r[4])  # later rows win
    return vals


def log_attempt(dist, n, alg, attempt, seed, seconds, avg):
    new = not os.path.exists(BOOST_LOG)
    with open(BOOST_LOG, "a", newline="") as f:
        wr = csv.writer(f)
        if new:
            wr.writerow(["dist", "n", "alg", "attempt", "seed", "seconds", "avg_obj"])
        wr.writerow([dist, n, alg, attempt, seed, f"{seconds:.1f}", f"{avg:.2f}"])


def append_improvements(dist, n, alg, vals, dt):
    old = current_vals(OUT, dist, n, alg)
    improved = 0
    with open(OUT, "a", newline="") as f:
        wr = csv.writer(f)
        for i, v in enumerate(vals):
            if float(v) > old.get(i, float("-inf")):
                wr.writerow([dist, n, i, alg, f"{float(v):.1f}", f"{dt:.1f}"])
                improved += 1
    merged = [max(float(v), old.get(i, float("-inf"))) for i, v in enumerate(vals)]
    return improved, sum(merged) / len(merged)


def run_l2a(dist, n, ids, seed, args):
    from rlsolver_tpu.algos.l2a_distribution import (
        L2ADistConfig,
        evaluate_l2a_packed,
        train_l2a_distribution,
    )
    from rlsolver_tpu.config import GraphType
    from rlsolver_tpu.core.generate import graph_from_name

    cfg = L2ADistConfig(
        graph_type=GraphType(dist),
        num_nodes=n,
        num_sims=256,
        num_repeats=4,
        top_k=max(12, n // 10),
        seq_len=8,
        num_iters=args.iters,
        embed_dim=32,
        pretrain_steps=100,
        ls_sweeps=2,
        num_validation=0,
        seed=seed,
    )
    t0 = time.time()
    bundle = train_l2a_distribution(cfg)
    graphs = [graph_from_name(f"{dist}_{n}_ID{i}") for i in range(ids)]
    vals = evaluate_l2a_packed(
        bundle, graphs,
        num_rounds=args.rounds, num_sims=args.eval_sims,
        num_repeats=16, num_sweeps=8, seed=seed,
    )
    return [float(v) for v in vals], time.time() - t0


def run_mcpg(dist, n, ids, seed, args):
    from rlsolver_tpu.algos.mcpg import MCPGConfig
    from rlsolver_tpu.algos.mcpg_batch import solve_maxcut_mcpg_batched
    from rlsolver_tpu.core.generate import graph_from_name

    graphs = [graph_from_name(f"{dist}_{n}_ID{i}") for i in range(ids)]
    cfg = MCPGConfig(
        total_mcmc_num=args.mcpg_chains,
        repeat_times=args.mcpg_repeats,
        num_ls=8,
        max_epoch_num=args.mcpg_epochs,
        reset_epoch_num=64,
        seed=seed,
    )
    t0 = time.time()
    _, bv, _ = solve_maxcut_mcpg_batched(graphs, cfg)
    return [float(v) for v in bv], time.time() - t0


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cells", required=True, help="e.g. BA:500,BA:600,BA:700")
    p.add_argument("--ids", type=int, default=10)
    p.add_argument("--attempts", type=int, default=2)
    p.add_argument("--algs", default="l2a,mcpg")
    p.add_argument("--seed-base", type=int, default=7)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--rounds", type=int, default=512)
    p.add_argument("--eval-sims", type=int, default=1024)
    p.add_argument("--iters", type=int, default=80)
    p.add_argument("--mcpg-epochs", type=int, default=10)
    p.add_argument("--mcpg-chains", type=int, default=512)
    p.add_argument("--mcpg-repeats", type=int, default=64)
    args = p.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    runners = {"l2a": run_l2a, "mcpg": run_mcpg}
    for cell in args.cells.split(","):
        dist, n_s = cell.split(":")
        n = int(n_s)
        for attempt in range(args.attempts):
            seed = args.seed_base + attempt
            for alg in args.algs.split(","):
                t0 = time.time()
                try:
                    vals, dt = runners[alg](dist, n, args.ids, seed, args)
                except Exception as e:
                    print(f"!! {cell} {alg} attempt {attempt} failed: {e!r}",
                          flush=True)
                    continue
                per_inst = dt / args.ids
                improved, avg = append_improvements(dist, n, alg, vals, per_inst)
                log_attempt(dist, n, alg, attempt, seed, dt, avg)
                print(
                    f"{cell} {alg} attempt {attempt} (seed {seed}): "
                    f"improved {improved}/{args.ids}, cell avg {avg:.1f}, "
                    f"{dt:.0f}s", flush=True,
                )


if __name__ == "__main__":
    main()
