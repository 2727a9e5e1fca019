"""Calibrate the packed-engine L2A evaluator on one campaign cell.

Round-3 flagship item (VERDICT): L2A must be >= GA+tabu at every cell and
>= MCPG on BA. This trains a distribution-wise bundle at the given budget
and evaluates the 10 seeded instances with `evaluate_l2a_packed`, printing
the per-instance cuts and the cell average for side-by-side comparison with
results_quality/dist_table.csv.

Usage: python scripts/calibrate_l2a.py --dist BA --n 1000 [--iters 60]
       [--rounds 96] [--eval-sims 512] [--eval-repeats 16] [--sweeps 8]
"""

from __future__ import annotations

import _bootstrap  # noqa: F401  (puts the repo root on sys.path)

import argparse
import time


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dist", default="BA")
    p.add_argument("--n", type=int, default=1000)
    p.add_argument("--ids", type=int, default=10)
    p.add_argument("--iters", type=int, default=60)
    p.add_argument("--train-sims", type=int, default=256)
    p.add_argument("--rounds", type=int, default=96)
    p.add_argument("--eval-sims", type=int, default=512)
    p.add_argument("--eval-repeats", type=int, default=16)
    p.add_argument("--sweeps", type=int, default=8)
    p.add_argument("--top-k", type=int, default=0, help="0 = max(8, n // 32)")
    args = p.parse_args()

    from rlsolver_tpu.algos.l2a_distribution import (
        L2ADistConfig,
        evaluate_l2a_packed,
        train_l2a_distribution,
    )
    from rlsolver_tpu.config import GraphType
    from rlsolver_tpu.core.generate import graph_from_name

    n = args.n
    cfg = L2ADistConfig(
        graph_type=GraphType(args.dist),
        num_nodes=n,
        num_sims=args.train_sims,
        num_repeats=4,
        top_k=args.top_k or max(8, n // 32),
        seq_len=8,
        num_iters=args.iters,
        embed_dim=32,
        pretrain_steps=100,
        ls_sweeps=2,
        num_validation=0,
    )
    t0 = time.time()
    bundle = train_l2a_distribution(cfg)
    t_train = time.time() - t0
    print(f"train: {t_train:.0f}s", flush=True)

    graphs = [graph_from_name(f"{args.dist}_{n}_ID{i}") for i in range(args.ids)]
    t0 = time.time()
    vals = evaluate_l2a_packed(
        bundle,
        graphs,
        num_rounds=args.rounds,
        num_sims=args.eval_sims,
        num_repeats=args.eval_repeats,
        num_sweeps=args.sweeps,
    )
    t_eval = time.time() - t0
    print("cuts:", [f"{v:.0f}" for v in vals], flush=True)
    print(
        f"avg {sum(vals)/len(vals):.1f}  eval {t_eval:.0f}s "
        f"({t_eval/len(graphs):.1f}s/instance)  train {t_train:.0f}s",
        flush=True,
    )


if __name__ == "__main__":
    main()
