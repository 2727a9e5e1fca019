"""ECO-DQN at the reference training protocol (round-4 VERDICT item #1).

ONE network per distribution, trained at N=200 on a rotating pool of fresh
random instances — the reference's RandomGraphGenerator + NUM_STEPS=1e6
regime (`ECO_S2V/config.py:33-83`: NUM_TRAIN_NODES>=200 -> NUM_STEPS=1e6,
UPDATE_FREQUENCY=32, UPDATE_TARGET_FREQUENCY=4000, FINAL_EXPLORATION_STEP
= 0.8*NUM_STEPS) — with validation-selected checkpoints
(`select_best_neural_network.py:31`), then inferred across every table size
(train-on-one-size / infer-across-sizes, `config.py:45` NUM_INFERENCE_NODES).

The training loop is fully on device (DQNAgent.train_scan_select: the whole
act/step/replay/train/target-sync/rotate cycle is one scanned program) and
the MPNN runs in bfloat16 (the reference's use_tensor_core fp16 path,
`networks/mpnn.py:55-58`).

Budget accounting (the per-column compute disclosure in DIST_TABLE.md):
loop_steps * train_envs env transitions and loop_steps SGD updates per
distribution — defaults give 32768 * 64 = 2.1M transitions / 32768 updates
vs the reference's 1M transitions / 31250 updates.

Appends `eco` rows to results_quality/dist_table.csv (best-row-wins
summarizer); training artifacts go to results_quality/eco_params_{dist}.pkl
so a fresh-process retry (exit 17 on a lost device backend) resumes at
inference.
"""

from __future__ import annotations

import _bootstrap  # noqa: F401  (puts the repo root on sys.path)

import argparse
import csv
import os
import pickle
import time

import numpy as np

OUT = "results_quality/dist_table.csv"
DONE = "results_quality/eco_dist_done.txt"


def append_row(path, dist, n, gid, alg, obj, seconds):
    with open(path, "a", newline="") as f:
        csv.writer(f).writerow([dist, n, gid, alg, f"{obj:.1f}", f"{seconds:.1f}"])


def done_cells():
    if not os.path.exists(DONE):
        return set()
    return {tuple(l.split()) for l in open(DONE).read().splitlines() if l}


def mark_done(dist, n):
    with open(DONE, "a") as f:
        f.write(f"{dist} {n}\n")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dists", default="BA,PL,ER")
    p.add_argument("--sizes", default="100,200,300,400,500,600,700,800,900,1000")
    p.add_argument("--ids", type=int, default=10)
    p.add_argument("--train-nodes", type=int, default=200)
    p.add_argument("--train-envs", type=int, default=64)
    p.add_argument("--pool", type=int, default=48)
    p.add_argument(
        "--loop-steps", type=int,
        default=int(os.environ.get("ECO_LOOP_STEPS", 32768)),
    )
    p.add_argument("--features", type=int, default=64)
    p.add_argument("--n-layers", type=int, default=3)
    p.add_argument("--segments", type=int, default=16)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax
    import jax.numpy as jnp

    from rlsolver_tpu.algos.dqn import DQNAgent, DQNConfig
    from rlsolver_tpu.config import GraphType
    from rlsolver_tpu.core.generate import generate_graph, graph_from_name
    from rlsolver_tpu.envs.spin_system import SpinSystemConfig, SpinSystemEnv

    sizes = [int(s) for s in args.sizes.split(",")]
    ntr = args.train_nodes
    dcfg = DQNConfig(
        features=args.features,
        n_layers=args.n_layers,
        lr=1e-4,
        gamma=0.95,
        buffer_capacity=2**15,
        batch_size=128,
        update_frequency=1,  # 1 SGD step per 64-env vector step
        # reference syncs every 4000 env steps / UPDATE_FREQUENCY=32
        # -> every 125 updates; 250 here (1 update per 64 transitions)
        target_update_frequency=250,
        eps_start=1.0,
        eps_end=0.05,
        eps_decay_steps=int(0.8 * args.loop_steps),
        learning_starts=1024,
        dtype=jnp.bfloat16,
        seed=3,
    )
    done = done_cells()

    for dist in args.dists.split(","):
        gt = GraphType(dist)
        ckpt = f"results_quality/eco_params_{dist}.pkl"
        if os.path.exists(ckpt):
            params = pickle.load(open(ckpt, "rb"))
            t_train = 0.0
            print(f"== {dist}: loaded trained params from {ckpt}", flush=True)
        else:
            pool = [generate_graph(gt, ntr, seed=95000 + i) for i in range(args.pool)]
            val = [generate_graph(gt, ntr, seed=96000 + i) for i in range(5)]
            train_cfg = SpinSystemConfig(
                num_envs=args.train_envs,
                max_steps=2 * ntr,  # reference step_fact=2 full episodes
                basin_reward=1.0 / ntr,
                stag_punishment=0.01,
            )
            agent = DQNAgent(SpinSystemEnv(ntr, train_cfg), dcfg)
            print(
                f"== {dist}: training at N={ntr} "
                f"({args.loop_steps} loop steps x {args.train_envs} envs = "
                f"{args.loop_steps * args.train_envs / 1e6:.1f}M transitions, "
                f"{args.pool}-graph pool, bf16 MPNN)",
                flush=True,
            )
            t0 = time.time()
            params, hist = agent.train_scan_select(
                pool, args.loop_steps, val,
                num_segments=args.segments, verbose=True,
            )
            t_train = time.time() - t0
            print(f"== {dist}: trained in {t_train:.0f}s; val history {hist}",
                  flush=True)
            pickle.dump(params, open(ckpt, "wb"))

        for n in sizes:
            if (dist, str(n)) in done:
                continue
            eval_cfg = SpinSystemConfig(
                num_envs=50 if n <= 500 else 32,  # reference NUM_INFERENCE_ENVS
                basin_reward=1.0 / n,
                stag_punishment=0.01,
            )
            eval_agent = DQNAgent(SpinSystemEnv(n, eval_cfg), dcfg)
            t0 = time.time()
            try:
                vals = [
                    eval_agent.evaluate_scan(
                        params, graph_from_name(f"{dist}_{n}_ID{i}")
                    )
                    for i in range(args.ids)
                ]
            except Exception as e:
                print(f"!! {dist}_{n} eco failed: {e!r}", flush=True)
                if "UNAVAILABLE" in repr(e) or "crashed" in repr(e):
                    print("!! backend unavailable - aborting for retry",
                          flush=True)
                    raise SystemExit(17)
                continue
            dt = (time.time() - t0) / args.ids + t_train / (
                len(sizes) * args.ids
            )
            for i, v in enumerate(vals):
                append_row(OUT, dist, n, i, "eco", float(v), dt)
            mark_done(dist, n)
            print(
                f"{dist}_{n} eco: avg {np.mean(vals):.1f} "
                f"({(time.time() - t0):.0f}s)",
                flush=True,
            )
    print("done", flush=True)


if __name__ == "__main__":
    main()
