"""Distribution-wise quality benchmark runner (reference README.md:356-371).

Runs greedy / SA / GA / SDP / random-walk / batched MCPG / distribution-wise
L2A over 10 seeded instances per (BA/ER/PL) x N, appending rows

    dist,n,id,alg,obj,seconds

to a resumable CSV. One long-lived process so compiles amortize; the
N-outer loop order shares compiled programs across distributions.

Usage:  python scripts/quality_table.py [--sizes 100,200,...] [--dists BA,ER,PL]
        [--algs greedy,sa,ga,sdp,rw,mcpg,l2a] [--out results_quality/dist_table.csv]
"""

from __future__ import annotations

import _bootstrap  # noqa: F401  (puts the repo root on sys.path)

import argparse
import csv
import os
import time

import numpy as np


def existing_rows(path):
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for row in csv.reader(f):
                if row and row[0] != "dist":
                    done.add((row[0], int(row[1]), int(row[2]), row[3]))
    return done


def append_row(path, dist, n, gid, alg, obj, seconds):
    with open(path, "a", newline="") as f:
        csv.writer(f).writerow([dist, n, gid, alg, f"{obj:.1f}", f"{seconds:.1f}"])


def run_classical(alg, graph, seed):
    if alg == "greedy":
        from rlsolver_tpu.classical.greedy import greedy_maxcut

        return greedy_maxcut(graph)[1]
    if alg == "sa":
        from rlsolver_tpu.classical.simulated_annealing import SAConfig, anneal_maxcut

        n = graph.num_nodes
        cfg = SAConfig(num_chains=256, num_steps=max(2000, 12 * n), seed=seed)
        return anneal_maxcut(graph, cfg)[1]
    if alg == "ga":
        from rlsolver_tpu.classical.genetic import GAConfig, genetic_maxcut

        gens = 40 if graph.num_nodes <= 400 else 64
        return genetic_maxcut(graph, GAConfig(generations=gens, seed=seed))[1]
    if alg == "sdp":
        from rlsolver_tpu.classical.sdp import SDPConfig, sdp_maxcut

        return sdp_maxcut(graph, SDPConfig(seed=seed))[1]
    if alg == "rw":
        from rlsolver_tpu.classical.random_walk import random_walk_maxcut

        return random_walk_maxcut(graph, seed=seed)[1]
    if alg == "specb":
        # certified Poljak-Rendl upper bound (the license-free analogue of
        # the reference's Gurobi-QUBO "obj bound" column, README.md:335)
        from rlsolver_tpu.classical.spectral_bound import (
            SpectralBoundConfig,
            maxcut_upper_bound,
        )

        n = graph.num_nodes
        iters = 4000 if n <= 300 else (8000 if n <= 600 else 12000)
        if n >= 2000:  # large-N rows: [N, N] @ [N, k] host matmuls dominate
            iters = 3000
        # heavier convergence passes (round-4: BA cells sat 0.5-1% above
        # the PR/SDP optimum at campaign budgets) override via env
        iters = int(os.environ.get("SPECB_ITERS", iters))
        block = int(os.environ.get("SPECB_BLOCK", 16))
        cfg = SpectralBoundConfig(
            opt_iters=iters, lr=4.0, block_size=block,
            mu_halvings=10, certify_squarings=12,
        )
        return maxcut_upper_bound(graph, cfg)[0]
    raise ValueError(alg)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--sizes", default="100,200,300,400,500,600,700,800,900,1000")
    p.add_argument("--dists", default="BA,ER,PL")
    p.add_argument("--algs", default="greedy,sa,ga,sdp,rw,mcpg,l2a")
    p.add_argument("--ids", type=int, default=10)
    p.add_argument("--out", default="results_quality/dist_table.csv")
    p.add_argument(
        "--cpu", action="store_true",
        help="force the CPU backend (CPU-only algs can then run concurrently "
        "with a campaign that holds the card)",
    )
    p.add_argument(
        "--redo", default="",
        help="comma-separated algs whose cells (for --sizes/--dists/--ids) "
        "are re-run and APPENDED; the summarizer is later-rows-win, so a "
        "timeout can never leave a cell emptier than before (round-3 "
        "advisor finding: upfront deletion lost rows on cutoff)",
    )
    args = p.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from rlsolver_tpu.config import GraphType
    from rlsolver_tpu.core.generate import graph_from_name

    sizes = [int(s) for s in args.sizes.split(",")]
    dists = args.dists.split(",")
    algs = args.algs.split(",")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    if not os.path.exists(args.out):
        with open(args.out, "w", newline="") as f:
            csv.writer(f).writerow(["dist", "n", "id", "alg", "obj", "seconds"])
    done = existing_rows(args.out)
    if args.redo:
        done -= {
            (d, n, i, a)
            for d in dists
            for n in sizes
            for i in range(args.ids)
            for a in args.redo.split(",")
        }

    for n in sizes:
        for dist in dists:
            names = [f"{dist}_{n}_ID{i}" for i in range(args.ids)]
            graphs = None

            def get_graphs():
                nonlocal graphs
                if graphs is None:
                    graphs = [graph_from_name(nm) for nm in names]
                return graphs

            for alg in algs:
                todo = [i for i in range(args.ids) if (dist, n, i, alg) not in done]
                if not todo:
                    continue
                print(f"== {dist}_{n} {alg} ({len(todo)} instances)", flush=True)
                try:
                    if alg == "mcpg":
                        from rlsolver_tpu.algos.mcpg import MCPGConfig
                        from rlsolver_tpu.algos.mcpg_batch import (
                            solve_maxcut_mcpg_batched,
                        )

                        gs = [get_graphs()[i] for i in todo]
                        cfg = MCPGConfig(
                            total_mcmc_num=256,
                            repeat_times=32,
                            num_ls=8,
                            max_epoch_num=6,
                            reset_epoch_num=64,
                        )
                        t0 = time.time()
                        _, bv, _ = solve_maxcut_mcpg_batched(gs, cfg)
                        dt = (time.time() - t0) / len(todo)
                        for k, i in enumerate(todo):
                            append_row(args.out, dist, n, i, alg, float(bv[k]), dt)
                    elif alg == "jumanji":
                        from rlsolver_tpu.algos.jumanji_ppo import (
                            MPNNActorCritic,
                            SpinPPOConfig,
                            make_greedy_evaluator,
                            train_spin_ppo,
                        )
                        from rlsolver_tpu.core.generate import generate_graph
                        from rlsolver_tpu.envs.spin_system import (
                            SpinSystemConfig,
                            SpinSystemEnv,
                        )

                        train_g = generate_graph(GraphType(dist), n, seed=91000)
                        # truncated-rollout training env (a full 2N-step
                        # rollout buffer is [2N, B, N, 7] — infeasible at
                        # N=1000); evaluation runs full 2N-step episodes
                        train_env = SpinSystemEnv(
                            n,
                            SpinSystemConfig(
                                num_envs=128 if n <= 500 else 64,
                                max_steps=min(2 * n, 256),
                                basin_reward=1.0 / n,
                                stag_punishment=0.01,
                            ),
                        )
                        eval_env = SpinSystemEnv(
                            n,
                            SpinSystemConfig(
                                num_envs=64,
                                basin_reward=1.0 / n,
                                stag_punishment=0.01,
                            ),
                        )
                        jcfg = SpinPPOConfig(
                            # round-4: 40/25 iters left jumanji below greedy
                            # from N=300 up (PL_300 753 vs greedy 829);
                            # iterations are cheap (~1-2 s each)
                            num_iters=int(os.environ.get(
                                "JUMANJI_ITERS", 100 if n <= 500 else 80
                            )),
                            features=32,
                            n_layers=2,
                            # bound PPO-update activations: [T*B/mb, N, 64]
                            # (whole-rollout updates OOM'd at N=400)
                            num_minibatches=1 if n <= 300 else (8 if n <= 500 else 16),
                        )
                        t0 = time.time()
                        params, _ = train_spin_ppo(train_env, train_g, jcfg)
                        net = MPNNActorCritic(
                            features=jcfg.features, n_layers=jcfg.n_layers
                        )
                        ev = make_greedy_evaluator(eval_env, net)
                        dt = (time.time() - t0) / len(todo)
                        for i in todo:
                            v = ev(params, get_graphs()[i])
                            append_row(args.out, dist, n, i, alg, v, dt)
                    elif alg in ("eco", "s2v"):
                        from rlsolver_tpu.algos.dqn import DQNAgent, DQNConfig
                        from rlsolver_tpu.core.generate import generate_graph
                        from rlsolver_tpu.envs.spin_system import (
                            NUM_OBSERVABLES_S2V,
                            RewardSignal,
                            SpinSystemConfig,
                            SpinSystemEnv,
                        )

                        train_g = generate_graph(GraphType(dist), n, seed=92000)
                        if alg == "eco":
                            # train on truncated episodes (replay stays
                            # fresh); evaluate full 2N-step episodes
                            train_cfg = SpinSystemConfig(
                                num_envs=int(os.environ.get("ECO_ENVS", 64)),
                                max_steps=min(2 * n, 512),
                                basin_reward=1.0 / n,
                                stag_punishment=0.01,
                            )
                            eval_cfg = SpinSystemConfig(
                                num_envs=32,
                                basin_reward=1.0 / n,
                                stag_punishment=0.01,
                            )
                        else:  # S2V-DQN: irreversible one-shot construction
                            train_cfg = eval_cfg = SpinSystemConfig(
                                num_envs=32,
                                max_steps=n,
                                reversible_spins=False,
                                num_observables=NUM_OBSERVABLES_S2V,
                                reward_signal=RewardSignal.DENSE,
                                norm_rewards=False,
                            )
                        steps = 6144 if n <= 500 else 3072
                        if alg == "eco":
                            # round-4: 6144-step ECO sat 20% BELOW greedy on
                            # sparse BA/PL (a weak Q oscillates two spins
                            # under greedy eval; the reference trains 1M
                            # single-env steps at N>=200, config.py:66-115)
                            steps = int(os.environ.get(
                                "ECO_STEPS", 24576 if n <= 500 else 12288
                            ))
                        dcfg = DQNConfig(
                            features=32,
                            n_layers=2,
                            buffer_capacity=2**12,
                            eps_decay_steps=steps // 2,
                        )
                        agent = DQNAgent(SpinSystemEnv(n, train_cfg), dcfg)
                        t0 = time.time()
                        params, _, _ = agent.train_scan(train_g, steps)
                        eval_agent = DQNAgent(SpinSystemEnv(n, eval_cfg), dcfg)
                        dt = (time.time() - t0) / len(todo)
                        for i in todo:
                            v = eval_agent.evaluate_scan(params, get_graphs()[i])
                            append_row(args.out, dist, n, i, alg, v, dt)
                    elif alg == "specb":
                        from rlsolver_tpu.classical.spectral_bound import (
                            SpectralBoundConfig,
                            maxcut_upper_bound_cell,
                        )

                        iters = 4000 if n <= 300 else (8000 if n <= 600 else 12000)
                        if n >= 2000:
                            iters = 3000
                        iters = int(os.environ.get("SPECB_ITERS", iters))
                        block = int(os.environ.get("SPECB_BLOCK", 16))
                        cfg = SpectralBoundConfig(
                            opt_iters=iters, lr=4.0, block_size=block,
                            mu_halvings=10,
                            certify_squarings=int(
                                os.environ.get("SPECB_CERT", 12)
                            ),
                        )
                        gs = [get_graphs()[i] for i in todo]
                        t0 = time.time()
                        vals = maxcut_upper_bound_cell(gs, cfg)
                        dt = (time.time() - t0) / len(todo)
                        for kk, i in enumerate(todo):
                            append_row(args.out, dist, n, i, alg, vals[kk], dt)
                    elif alg == "isco":
                        from rlsolver_tpu.algos.isco import (
                            ISCOConfig,
                            solve_maxcut_isco_cell,
                        )

                        gs = [get_graphs()[i] for i in todo]
                        cfg = ISCOConfig(
                            # dense-energy cost scales ~ chains x N^2 x 2N:
                            # at N >= 900 the 256-chain cell runs 20-30 min
                            batch_size=int(os.environ.get(
                                "ISCO_BATCH", 256 if n <= 800 else 96
                            )),
                            chain_length=max(600, 2 * n),
                            seed=0,
                        )
                        t0 = time.time()
                        _, vals = solve_maxcut_isco_cell(gs, cfg, mode="dense")
                        dt = (time.time() - t0) / len(todo)
                        for k, i in enumerate(todo):
                            append_row(args.out, dist, n, i, alg, float(vals[k]), dt)
                    elif alg == "pignn":
                        from rlsolver_tpu.algos.pignn import (
                            PIGNNConfig,
                            solve_maxcut_pignn_cell,
                        )

                        gs = [get_graphs()[i] for i in todo]
                        t0 = time.time()
                        _, vals = solve_maxcut_pignn_cell(gs, PIGNNConfig(seed=0))
                        dt = (time.time() - t0) / len(todo)
                        for k, i in enumerate(todo):
                            append_row(args.out, dist, n, i, alg, float(vals[k]), dt)
                    elif alg == "l2a":
                        from rlsolver_tpu.algos.l2a_distribution import (
                            L2ADistConfig,
                            evaluate_l2a_packed,
                            train_l2a_distribution,
                        )

                        cfg = L2ADistConfig(
                            graph_type=GraphType(dist),
                            num_nodes=n,
                            num_sims=256,
                            num_repeats=4,
                            top_k=max(12, n // 10),
                            seq_len=8,
                            num_iters=60,
                            embed_dim=32,
                            pretrain_steps=100,
                            ls_sweeps=2,
                            num_validation=0,
                        )
                        t0 = time.time()
                        bundle = train_l2a_distribution(cfg)
                        gs = [get_graphs()[i] for i in todo]
                        # eval-time search at MCPG-class budget: the packed
                        # degree-ordered sweep engine under policy guidance
                        vals = evaluate_l2a_packed(
                            bundle, gs,
                            num_rounds=128 if n <= 500 else 256,
                            num_sims=512, num_repeats=16, num_sweeps=8,
                        )
                        dt = (time.time() - t0) / len(todo)
                        for k, i in enumerate(todo):
                            append_row(args.out, dist, n, i, alg, float(vals[k]), dt)
                    else:
                        for i in todo:
                            t0 = time.time()
                            v = float(run_classical(alg, get_graphs()[i], seed=i))
                            append_row(args.out, dist, n, i, alg, v, time.time() - t0)
                except Exception as e:  # keep the sweep going; log and move on
                    print(f"!! {dist}_{n} {alg} failed: {e!r}", flush=True)
                    # a lost device backend does not recover in this
                    # process — every later cell would fail in ~0s. Exit
                    # non-zero so the launcher records FAIL and a
                    # fresh-process retry can resume.
                    if "UNAVAILABLE" in repr(e) or "crashed" in repr(e):
                        print("!! backend unavailable - aborting for retry",
                              flush=True)
                        raise SystemExit(17)
    print("done", flush=True)


if __name__ == "__main__":
    main()
