"""Unified CLI: one entry point over the problem/alg/data axes.

The reference's L6 is per-method `main.py` scripts wired to module-level
config constants (`methods/config.py:9-83`, `ECO_S2V/config.py`,
`README.md:254-286` usage). SURVEY.md section 1 calls for unifying that
into a single driver: this module maps `--alg` to the solver registry,
runs it over every instance (files via `--data-dir`/`--prefixes`, the
reference's `<alg>_manyfiles` pattern, or synthetic `--graphs BA_100_ID0`),
and writes reference-format result files.

    python -m rlsolver_tpu --alg greedy --graphs BA_100_ID0 BA_100_ID1
    python -m rlsolver_tpu --alg mcpg --data-dir data/gset --prefixes gset_14
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Tuple

import numpy as np

from rlsolver_tpu.core.generate import graph_from_name
from rlsolver_tpu.core.graph import Graph
from rlsolver_tpu.core.io import list_graph_files, read_graph
from rlsolver_tpu.core.result import write_graph_result
from rlsolver_tpu.problems.objectives import obj_maxcut


Solver = Callable[[Graph, int], Tuple[np.ndarray, float]]


def _greedy(g, seed):
    from rlsolver_tpu.classical.greedy import greedy_maxcut

    return greedy_maxcut(g)


def _sa(g, seed):
    from rlsolver_tpu.classical.simulated_annealing import SAConfig, anneal_maxcut

    return anneal_maxcut(g, SAConfig(seed=seed))


def _ga(g, seed):
    from rlsolver_tpu.classical.genetic import GAConfig, genetic_maxcut

    return genetic_maxcut(g, GAConfig(seed=seed))


def _random_walk(g, seed):
    from rlsolver_tpu.classical.random_walk import random_walk_maxcut

    return random_walk_maxcut(g, seed=seed)


def _sdp(g, seed):
    from rlsolver_tpu.classical.sdp import SDPConfig, sdp_maxcut

    return sdp_maxcut(g, SDPConfig(seed=seed))


def _bls(g, seed):
    from rlsolver_tpu.classical.bls import BLSConfig, solve_maxcut_bls

    bits, cut, _ = solve_maxcut_bls(g, BLSConfig(seed=seed))
    return bits, cut


def _local_search(g, seed):
    from rlsolver_tpu.algos.local_search_solver import (
        LocalSearchConfig,
        solve_maxcut_local_search,
    )

    out = solve_maxcut_local_search(g, LocalSearchConfig(seed=seed))
    return out[0], out[1]


def _mcpg(g, seed, fast=False):
    from rlsolver_tpu.algos.mcpg import MCPGConfig, solve_maxcut_mcpg

    cfg = MCPGConfig(seed=seed)
    if fast:
        cfg = MCPGConfig(seed=seed, sampler="fused", sweep_mode="packed")
    out = solve_maxcut_mcpg(g, cfg)
    return out[0], out[1]


def _l2a(g, seed):
    from rlsolver_tpu.algos.l2a import L2AConfig, solve_maxcut_l2a

    out = solve_maxcut_l2a(g, L2AConfig(seed=seed))
    return out[0], out[1]


def _isco(g, seed):
    from rlsolver_tpu.algos.isco import ISCOConfig, solve_maxcut_isco

    out = solve_maxcut_isco(g, ISCOConfig(seed=seed))
    return out[0], out[1]


def _pignn(g, seed):
    from rlsolver_tpu.algos.pignn import PIGNNConfig, solve_maxcut_pignn

    return solve_maxcut_pignn(g, PIGNNConfig(seed=seed))


def _vqe(g, seed):
    from rlsolver_tpu.solvers.vqe import VQEConfig, vqe_maxcut

    bits, cut, _ = vqe_maxcut(g, VQEConfig(seed=seed))
    return bits, cut


def _seq2seq(g, seed):
    from rlsolver_tpu.algos.l2o import Seq2SeqConfig, solve_maxcut_seq2seq

    bits, cut, _ = solve_maxcut_seq2seq(g, Seq2SeqConfig(seed=seed))
    return bits, cut


def _l2o(g, seed):
    from rlsolver_tpu.algos.l2o import L2OConfig, solve_maxcut_l2o

    bits, cut, _ = solve_maxcut_l2o(g, L2OConfig(seed=seed))
    return bits, cut


MILP_TIME_LIMIT = 60.0  # set by --milp-time-limit


def _milp(g, seed):
    from rlsolver_tpu.solvers.milp import solve_maxcut

    res = solve_maxcut(g, time_limit=MILP_TIME_LIMIT)
    gap = (res.bound - res.obj) / max(1e-9, abs(res.obj))
    return (
        res.solution.astype(bool),
        res.obj,
        {"obj_bound": res.bound, "gap": gap, "time_limit": MILP_TIME_LIMIT},
    )


SOLVERS: Dict[str, Solver] = {
    "greedy": _greedy,
    "sa": _sa,
    "ga": _ga,
    "random_walk": _random_walk,
    "sdp": _sdp,
    "bls": _bls,
    "local_search": _local_search,
    "mcpg": _mcpg,
    "l2a": _l2a,
    "isco": _isco,
    "pignn": _pignn,
    "vqe": _vqe,
    "seq2seq": _seq2seq,
    "l2o": _l2o,
    "milp": _milp,
}


def _graph_problem_solvers() -> Dict[str, Dict[str, Solver]]:
    """Per-problem solver registries over the same graph-instance axis
    (the reference's `Problem` enum dispatch, `methods/config.py:18-32` +
    per-problem branches in `greedy.py:33-336`)."""
    from rlsolver_tpu.algos.isco import ISCOConfig, solve_mis_isco
    from rlsolver_tpu.classical import coloring as col
    from rlsolver_tpu.classical.greedy import (
        greedy_graph_partitioning,
        greedy_mis,
        greedy_mvc,
    )
    from rlsolver_tpu.solvers import milp

    def from_milp(solve):
        def f(g, seed):
            res = solve(g)
            return np.asarray(res.solution).astype(np.int64), res.obj

        return f

    def coloring_alg(fn):
        def f(g, seed):
            colors, k = fn(g)
            return colors.astype(np.int64), float(k)

        return f

    return {
        "mis": {
            "greedy": lambda g, seed: greedy_mis(g),
            "isco": lambda g, seed: solve_mis_isco(g, ISCOConfig(seed=seed))[:2],
            "milp": from_milp(milp.solve_mis),
        },
        "mvc": {
            "greedy": lambda g, seed: greedy_mvc(g),
            "milp": from_milp(milp.solve_mvc),
        },
        "graph_partitioning": {
            "greedy": lambda g, seed: greedy_graph_partitioning(g),
            "milp": from_milp(milp.solve_graph_partitioning),
        },
        "graph_coloring": {
            "greedy": coloring_alg(col.greedy_coloring),
            "welsh_powell": coloring_alg(col.welsh_powell),
            "dsatur": coloring_alg(col.dsatur),
            "rlf": coloring_alg(col.recursive_largest_first),
        },
    }


def _check_solution(problem: str, solution: np.ndarray, value: float, graph: Graph):
    """Re-score the solver's solution with the host objective twin."""
    from rlsolver_tpu.classical.coloring import is_proper_coloring
    from rlsolver_tpu.problems import objectives as obj

    if problem == "maxcut":
        check = obj.obj_maxcut(solution, graph)
    elif problem == "mis":
        check = obj.obj_maximum_independent_set(solution, graph)
    elif problem == "mvc":
        check = obj.obj_minimum_vertex_cover(solution, graph)
    elif problem == "graph_partitioning":
        check = obj.obj_graph_partitioning(solution, graph)
    elif problem == "graph_coloring":
        if not is_proper_coloring(graph, solution):
            raise RuntimeError("improper coloring")
        check = float(len(np.unique(solution)))
    else:
        return
    if abs(check - value) >= 1e-4:
        raise RuntimeError(f"solver/objective mismatch: {value} vs {check}")


def run_one(
    alg: str, graph: Graph, seed: int, write: bool, instance_path: str,
    fast: bool = False, problem: str = "maxcut",
):
    t0 = time.time()
    import inspect

    solver = SOLVERS[alg] if problem == "maxcut" else _graph_problem_solvers()[problem][alg]
    if "fast" in inspect.signature(solver).parameters:
        out = solver(graph, seed, fast=fast)
    else:
        out = solver(graph, seed)
    # solvers may return (bits, value) or (bits, value, info) — info carries
    # solver-side metadata like the MILP dual bound (the reference's "obj
    # bound" column, `gurobi.py:135-156`)
    bits, value = out[0], out[1]
    info = out[2] if len(out) > 2 else None
    duration = time.time() - t0
    bits = np.asarray(bits).astype(np.int64)
    _check_solution(problem, bits, value, graph)
    path = None
    if write:
        path = write_graph_result(
            obj=value,
            running_duration=duration,
            num_nodes=graph.num_nodes,
            alg_name=alg,
            solution=bits,
            instance_file=instance_path,
            info=info,
        )
    return value, duration, path


def _set_cover_solvers():
    """Set-cover axis over reference-format instance files
    (`util_read_data.py:335-344`); objective convention = negative set count
    (`util_obj.py:145`)."""
    from rlsolver_tpu.classical.greedy import greedy_set_cover
    from rlsolver_tpu.solvers import milp

    def _milp(inst, seed):
        res = milp.solve_set_cover(inst)
        sol = np.asarray(res.solution).astype(np.int64)
        return sol, -float(sol.sum())

    return {
        "greedy": lambda inst, seed: greedy_set_cover(inst),
        "milp": _milp,
    }


def _knapsack_solvers():
    """Knapsack axis over reference-format files (`util_read_data.py:314-333`,
    shipped `data/knapsack/knap_*.txt`); objective = total profit."""
    import jax

    from rlsolver_tpu.classical import knapsack as kp
    from rlsolver_tpu.solvers import milp

    def _milp(inst, seed):
        res = milp.solve_knapsack(inst)
        return np.asarray(res.solution).astype(np.int64), float(res.obj)

    return {
        "greedy": lambda inst, seed: kp.greedy_knapsack(inst),
        "dp": lambda inst, seed: kp.dp_knapsack(inst),
        "branch_and_bound": lambda inst, seed: kp.branch_and_bound_knapsack(inst),
        "fptas": lambda inst, seed: kp.fptas_knapsack(inst),
        "sa": lambda inst, seed: kp.sa_knapsack(inst, jax.random.PRNGKey(seed)),
        "milp": _milp,
    }


def run_instance_problem(problem: str, alg: str, path: str, seed: int, write: bool):
    """set_cover / knapsack: non-graph instance files with their own readers,
    objective twins and result files."""
    from rlsolver_tpu.core.io import read_knapsack, read_set_cover
    from rlsolver_tpu.problems import objectives as obj

    if problem == "set_cover":
        inst = read_set_cover(path)
        solver = _set_cover_solvers()[alg]
        check_fn, size = obj.obj_set_cover, inst.num_sets
    else:
        inst = read_knapsack(path)
        solver = _knapsack_solvers()[alg]
        check_fn, size = obj.obj_knapsack, inst.num_items
    t0 = time.time()
    sol, value = solver(inst, seed)
    duration = time.time() - t0
    sol = np.asarray(sol).astype(np.int64)
    check = check_fn(sol, inst)
    if abs(check - value) >= 1e-4:
        raise RuntimeError(f"solver/objective mismatch: {value} vs {check}")
    out = None
    if write:
        out = write_graph_result(
            obj=value,
            running_duration=duration,
            num_nodes=size,
            alg_name=alg,
            solution=sol,
            instance_file=path,
            plus1=False,
        )
    return value, duration, out


def _tsp_solvers():
    """TSP problem axis: `--data-dir` of .tsp files or random instances."""
    from rlsolver_tpu.classical import tsp as ctsp

    def chain(construct):
        def solve(dist, seed):
            import jax.numpy as jnp

            tour = construct(dist)
            tours, lengths = ctsp.two_opt_best_improvement(
                jnp.asarray(tour[None]), jnp.asarray(dist), max_iters=200
            )
            return np.asarray(tours[0]), float(lengths[0])

        return solve

    return {
        "nn": chain(ctsp.nearest_neighbor_tour),
        "christofides": chain(ctsp.christofides_tour),
        "karp_steele": chain(ctsp.karp_steele_tour),
        "cheapest_insertion": chain(ctsp.cheapest_insertion_tour),
    }


def run_tsp(alg: str, path: str, seed: int) -> Tuple[float, float]:
    from rlsolver_tpu.core.io import read_tsp_coords, tsp_distance_matrix
    from rlsolver_tpu.problems.objectives import obj_tsp

    dist = tsp_distance_matrix(read_tsp_coords(path))
    t0 = time.time()
    tour, length = _tsp_solvers()[alg](dist, seed)
    duration = time.time() - t0
    # re-validate: the tour is a permutation and its `obj_tsp` re-score
    # matches the solver's reported length (same discipline as
    # `_check_solution` for the graph problems)
    if sorted(np.asarray(tour).tolist()) != list(range(dist.shape[0])):
        raise RuntimeError(f"{alg} returned a non-permutation tour on {path}")
    check = -obj_tsp(tour, dist)
    if abs(check - length) > 1e-3 * max(1.0, abs(length)):
        raise RuntimeError(f"solver/objective mismatch: {length} vs {check}")
    return length, duration


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rlsolver_tpu", description=__doc__)
    p.add_argument(
        "--problem",
        default="maxcut",
        choices=[
            "maxcut", "mis", "mvc", "graph_partitioning", "graph_coloring",
            "set_cover", "knapsack", "tsp",
        ],
    )
    p.add_argument("--alg", required=True)
    p.add_argument("--data-dir", default=None, help="directory of gset-format txt files")
    p.add_argument("--prefixes", nargs="*", default=[], help="instance filename prefixes")
    p.add_argument("--graphs", nargs="*", default=[], help="synthetic names, e.g. BA_100_ID0")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-write", action="store_true", help="skip result files")
    p.add_argument(
        "--fast",
        action="store_true",
        help="MCPG on the bit-packed Pallas kernels (GPU only, integer "
        "weights): sampler='fused' + sweep_mode='packed'",
    )
    p.add_argument(
        "--milp-time-limit",
        type=float,
        default=60.0,
        help="HiGHS wall-clock limit for --alg milp; the dual bound and gap "
        "are written into the result file (reference 'obj bound' column)",
    )
    args = p.parse_args(argv)
    from rlsolver_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    global MILP_TIME_LIMIT
    MILP_TIME_LIMIT = args.milp_time_limit

    if args.problem == "tsp":
        solvers = _tsp_solvers()
        if args.alg not in solvers:
            p.error(f"tsp algs: {sorted(solvers)}")
        if not args.data_dir:
            p.error("tsp needs --data-dir of .tsp files")
        import glob as _glob

        for f in sorted(_glob.glob(os.path.join(args.data_dir, "*.tsp"))):
            if args.prefixes and not any(
                os.path.basename(f).startswith(x) for x in args.prefixes
            ):
                continue
            length, duration = run_tsp(args.alg, f, args.seed)
            print(f"{args.alg} {os.path.basename(f)}: length={length:.1f} time={duration:.2f}s")
        return 0

    if args.problem in ("set_cover", "knapsack"):
        registry = _set_cover_solvers() if args.problem == "set_cover" else _knapsack_solvers()
        if args.alg not in registry:
            p.error(f"{args.problem} algs: {sorted(registry)}")
        if not args.data_dir:
            p.error(f"{args.problem} needs --data-dir of instance files")
        for f in list_graph_files(args.data_dir, args.prefixes or [""]):
            value, duration, out = run_instance_problem(
                args.problem, args.alg, f, args.seed, not args.no_write
            )
            print(f"{args.alg} {os.path.basename(f)}: obj={value:.1f} time={duration:.2f}s"
                  + (f" -> {out}" if out else ""))
        return 0

    if args.problem == "maxcut":
        if args.alg not in SOLVERS:
            p.error(f"maxcut algs: {sorted(SOLVERS)}")
    else:
        registry = _graph_problem_solvers()[args.problem]
        if args.alg not in registry:
            p.error(f"{args.problem} algs: {sorted(registry)}")

    jobs = []
    if args.data_dir:
        for f in list_graph_files(args.data_dir, args.prefixes or [""]):
            jobs.append((read_graph(f), f))
    for name in args.graphs:
        jobs.append((graph_from_name(name), os.path.join("data", f"{name}.txt")))
    if not jobs:
        p.error("nothing to solve: pass --data-dir or --graphs")

    for graph, path in jobs:
        value, duration, out = run_one(
            args.alg, graph, args.seed, not args.no_write, path,
            fast=args.fast, problem=args.problem,
        )
        name = graph.name or os.path.basename(path)
        print(f"{args.alg} {name}: obj={value:.1f} time={duration:.2f}s"
              + (f" -> {out}" if out else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
