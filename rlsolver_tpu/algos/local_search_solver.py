"""Massively-parallel local-search solver (no neural net).

Reproduces the capability of the reference's
`search_and_evaluate_local_search` (`rlsolver/envs/env_MCPG.py:408-491`):
thousands of parallel solution chains, each iteration running the noisy
multi-flip + greedy-sweep local search, elitist accepts against incumbents,
and periodic evolutionary replacement of the worst chains. The whole
iteration is one jitted program; only incumbent logging leaves the device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from rlsolver_tpu.core.graph import Graph
from rlsolver_tpu.core.result import write_graph_result
from rlsolver_tpu.envs.maxcut import MaxcutEnv
from rlsolver_tpu.eval.evaluator import Evaluator
from rlsolver_tpu.ops.reductions import evolutionary_replacement, update_xs_by_vs


@dataclasses.dataclass
class LocalSearchConfig:
    num_sims: int = 1024
    num_iters: int = 32  # outer iterations
    ls_iters: int = 8  # multi-flip iterations per local_search call
    num_spin: int = 8
    noise_std: float = 0.3
    replace_frac: float = 0.125  # worst chains replaced per iteration
    seed: int = 0
    log_every: int = 4


def solve_maxcut_local_search(
    graph: Graph,
    config: LocalSearchConfig = LocalSearchConfig(),
    instance_file: Optional[str] = None,
    save_dir: Optional[str] = None,
    verbose: bool = False,
):
    """Returns (best_x np.bool_[n], best_v float, evaluator)."""
    env = MaxcutEnv(graph)
    key = jax.random.PRNGKey(config.seed)
    key, k_init = jax.random.split(key)
    xs = env.random_xs(k_init, config.num_sims)
    vs = env.obj(xs)
    low_k = max(1, int(config.num_sims * config.replace_frac))

    def iteration(key, good_xs, good_vs):
        k_ls, k_rep = jax.random.split(key)
        xs2, vs2 = env.local_search(
            k_ls,
            good_xs,
            good_vs,
            num_iters=config.ls_iters,
            num_spin=config.num_spin,
            noise_std=config.noise_std,
        )
        good_xs, good_vs = update_xs_by_vs(good_xs, good_vs, xs2, vs2)
        good_xs, good_vs = evolutionary_replacement(k_rep, good_xs, good_vs, low_k)
        return good_xs, good_vs

    step = jax.jit(iteration)

    evaluator = Evaluator(
        save_dir,
        graph.num_nodes,
        np.asarray(xs[0]),
        float(vs[0]),
        if_maximize=True,
    )
    start = time.time()
    for it in range(config.num_iters):
        key, k_it = jax.random.split(key)
        xs, vs = step(k_it, xs, vs)
        if (it + 1) % config.log_every == 0 or it == config.num_iters - 1:
            evaluator.record(it + 1, np.asarray(vs), np.asarray(xs))
            if verbose:
                print(evaluator.log_line(it + 1))
    evaluator.save()

    if instance_file is not None:
        write_graph_result(
            evaluator.best_v,
            time.time() - start,
            graph.num_nodes,
            "parallel_local_search",
            evaluator.best_x.astype(int),
            instance_file,
        )
    return evaluator.best_x, evaluator.best_v, evaluator
