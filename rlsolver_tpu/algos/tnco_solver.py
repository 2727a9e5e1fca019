"""TNCO solvers: batched local search and MCPG policy training, shardable.

Reference counterpart: the TNCO solve paths of L2A —
`TNCO_local_search.py:118-197` (`if __name__` driver: random init ->
`random_search` rounds -> evaluator bookkeeping) and the MCMC/policy loop
`valid_in_single_graph_TNCO` (`envs/env_L2A.py:322-450`), plus the
distributed-ish searches under `methods_problem_specific/quantum_circuits/`
(`massive.py`). BASELINE.json config 5 makes TNCO + MCPG the multi-host
flagship: here the chain axis shards over the mesh with `shard_map`, the
policy (per-bit Bernoulli over the binary rank codec) is replicated, and
incumbent reduction rides `pmin`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from rlsolver_tpu.envs.tnco import TensorNetwork, TncoEnv
from rlsolver_tpu.models.policy import BernoulliPolicy
from rlsolver_tpu.ops.sampling import bernoulli_logp, metropolis_bitflip_scan


@dataclasses.dataclass
class TncoSearchConfig:
    num_chains: int = 64
    num_rounds: int = 30
    ls_iters: int = 8
    num_spin: int = 8
    noise_std: float = 0.3
    seed: int = 0


def solve_tnco_local_search(
    env: TncoEnv, cfg: TncoSearchConfig = TncoSearchConfig()
) -> Tuple[np.ndarray, float, list]:
    """Pure local search in priority space (`SolverLocalSearch` driver).

    Returns (best edge order [R], best log10 cost, history)."""
    key = jax.random.PRNGKey(cfg.seed)
    k_init, key = jax.random.split(key)
    sorts = env.random_edge_sorts(k_init, cfg.num_chains)
    fs = env.ranks_to_priorities(sorts)
    vs = env.obj_priorities(fs)

    ls = jax.jit(
        lambda k, fs, vs: env.local_search(
            k, fs, vs, num_iters=cfg.ls_iters,
            num_spin=cfg.num_spin, noise_std=cfg.noise_std,
        )
    )
    history = []
    for _ in range(cfg.num_rounds):
        key, k = jax.random.split(key)
        fs, vs = ls(k, fs, vs)
        history.append(float(jnp.min(vs)))
    b = int(jnp.argmin(vs))
    order = np.asarray(env.priorities_to_edge_sorts(fs[b : b + 1])[0])
    return order, float(vs[b]), history


@dataclasses.dataclass
class TncoMcpgConfig:
    num_chains: int = 32
    repeat_times: int = 4
    num_rounds: int = 30
    mh_rounds: int = 64
    ls_iters: int = 4
    lr: float = 5e-2
    seed: int = 0
    sampler: str = "scan"  # "scan" (XLA, any backend/mesh) | "fused"
    # (bit-packed Pallas kernel, GPU only, num_bits < 2^20, unsharded)


class TncoMcpgState(NamedTuple):
    params: dict
    opt_state: tuple
    key: jax.Array
    best_fs: jax.Array  # [C, R] incumbent priorities
    best_vs: jax.Array  # [C]


def make_tnco_mcpg_step(env: TncoEnv, cfg: TncoMcpgConfig, axis_name: Optional[str] = None):
    """One jitted MCPG round over the binary rank codec: MH-resample bits
    toward the policy, decode to orders, local-search in priority space,
    elitist keep, REINFORCE update (minimize => negate advantage)."""
    policy = BernoulliPolicy(env.num_bits)
    optimizer = optax.adam(cfg.lr)

    def step(state: TncoMcpgState):
        key, k_mh, k_ls = jax.random.split(state.key, 3)
        if axis_name:
            shard = jax.lax.axis_index(axis_name)
            k_mh = jax.random.fold_in(k_mh, shard)
            k_ls = jax.random.fold_in(k_ls, shard)
        probs = policy.apply(state.params)

        # chains restart from incumbents, replicated over repeats
        bits = env.edge_sorts_to_bits(
            env.priorities_to_edge_sorts(state.best_fs)
        )
        tiled = jnp.tile(bits, (cfg.repeat_times, 1))
        if cfg.sampler == "fused" and not axis_name:
            from rlsolver_tpu.ops.counter_rng import seed_from_key
            from rlsolver_tpu.ops.pallas.mh_sampler import mh_sample_fused

            mh = mh_sample_fused(seed_from_key(k_mh), probs, tiled, cfg.mh_rounds)
        else:
            mh = metropolis_bitflip_scan(k_mh, probs, tiled, cfg.mh_rounds)

        fs = env.ranks_to_priorities(env.bits_to_edge_sorts(mh))
        fs, vs = env.local_search(k_ls, fs, num_iters=cfg.ls_iters)

        # best-of-repeats per chain (minimize)
        c = state.best_fs.shape[0]
        vs_r = vs.reshape(cfg.repeat_times, c)
        best_r = jnp.argmin(vs_r, axis=0)
        rows = best_r * c + jnp.arange(c)
        cand_fs, cand_vs = fs[rows], vs[rows]
        better = cand_vs < state.best_vs
        best_fs = jnp.where(better[:, None], cand_fs, state.best_fs)
        best_vs = jnp.where(better, cand_vs, state.best_vs)

        # REINFORCE, centered advantage; global center under sharding
        if axis_name:
            mean_v = jax.lax.pmean(vs.mean(), axis_name)
        else:
            mean_v = vs.mean()
        adv = vs - mean_v  # lower is better -> minimize E[adv * logp]

        def loss_fn(p):
            lp = bernoulli_logp(policy.apply(p), mh)
            return jnp.mean(lp * jax.lax.stop_gradient(adv))

        grads = jax.grad(loss_fn)(state.params)
        if axis_name:
            grads = jax.lax.pmean(grads, axis_name)
        updates, opt_state = optimizer.update(grads, state.opt_state)
        params = optax.apply_updates(state.params, updates)

        best_global = jnp.min(best_vs)
        if axis_name:
            best_global = jax.lax.pmin(best_global, axis_name)
        return (
            TncoMcpgState(params, opt_state, key, best_fs, best_vs),
            {"best": best_global, "mean": mean_v},
        )

    return policy, optimizer, step


def init_tnco_mcpg_state(env: TncoEnv, policy, optimizer, cfg: TncoMcpgConfig):
    key = jax.random.PRNGKey(cfg.seed)
    k_init, key = jax.random.split(key)
    sorts = env.random_edge_sorts(k_init, cfg.num_chains)
    fs = env.ranks_to_priorities(sorts)
    vs = env.obj_priorities(fs)
    params = policy.init(jax.random.PRNGKey(cfg.seed + 1))
    return TncoMcpgState(params, optimizer.init(params), key, fs, vs)


def solve_tnco_mcpg(
    env: TncoEnv, cfg: TncoMcpgConfig = TncoMcpgConfig()
) -> Tuple[np.ndarray, float, list]:
    """Single-chip MCPG on TNCO. Returns (order, log10 cost, history)."""
    policy, optimizer, step = make_tnco_mcpg_step(env, cfg)
    state = init_tnco_mcpg_state(env, policy, optimizer, cfg)
    jit_step = jax.jit(step)
    history = []
    for _ in range(cfg.num_rounds):
        state, metrics = jit_step(state)
        history.append(float(metrics["best"]))
    b = int(jnp.argmin(state.best_vs))
    order = np.asarray(env.priorities_to_edge_sorts(state.best_fs[b : b + 1])[0])
    return order, float(state.best_vs[b]), history


def solve_tnco_mcpg_sharded(
    env: TncoEnv, mesh, cfg: TncoMcpgConfig = TncoMcpgConfig(), axis_name: str = "env"
) -> Tuple[np.ndarray, float, list]:
    """Mesh-sharded MCPG on TNCO (BASELINE config 5): chains sharded,
    policy replicated, `pmean` grads + `pmin` incumbents."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_dev = mesh.devices.size
    assert cfg.num_chains % n_dev == 0
    policy, optimizer, step = make_tnco_mcpg_step(env, cfg, axis_name=axis_name)
    state = init_tnco_mcpg_state(env, policy, optimizer, cfg)

    state_spec = TncoMcpgState(P(), P(), P(), P(axis_name), P(axis_name))
    sharded = jax.jit(
        jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(state_spec,),
            out_specs=(state_spec, {"best": P(), "mean": P()}),
            check_vma=False,
        )
    )
    rep, shd = NamedSharding(mesh, P()), NamedSharding(mesh, P(axis_name))
    state = jax.device_put(
        state,
        TncoMcpgState(
            jax.tree.map(lambda _: rep, state.params),
            jax.tree.map(lambda _: rep, state.opt_state),
            rep, shd, shd,
        ),
    )
    history = []
    for _ in range(cfg.num_rounds):
        state, metrics = sharded(state)
        history.append(float(np.asarray(metrics["best"])))
    b = int(jnp.argmin(state.best_vs))
    order = np.asarray(env.priorities_to_edge_sorts(state.best_fs[b : b + 1])[0])
    return order, float(jnp.min(state.best_vs)), history
