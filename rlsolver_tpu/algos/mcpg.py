"""MCPG: Monte Carlo Policy Gradient for QUBO-style problems (Pattern II).

Capability-parity rebuild of the reference MCPG maxcut solver
(`rlsolver/methods/MCPG.py:322-457`), as three fused jitted programs:

  1. sample:  policy-targeted Metropolis bit-flip chains
              (`metro_sampling`, MCPG.py:88-118) over
              total_mcmc_num * repeat_times chains, followed by `num_ls`
              degree-ordered local-search sweeps (`sampler_func`,
              MCPG.py:120-166) and the per-chain best-of-repeats reduction;
  2. elitist: per-chain incumbent update + worst-chain replacement by the
              global best (MCPG.py:376-394);
  3. update:  REINFORCE on the *pre-local-search* samples with the
              (local-searched) advantage value (`get_return`,
              MCPG.py:292-302), Adam + grad clip 1.0.

Chain layout is flat [repeat_times * total_mcmc_num, N] with repeat r of
chain c at row r * C + c (matching `pick_xs_by_vs` layout).
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from rlsolver_tpu.core.graph import Graph
from rlsolver_tpu.core.result import write_graph_result
from rlsolver_tpu.envs.maxcut import MaxcutEnv
from rlsolver_tpu.eval.evaluator import Evaluator
from rlsolver_tpu.models.policy import BernoulliPolicy
from rlsolver_tpu.ops.counter_rng import seed_from_key
from rlsolver_tpu.ops.pallas.mcpg_sweep import WeightedSweepTables, mcpg_sweep_fused
from rlsolver_tpu.ops.pallas.mh_sampler import mh_sample_fused, require_gpu
from rlsolver_tpu.ops.reductions import pick_xs_by_vs, update_xs_by_vs
from rlsolver_tpu.ops.sampling import bernoulli_logp, metropolis_bitflip_chain
from rlsolver_tpu.ops.sweeps import (
    SweepData,
    colored_sweep,
    degree_ordered_sweep,
    mcpg_init_values,
)


@dataclasses.dataclass
class MCPGConfig:
    total_mcmc_num: int = 256  # parallel chains C
    repeat_times: int = 32  # repeats R per chain
    num_ls: int = 8  # local-search sweeps per sample round
    max_epoch_num: int = 3
    reset_epoch_num: int = 64  # sample rounds per epoch ~ reset/sample
    sample_epoch_num: int = 8  # SGD steps per sample round
    lr: float = 8e-2
    change_times: Optional[int] = None  # MH accept budget per chain; default N/10
    warmup_ls_rounds: int = 4  # incumbent warm start via parallel local search
    seed: int = 0
    sweep_mode: str = "sequential"  # "sequential" (parity, XLA scan) |
    # "colored" (color-class matmuls) | "packed" (the bit-packed Pallas
    # sweep kernel, `ops/pallas/mcpg_sweep.py`; GPU only, integer weights)
    sampler: str = "budgeted"  # "budgeted" (reference-parity accept budget) |
    # "fused" (the bit-packed Pallas MH kernel, `ops/pallas/mh_sampler.py`;
    # GPU only; runs a fixed 2 * change_times proposal rounds instead of the
    # accept budget)


# Per-instance tuned presets with the reference's own population sizes
# (`MCPG.py:41-84`, sized there for one 40 GB GPU): total_mcmc_num chains of
# repeat_times repeats each, e.g. 2048 x 512 chains of 2000 nodes on G22.
GSET_PRESETS = {
    "gset_14": MCPGConfig(total_mcmc_num=512, repeat_times=128, num_ls=8,
                          reset_epoch_num=128, max_epoch_num=30),
    "gset_22": MCPGConfig(total_mcmc_num=2048, repeat_times=512, num_ls=8,
                          reset_epoch_num=256, max_epoch_num=30),
    "gset_55": MCPGConfig(total_mcmc_num=1024, repeat_times=448, num_ls=8,
                          reset_epoch_num=192, max_epoch_num=30),
    "gset_70": MCPGConfig(total_mcmc_num=768, repeat_times=288, num_ls=8,
                          reset_epoch_num=320, max_epoch_num=30),
}


def preset_for(instance_name: str) -> MCPGConfig:
    """Tuned config for a gset instance; default config otherwise."""
    for key, cfg in GSET_PRESETS.items():
        if key in instance_name:
            return cfg
    return MCPGConfig()


class MCPGState(NamedTuple):
    params: dict
    opt_state: optax.OptState
    key: jax.Array
    best_xs: jax.Array  # [C, N] per-chain incumbents
    best_vs: jax.Array  # [C] per-chain incumbent cuts


def _build_steps(env: MaxcutEnv, data: SweepData, cfg: MCPGConfig):
    num_nodes = env.num_nodes
    C, R = cfg.total_mcmc_num, cfg.repeat_times
    change_times = cfg.change_times or max(1, num_nodes // 10)
    policy = BernoulliPolicy(num_nodes)
    optimizer = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(cfg.lr))
    if cfg.sampler == "fused" or cfg.sweep_mode == "packed":
        require_gpu(False, f"MCPG sampler={cfg.sampler!r} sweep_mode={cfg.sweep_mode!r}")
    if cfg.sweep_mode == "packed":
        tables = WeightedSweepTables.build(env.graph)

    def sample_step(key, probs, start_bits):
        """start_bits bool [R*C, N] -> (mh_samples, ls_bits, cuts [R*C])."""
        k_mh, k_ls = jax.random.split(key)
        if cfg.sampler == "fused":
            rounds = max(cfg.num_ls, 2 * change_times)
            mh = mh_sample_fused(seed_from_key(k_mh), probs, start_bits, rounds)
        else:
            mh = metropolis_bitflip_chain(k_mh, probs, start_bits, change_times).samples
        if cfg.sweep_mode == "packed":
            ls_bits = mcpg_sweep_fused(
                seed_from_key(k_ls), mh, tables, num_sweeps=cfg.num_ls
            )
        elif cfg.sweep_mode == "sequential":
            xt = mcpg_init_values(mh)
            xt = degree_ordered_sweep(k_ls, xt, data, num_sweeps=cfg.num_ls)
            ls_bits = xt[:, :num_nodes] > 0.5
        else:
            xs_f = colored_sweep(
                k_ls,
                mh.astype(jnp.float32),
                env.cg.adj.astype(jnp.float32),
                env.cg.deg_w,
                data.color_masks,
                num_sweeps=cfg.num_ls,
            )
            ls_bits = xs_f > 0.5
        cuts = env.obj(ls_bits)
        return mh, ls_bits, cuts

    def reduce_step(ls_bits, cuts, best_xs, best_vs):
        """Best-of-repeats per chain + per-chain elitist + worst<-best."""
        chain_xs, chain_vs = pick_xs_by_vs(ls_bits, cuts, R)  # [C, N], [C]
        best_xs, best_vs = update_xs_by_vs(best_xs, best_vs, chain_xs, chain_vs)
        top = jnp.argmax(best_vs)
        worst = jnp.argmin(best_vs)
        best_xs = best_xs.at[worst].set(best_xs[top])
        best_vs = best_vs.at[worst].set(best_vs[top])
        # chains restart from their per-chain best-of-repeats
        restart = jnp.tile(chain_xs, (R, 1))
        return best_xs, best_vs, restart

    def loss_fn(params, mh_samples, value):
        probs = policy.apply(params)
        logp = bernoulli_logp(probs, mh_samples)
        return jnp.mean(logp * value)

    def update_step(params, opt_state, mh_samples, cuts):
        # value = expected-cut energy advantage: E = total_w - 2*cut, centered.
        energy = env.cg.total_w - 2.0 * cuts
        value = energy - jnp.mean(energy)

        def body(carry, _):
            params, opt_state = carry
            grads = jax.grad(loss_fn)(params, mh_samples, value)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), None

        (params, opt_state), _ = jax.lax.scan(
            body, (params, opt_state), None, length=cfg.sample_epoch_num
        )
        return params, opt_state

    return policy, optimizer, sample_step, reduce_step, update_step


def make_sharded_mcpg_step(
    env: MaxcutEnv, data: SweepData, cfg: MCPGConfig, mesh, axis_name: str = "env"
):
    """One data-parallel MCPG round over a 1-D mesh (the counterpart of the
    reference's NCCL DDP): chains sharded over `axis_name`, policy and
    optimizer state replicated. Each shard samples its chains with MCPG's
    `sample_step` (the fused kernels when `cfg` asks for them), the
    REINFORCE advantage is centred over all shards, and the gradients are
    psum'd, so the replicated params stay identical on every device.

    Returns (policy, optimizer, step) with the jitted
    `step(params, opt_state, seed, xs) -> (params, opt_state, ls_bits, cuts)`;
    `seed` is a replicated uint32 scalar, xs bool [B, N] sharded on B."""
    from jax.sharding import PartitionSpec as P

    policy, optimizer, sample_step, _, _ = _build_steps(env, data, cfg)

    def step(params, opt_state, seed, xs):
        key = jax.random.fold_in(
            jax.random.PRNGKey(seed), jax.lax.axis_index(axis_name)
        )
        mh, ls_bits, cuts = sample_step(key, policy.apply(params), xs)
        energy = env.cg.total_w - 2.0 * cuts
        count = jax.lax.psum(energy.shape[0], axis_name)
        value = energy - jax.lax.psum(jnp.sum(energy), axis_name) / count

        def loss_fn(p):
            return jnp.sum(bernoulli_logp(policy.apply(p), mh) * value) / count

        # under shard_map with check_vma=False each shard's grad holds only
        # its own chains' term: sum them so every replica takes one update
        grads = jax.lax.psum(jax.grad(loss_fn)(params), axis_name)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, ls_bits, cuts

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(axis_name)),
        out_specs=(P(), P(), P(axis_name), P(axis_name)),
        check_vma=False,
    )
    return policy, optimizer, jax.jit(sharded)


class MCPGLoopState(NamedTuple):
    """Full resumable state for the TrainLoop-driven MCPG run."""

    params: dict
    opt_state: optax.OptState
    key: jax.Array
    best_xs: jax.Array
    best_vs: jax.Array
    start_bits: jax.Array
    round_idx: jax.Array  # int32 scalar


def solve_maxcut_mcpg_runner(
    graph: Graph,
    cfg: MCPGConfig = MCPGConfig(),
    run_dir: str = "runs/mcpg",
    total_rounds: Optional[int] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    log_every: int = 1,
):
    """MCPG through the unified runtime (`train/runner.py:TrainLoop`):
    checkpoint/resume (full state incl. PRNG key + incumbent archive),
    metrics.jsonl stream, and the graceful-stop sentinel are live — the
    ElegantRL-runtime capabilities (`elegantrl/train/run.py:130`,
    `AgentBase.py:280-299`) on the flagship solver.

    The reference's per-epoch policy reset (`MCPG.py:366-367`) is folded
    into the jitted step as a masked reset on `round_idx % rounds_per_epoch
    == 0` (BernoulliPolicy init is zeros, Adam state starts at zeros, so the
    reset is a tree of zeros — jit-friendly). Returns (best_x, best_v,
    final_state).
    """
    from rlsolver_tpu.train.runner import LoopConfig, TrainLoop

    env = MaxcutEnv(graph)
    data = SweepData.build(graph)
    C, R = cfg.total_mcmc_num, cfg.repeat_times
    policy, optimizer, sample_step, reduce_step, update_step = _build_steps(
        env, data, cfg
    )
    rounds_per_epoch = max(1, cfg.reset_epoch_num // cfg.sample_epoch_num)
    if total_rounds is None:
        total_rounds = cfg.max_epoch_num * rounds_per_epoch

    def step_fn(state: MCPGLoopState):
        do_reset = (state.round_idx % rounds_per_epoch) == 0
        zeros = jax.tree.map(jnp.zeros_like, (state.params, state.opt_state))
        params, opt_state = jax.tree.map(
            lambda z, v: jnp.where(do_reset, z, v),
            zeros,
            (state.params, state.opt_state),
        )
        key, k_s = jax.random.split(state.key)
        probs = policy.apply(params)
        mh, ls_bits, cuts = sample_step(k_s, probs, state.start_bits)
        best_xs, best_vs, start_bits = reduce_step(
            ls_bits, cuts, state.best_xs, state.best_vs
        )
        params, opt_state = update_step(params, opt_state, mh, cuts)
        metrics = {
            "best_cut": jnp.max(best_vs),
            "mean_cut": jnp.mean(cuts),
        }
        return (
            MCPGLoopState(
                params, opt_state, key, best_xs, best_vs, start_bits,
                state.round_idx + 1,
            ),
            metrics,
        )

    key = jax.random.PRNGKey(cfg.seed)
    key, k_init, k_ws, k_p = jax.random.split(key, 4)
    xs = env.random_xs(k_init, C)
    vs = env.obj(xs)
    for _ in range(cfg.warmup_ls_rounds):
        key, k = jax.random.split(key)
        xs, vs = jax.jit(env.local_search)(k, xs, vs)
    params = policy.init(k_p)
    state = MCPGLoopState(
        params=params,
        opt_state=optimizer.init(params),
        key=key,
        best_xs=xs,
        best_vs=vs,
        start_bits=jnp.tile(xs, (R, 1)),
        round_idx=jnp.int32(0),
    )
    loop = TrainLoop(
        LoopConfig(
            run_dir=run_dir,
            total_steps=total_rounds,
            log_every=log_every,
            checkpoint_every=checkpoint_every,
            resume=resume,
            samples_per_step=R * C,
        ),
        step_fn,
    )
    state = loop.run(state)
    top = int(jnp.argmax(state.best_vs))
    return (
        np.asarray(state.best_xs[top]),
        float(state.best_vs[top]),
        state,
    )


def solve_maxcut_mcpg(
    graph: Graph,
    cfg: MCPGConfig = MCPGConfig(),
    instance_file: Optional[str] = None,
    save_dir: Optional[str] = None,
    verbose: bool = False,
    time_budget: Optional[float] = None,
):
    """Returns (best_x np.bool_[n], best_v float, evaluator).

    `time_budget` (seconds, wall clock from after warm start) stops the
    epoch loop early — the reference's benchmark protocol runs methods under
    a fixed time limit (`README.md:335`)."""
    env = MaxcutEnv(graph)
    data = SweepData.build(graph)
    C, R = cfg.total_mcmc_num, cfg.repeat_times
    policy, optimizer, sample_step, reduce_step, update_step = _build_steps(env, data, cfg)

    key = jax.random.PRNGKey(cfg.seed)
    key, k_init, k_ws = jax.random.split(key, 3)

    # Warm start: parallel local search on C chains (MCPG.py:342-348).
    xs = env.random_xs(k_init, C)
    vs = env.obj(xs)
    for _ in range(cfg.warmup_ls_rounds):
        key, k = jax.random.split(key)
        xs, vs = jax.jit(env.local_search)(k, xs, vs)
    best_xs, best_vs = xs, vs

    params = policy.init(k_ws)
    opt_state = optimizer.init(params)

    sample_j = jax.jit(sample_step)
    reduce_j = jax.jit(reduce_step)
    update_j = jax.jit(update_step)
    apply_j = jax.jit(policy.apply)

    evaluator = Evaluator(
        save_dir, graph.num_nodes, np.asarray(best_xs[0]), float(best_vs[0]), True
    )
    start = time.time()
    start_bits = jnp.tile(best_xs, (R, 1))
    rounds_per_epoch = max(1, cfg.reset_epoch_num // cfg.sample_epoch_num)
    sps_log = []
    for epoch in range(cfg.max_epoch_num):
        # per-epoch policy reset, as in the reference loop (MCPG.py:366-367)
        key, k_reset = jax.random.split(key)
        params = policy.init(k_reset)
        opt_state = optimizer.init(params)
        for j in range(rounds_per_epoch):
            key, k_s = jax.random.split(key)
            probs = apply_j(params)
            t0 = time.time()
            mh, ls_bits, cuts = sample_j(k_s, probs, start_bits)
            best_xs, best_vs, start_bits = reduce_j(ls_bits, cuts, best_xs, best_vs)
            best_vs.block_until_ready()
            sps_log.append((R * C) / (time.time() - t0))
            params, opt_state = update_j(params, opt_state, mh, cuts)
            evaluator.record(epoch * rounds_per_epoch + j + 1, np.asarray(best_vs), np.asarray(best_xs))
            if verbose and j % 8 == 0:
                print(evaluator.log_line(j, f"samples/s {sps_log[-1]:.0f}"))
            if time_budget is not None and time.time() - start > time_budget:
                break
        if time_budget is not None and time.time() - start > time_budget:
            break
    evaluator.save()

    if instance_file is not None:
        write_graph_result(
            evaluator.best_v,
            time.time() - start,
            graph.num_nodes,
            "mcpg",
            evaluator.best_x.astype(int),
            instance_file,
            info={"samples_per_second": float(np.mean(sps_log[1:]) if len(sps_log) > 1 else 0)},
        )
    return evaluator.best_x, evaluator.best_v, evaluator
