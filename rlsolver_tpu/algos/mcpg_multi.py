"""Generic multi-problem MCPG: one driver, pluggable problem adapters.

Reference counterpart: `rlsolver/methods/MCPG/MCPG.py:28-98` with
`sampler_select` (`MCPG/sampling.py:44-65`) dispatching per-problem
sample+local-search+eval functions over maxcut, maxcut_edge,
r/n-cheeger-cut, maxsat, MIMO, qubo and qubo_bin. The maxcut-specialized
fused loop lives in `rlsolver_tpu.algos.mcpg`; this module is the
capability-parity driver for the remaining problems.

Each round (all inside one jitted step):
  1. MH-resample chain states toward the policy probability vector
     (`metro_sampling` semantics, fixed-trip scan);
  2. problem-specific local-search sweep;
  3. score; elitist best-of-repeats reduce into per-chain incumbents;
  4. REINFORCE update of the policy on the raw MH samples with centered
     advantage (`get_return` semantics, maximizing).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from rlsolver_tpu.models.policy import BernoulliPolicy
from rlsolver_tpu.ops.reductions import pick_xs_by_vs, update_xs_by_vs
from rlsolver_tpu.ops.sampling import bernoulli_logp, metropolis_bitflip_scan


@dataclasses.dataclass(frozen=True)
class McpgProblem:
    """Adapter: bits-space problem with a maximize score.

    improve(key, bits [B, N]) -> bits; score(bits) -> f32 [B] (maximize).
    `init_bits` may encode problem-specific chain seeding (cheeger).
    """

    num_vars: int
    score: Callable[[jax.Array], jax.Array]
    improve: Callable[[jax.Array, jax.Array], jax.Array]
    init_bits: Optional[Callable[[jax.Array, int], jax.Array]] = None


@dataclasses.dataclass
class MultiMCPGConfig:
    num_chains: int = 64
    repeat_times: int = 8
    num_rounds: int = 64
    mh_steps_per_var: float = 0.5  # MH proposal rounds = this * num_vars
    lr: float = 8e-2
    seed: int = 0
    sampler: str = "scan"  # "scan" (XLA, any backend) | "fused" (bit-packed
    # Pallas kernel with counter-hash randomness; GPU only, num_vars < 2^20)


class MultiMCPGResult(NamedTuple):
    best_bits: np.ndarray
    best_score: float
    history: list


def solve_mcpg(problem: McpgProblem, cfg: MultiMCPGConfig = MultiMCPGConfig()):
    n = problem.num_vars
    c = cfg.num_chains
    mh_rounds = max(1, int(cfg.mh_steps_per_var * n))

    policy = BernoulliPolicy(n)
    opt = optax.adam(cfg.lr)
    key = jax.random.PRNGKey(cfg.seed)
    k_init, key = jax.random.split(key)
    if problem.init_bits is not None:
        chain_bits = problem.init_bits(k_init, c)
    else:
        chain_bits = jax.random.bernoulli(k_init, 0.5, (c, n))
    params = policy.init(jax.random.PRNGKey(cfg.seed + 1))
    opt_state = opt.init(params)
    best_bits = chain_bits
    best_vs = problem.score(chain_bits)

    @jax.jit
    def round_step(params, opt_state, key, chain_bits, best_bits, best_vs):
        key, k_mh, k_ls = jax.random.split(key, 3)
        probs = policy.apply(params)
        # each chain replicated repeat_times (reference sample_initializer)
        tiled = jnp.tile(chain_bits, (cfg.repeat_times, 1))
        if cfg.sampler == "fused":
            from rlsolver_tpu.ops.counter_rng import seed_from_key
            from rlsolver_tpu.ops.pallas.mh_sampler import mh_sample_fused

            mh = mh_sample_fused(seed_from_key(k_mh), probs, tiled, mh_rounds)
        else:
            mh = metropolis_bitflip_scan(k_mh, probs, tiled, mh_rounds)
        improved = problem.improve(k_ls, mh)
        scores = problem.score(improved)

        # elitist: best of repeats per chain, then keep-if-better
        cand_bits, cand_vs = pick_xs_by_vs(improved, scores, cfg.repeat_times)
        best_bits_new, best_vs_new = update_xs_by_vs(
            best_bits, best_vs, cand_bits, cand_vs
        )

        # REINFORCE on the raw MH samples (maximize => minimize -E[adv*logp])
        adv = scores - scores.mean()

        def loss_fn(p):
            lp = bernoulli_logp(policy.apply(p), mh)  # [R*C], summed over vars
            return -jnp.mean(lp * adv)

        grads = jax.grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        # chains restart from their incumbents (reference keeps now_max_info)
        return params, opt_state, key, best_bits_new, best_bits_new, best_vs_new

    history = []
    for _ in range(cfg.num_rounds):
        params, opt_state, key, chain_bits, best_bits, best_vs = round_step(
            params, opt_state, key, chain_bits, best_bits, best_vs
        )
        history.append(float(jnp.max(best_vs)))

    b = int(jnp.argmax(best_vs))
    return MultiMCPGResult(
        np.asarray(best_bits[b]), float(best_vs[b]), history
    )


# ------------------------------------------------------------------ adapters
def maxcut_edge_problem(graph, num_sweeps: int = 1) -> McpgProblem:
    """Maxcut with the edge-pair local search (`mcpg_sampling_maxcut_edge`)."""
    from rlsolver_tpu.ops import cut as cut_ops
    from rlsolver_tpu.ops.sweeps import edge_pair_sweep

    cg = cut_ops.CutGraph.build(graph)
    return McpgProblem(
        num_vars=graph.num_nodes,
        score=lambda bits: cut_ops.cut_value(bits, cg),
        improve=lambda k, bits: edge_pair_sweep(k, bits, graph, num_sweeps),
    )


def maxsat_problem(env, num_sweeps: int = 2) -> McpgProblem:
    """MaxSAT adapter (`mcpg_sampling_maxsat`)."""
    return McpgProblem(
        num_vars=env.num_vars,
        score=env.obj,
        improve=lambda k, bits: env.sweep(k, bits, num_sweeps=num_sweeps),
    )


def qubo_problem(env, binary: bool = False, num_sweeps: int = 2) -> McpgProblem:
    """QUBO adapter, +-1 (`mcpg_sampling_qubo`) or binary (`..._qubo_bin`)."""
    if binary:
        return McpgProblem(
            num_vars=env.num_vars,
            score=env.obj_bin,
            improve=lambda k, bits: env.sweep_bin(bits, num_sweeps=num_sweeps),
        )
    return McpgProblem(
        num_vars=env.num_vars,
        score=lambda bits: env.obj_pm(bits.astype(jnp.float32) * 2.0 - 1.0),
        improve=lambda k, bits: env.sweep_pm(
            bits.astype(jnp.float32) * 2.0 - 1.0, num_sweeps=num_sweeps
        )
        > 0,
    )


def cheeger_problem(env, num_sweeps: int = 2) -> McpgProblem:
    """Cheeger-cut adapter (`mcpg_sampling_r/ncheegercut`): minimize ratio
    => maximize its negation; chains seeded single-node."""
    return McpgProblem(
        num_vars=env.num_nodes,
        score=lambda bits: -env.obj(bits),
        improve=lambda k, bits: env.sweep(bits, num_sweeps=num_sweeps),
        init_bits=lambda k, c: env.seed_bits(c),
    )


def mimo_problem(env, num_sweeps: int = 2) -> McpgProblem:
    """MIMO detection adapter (`mcpg_sampling_mimo`): minimize residual."""
    return McpgProblem(
        num_vars=env.num_vars,
        score=lambda bits: -env.obj(bits.astype(jnp.float32) * 2.0 - 1.0),
        improve=lambda k, bits: env.sweep(
            bits.astype(jnp.float32) * 2.0 - 1.0, num_sweeps=num_sweeps
        )
        > 0,
    )
