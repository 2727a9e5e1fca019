"""Breakout Local Search for maxcut, batched.

Reference counterpart: `rlsolver/methods_problem_specific/maxcut/BLS.py:14-99`
+ `operator.py` + `perturbation.py` + `main_BLS.py:23-31` — the BLS schema
(Benlic & Hao): a 1-flip-per-iteration search that always applies the best
*admissible* move (tabu list with aspiration, `util.py:TabuList.is_allowed`),
plus an adaptive perturbation of `L` flips whose moves are directed
(max-gain) with probability `max(P0, exp(-omega/T))` and uniformly random
otherwise (`perturbation.py:choose_perturbation`), each perturbation flip
getting a random tabu tenure in `[phi_min, phi_max]`
(`operator.py:perturb_operator`).

Redesign for the accelerator (not a translation):

- All chains run the loop in lockstep inside one jitted `lax.scan`; each
  scan step = exactly one flip per chain, so the per-step op set is fixed
  (XLA-friendly) and a perturbation is just a different *move-selection
  rule* under a per-chain mask — the reference's sequential
  `perturb_operator` loop of L flips becomes L consecutive masked steps.
- The reference's BucketSort incremental gain structure
  (`util.py:BucketSort`) becomes a dense rank-1 gain update: flipping node
  v updates `gains -= 2 * adj[v] * sign(same-side)` — one [B, N] row
  gather + elementwise, no O(N^2) recompute.
- Where the reference assigns tabu tenure only to perturbation flips, this
  engine also gives *descent* flips a short random tenure: in lockstep
  batch form an untenured downhill move would 2-cycle deterministically
  (flip v, then -gain(v) is the new max gain and v is not tabu). This is
  the classic tabu-search-for-UBQP fix and strictly strengthens the
  search; perturbation flips keep the reference's long `[phi_min,
  phi_max]` tenure.
- Revisit/stagnation bookkeeping is per-chain vector state; `omega`
  (steps since the chain's best improved) drives the reference's
  directed-vs-random perturbation schedule.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rlsolver_tpu.core.graph import Graph
from rlsolver_tpu.envs.maxcut import MaxcutEnv


@dataclasses.dataclass
class BLSConfig:
    num_chains: int = 256
    num_rounds: int = 40  # outer jit calls (python loop, time-budget aware)
    steps_per_round: int = 512  # tabu flips per chain per jit call
    l0_ratio: float = 0.01  # reference L0_ratio (main_BLS.py:24)
    t_stag: int = 1000  # reference T: omega scale + stagnation trigger
    phi_min: int = 3  # perturbation tenure lower bound (main_BLS.py:26)
    phi_max_ratio: float = 0.1  # perturbation tenure upper = ratio * N
    p0: float = 0.8  # directed-perturbation probability floor
    desc_tenure: int = 20  # descent-flip tenure upper bound (see module doc)
    seed: int = 0


def solve_maxcut_bls(
    graph: Graph,
    cfg: BLSConfig = BLSConfig(),
    record=None,
    time_budget: Optional[float] = None,
) -> Tuple[np.ndarray, float, list]:
    """Returns (best bits, best cut, per-round best history).

    `record(round_idx, best_cut)` is called after every round (for
    cut-vs-time curves); `time_budget` (seconds) stops the outer python
    loop early once exceeded."""
    env = MaxcutEnv(graph)
    n = graph.num_nodes
    adj = env.cg.adj
    if adj is None:
        adj = jnp.asarray(graph.adjacency_dense(), jnp.float32)
    key = jax.random.PRNGKey(cfg.seed)
    k_init, key = jax.random.split(key)

    l0 = max(1, int(cfg.l0_ratio * n))
    phi_max = max(cfg.phi_min + 1, int(cfg.phi_max_ratio * n))
    phi_desc = max(cfg.phi_min + 1, min(cfg.desc_tenure, n // 10))
    t_stag = jnp.int32(cfg.t_stag)

    # warm start: random -> two improving sweeps to a near-local-optimum
    xs = env.random_xs(k_init, cfg.num_chains)
    vs = env.obj(xs)
    xs, vs = env.sweep_1flip(xs, vs)
    xs, vs = env.sweep_1flip(xs, vs)

    def step(adj_arg, carry, k):
        (xs, gains, curr, best_xs, best_vs, tabu, omega, stag, pert_left,
         t) = carry
        k_mode, k_rand, k_td, k_tp = jax.random.split(k, 4)
        b = xs.shape[0]

        # ---- tabu move: best admissible flip (aspiration overrides tenure)
        adm = (tabu <= t) | ((curr[:, None] + gains) > best_vs[:, None] + 0.5)
        any_adm = adm.any(axis=1)
        tabu_v = jnp.argmax(jnp.where(adm, gains, -jnp.inf), axis=1)

        # ---- perturbation move (reference choose_perturbation schedule)
        p_dir = jnp.maximum(cfg.p0, jnp.exp(-omega.astype(jnp.float32) / t_stag))
        use_random = (omega >= t_stag) | (
            jax.random.uniform(k_mode, (b,)) >= p_dir
        )
        rand_v = jax.random.randint(k_rand, (b,), 0, n)
        dir_v = jnp.argmax(gains, axis=1)  # directed = max-gain node
        pert_v = jnp.where(use_random, rand_v, dir_v)

        perturbing = (pert_left > 0) | ~any_adm
        v = jnp.where(perturbing, pert_v, tabu_v)

        # ---- apply the flip with a rank-1 incremental gain update
        onehot = jnp.arange(n)[None, :] == v[:, None]
        g_v = jnp.take_along_axis(gains, v[:, None], axis=1)[:, 0]
        x_v = jnp.take_along_axis(xs, v[:, None], axis=1)[:, 0]
        adj_row = jnp.take(adj_arg, v, axis=0).astype(jnp.float32)  # [B, N]
        sgn = jnp.where(xs == x_v[:, None], 1.0, -1.0)
        gains = gains - 2.0 * adj_row * sgn
        gains = jnp.where(onehot, -g_v[:, None], gains)
        xs = jnp.logical_xor(xs, onehot)
        curr = curr + g_v

        # ---- tenure: short for descent flips, long (reference) for perturbs
        ten = jnp.where(
            perturbing,
            jax.random.randint(k_tp, (b,), cfg.phi_min, phi_max + 1),
            jax.random.randint(k_td, (b,), cfg.phi_min, phi_desc + 1),
        )
        tabu = jnp.where(onehot, (t + ten)[:, None], tabu)

        # ---- bookkeeping
        improved = curr > best_vs + 0.5
        best_vs = jnp.where(improved, curr, best_vs)
        best_xs = jnp.where(improved[:, None], xs, best_xs)
        omega = jnp.where(improved, 0, omega + 1)
        stag = jnp.where(improved, 0, stag + 1)
        # start an L-flip perturbation burst on stagnation (reference L
        # grows by 1 once omega passes T, BLS.py:93)
        trigger = ~perturbing & (stag >= t_stag)
        burst = jnp.int32(l0) + (omega > t_stag).astype(jnp.int32)
        pert_left = jnp.where(
            perturbing, jnp.maximum(pert_left - 1, 0),
            jnp.where(trigger, burst, 0),
        )
        stag = jnp.where(trigger, 0, stag)
        carry = (xs, gains, curr, best_xs, best_vs, tabu, omega, stag,
                 pert_left, t + 1)
        return carry, None

    @jax.jit
    def run_round(carry, k, adj_arg):
        # adj rides as a jit ARGUMENT (a closure constant would lower the
        # [N, N] matrix into the IR as a literal — 400 MB at G70 scale)
        ks = jax.random.split(k, cfg.steps_per_round)
        carry, _ = jax.lax.scan(
            lambda c, kk: step(adj_arg, c, kk), carry, ks
        )
        return carry, jnp.max(carry[4])

    gains0 = env.gains(xs)
    zeros_i = jnp.zeros((cfg.num_chains,), jnp.int32)
    carry = (
        xs,
        gains0,
        vs,
        xs,
        vs,
        jnp.zeros((cfg.num_chains, n), jnp.int32),
        zeros_i,
        zeros_i,
        zeros_i,
        jnp.int32(0),
    )
    best_hist = []
    t_start = time.time()
    for i, k in enumerate(jax.random.split(key, cfg.num_rounds)):
        carry, best = run_round(carry, k, adj)
        best_hist.append(float(best))
        if record is not None:
            record(i, best_hist[-1])
        if time_budget is not None and time.time() - t_start > time_budget:
            break
    best_xs, best_vs = carry[3], carry[4]
    b = int(jnp.argmax(best_vs))
    return np.asarray(best_xs[b]), float(best_vs[b]), best_hist
