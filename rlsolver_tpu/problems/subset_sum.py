"""Portfolio-allocation subset-sum problem: batched objective + sweeps.

Reference counterpart:
`rlsolver/methods_problem_specific/portfolio_allocation/` —
`subset_sum_simulator.py` (`SimulatorSubsetSum.calculate_obj_values`:
maximize lamb . [num_selected, |sum of selected amounts|, ...], default
lamb = [1, -1]; amounts read from csv as integer cents;
`SimulatorSubsetSumWithTag` adds per-tag balance terms — README shows
lamb [[1, -1, -1, -77]]) and `subset_sum_local_search.py`
(`search_and_evaluate_local_search` with optional REINFORCE policy =
the MCPG pattern, wired here through
`rlsolver_tpu.algos.mcpg_multi.subset_sum_problem`).

Accelerator-first: the objective is one masked matvec; the local-search sweep keeps
the running sums incrementally and scans items — all chains batched.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def read_amounts_csv(path: str) -> np.ndarray:
    """CSV with a header; amounts in column 1, stored as integer cents
    (`read_amount` `subset_sum_simulator.py:10-25`)."""
    with open(path) as f:
        lines = f.readlines()[1:]
    amounts = np.asarray([float(l.split(",")[1]) for l in lines], np.float64)
    return np.rint(amounts * 100).astype(np.int64)


class SubsetSumEnv:
    """Maximize  count(x) - |sum(amount * x)| - sum_g |sum(tag_g * x)|.

    `tags` (optional) assigns each item a group; each group's signed amount
    sum is penalized like the global one (the WithTag variant). `lamb`
    weights the component vector [count, |total|, |tag_0|, ...].
    """

    def __init__(
        self,
        amounts: np.ndarray,
        tags: Optional[Sequence[int]] = None,
        lamb: Optional[Sequence[float]] = None,
    ):
        self.amounts = jnp.asarray(np.asarray(amounts, np.float32))
        self.num_items = int(self.amounts.shape[0])
        if tags is not None:
            tags = np.asarray(tags)
            self.num_tags = int(tags.max()) + 1
            onehot = np.zeros((self.num_tags, self.num_items), np.float32)
            onehot[tags, np.arange(self.num_items)] = 1.0
            self.tag_amounts = jnp.asarray(onehot * np.asarray(amounts, np.float32))
        else:
            self.num_tags = 0
            self.tag_amounts = None
        if lamb is None:
            lamb = [1.0, -1.0] + [-1.0] * self.num_tags
        self.lamb = jnp.asarray(np.asarray(lamb, np.float32))

    def components(self, bits: jax.Array) -> jax.Array:
        """[B, 2 + num_tags]: count, |total|, per-tag |sums|."""
        x = bits.astype(jnp.float32)
        count = x.sum(axis=1)
        total = jnp.abs(x @ self.amounts)
        cols = [count, total]
        if self.tag_amounts is not None:
            cols += [jnp.abs(x @ ta) for ta in self.tag_amounts]
        return jnp.stack(cols, axis=1)

    def obj(self, bits: jax.Array) -> jax.Array:
        """lamb-weighted objective, f32 [B] (maximize)."""
        return self.components(bits) @ self.lamb

    def random_bits(self, key: jax.Array, num_chains: int) -> jax.Array:
        return jax.random.bernoulli(key, 0.5, (num_chains, self.num_items))

    def sweep(self, bits: jax.Array, num_sweeps: int = 1) -> jax.Array:
        """Greedy 1-flip sweep with incremental signed sums."""
        x = bits.astype(jnp.float32)
        total = x @ self.amounts  # signed, [B]
        count = x.sum(axis=1)
        if self.tag_amounts is not None:
            tag_tot = jnp.stack([x @ ta for ta in self.tag_amounts], axis=1)  # [B, T]
        else:
            tag_tot = jnp.zeros((x.shape[0], 0))

        def score(count, total, tag_tot):
            s = self.lamb[0] * count + self.lamb[1] * jnp.abs(total)
            if self.num_tags:
                s = s + tag_tot_abs_weighted(tag_tot)
            return s

        def tag_tot_abs_weighted(tt):
            return jnp.abs(tt) @ self.lamb[2:]

        def step(carry, i):
            x, count, total, tag_tot, cur = carry
            xi = x[:, i]
            d = 1.0 - 2.0 * xi  # flip direction
            n_count = count + d
            n_total = total + d * self.amounts[i]
            if self.num_tags:
                n_tag = tag_tot + d[:, None] * jnp.stack(
                    [ta[i] for ta in self.tag_amounts]
                )[None, :]
            else:
                n_tag = tag_tot
            new = score(n_count, n_total, n_tag)
            accept = new > cur
            x = jnp.where(
                accept[:, None] & (jnp.arange(self.num_items)[None] == i), 1.0 - x, x
            )
            count = jnp.where(accept, n_count, count)
            total = jnp.where(accept, n_total, total)
            tag_tot = jnp.where(accept[:, None], n_tag, tag_tot)
            cur = jnp.where(accept, new, cur)
            return (x, count, total, tag_tot, cur), None

        cur = score(count, total, tag_tot)
        order = jnp.tile(jnp.arange(self.num_items), num_sweeps)
        (x, _, _, _, _), _ = jax.lax.scan(step, (x, count, total, tag_tot, cur), order)
        return x > 0.5


def subset_sum_problem(env: SubsetSumEnv, num_sweeps: int = 2):
    """MCPG adapter (`subset_sum_local_search.py` if_reinforce path)."""
    from rlsolver_tpu.algos.mcpg_multi import McpgProblem

    return McpgProblem(
        num_vars=env.num_items,
        score=env.obj,
        improve=lambda k, bits: env.sweep(bits, num_sweeps=num_sweeps),
    )
