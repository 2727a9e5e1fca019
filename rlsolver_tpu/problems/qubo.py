"""QUBO / Ising: batched energies and incremental Gauss-Seidel sweeps.

Reference counterpart: `rlsolver/methods/MCPG/sampling.py:325-370`
(`mcpg_sampling_qubo` — +-1 variables maximizing x^T Q x with a sequential
coordinate sweep `x_i <- sign((Qx)_i)`; `mcpg_sampling_qubo_bin` — binary
variables with threshold `-(Q_ii)/2`) and `dataloader.py:278-293`
(`qubo_dataloader` — dense Q matrix from text).

Accelerator-first redesign: the sweep keeps the field `h = x @ Q` incrementally
(rank-1 row update per coordinate) instead of recomputing a full matvec per
variable, and runs as one `lax.scan` over coordinates with all chains
batched — O(B*N) per step, O(B*N^2) per sweep, all dense vector and matmul work.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def read_qubo(path: str) -> np.ndarray:
    """Dense Q from whitespace/comma text, one row per line
    (`qubo_dataloader` format)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.replace(",", " ").strip()
            if not line:
                continue
            rows.append([float(x) for x in line.split()])
    q = np.asarray(rows, np.float64)
    if q.shape[0] != q.shape[1]:
        raise ValueError(f"Q must be square, got {q.shape}")
    return q


class QuboEnv:
    """Static Q + pure jittable objectives/sweeps. Maximizes x^T Q x
    (the reference's sign convention, `sampling.py:338-344`)."""

    def __init__(self, q: np.ndarray, dtype=jnp.float32):
        q = np.asarray(q)
        self.num_vars = q.shape[0]
        self.q = jnp.asarray((q + q.T) / 2.0, dtype)  # symmetrize
        self.q_diag = jnp.diagonal(self.q)

    # ---------------------------------------------------------------- spins
    def obj_pm(self, spins: jax.Array) -> jax.Array:
        """x in {-1,+1}: x^T Q x, f32 [B]."""
        s = spins.astype(jnp.float32)
        return jnp.einsum("bi,ij,bj->b", s, self.q, s)

    def sweep_pm(self, spins: jax.Array, num_sweeps: int = 1) -> jax.Array:
        """`x_i <- sign(sum_{j!=i} Q_ij x_j)` sequentially over coordinates
        (`mcpg_sampling_qubo` inner loop), with incremental field updates."""
        s = spins.astype(jnp.float32)
        h = s @ self.q  # [B, N] field including self term

        def step(carry, i):
            s, h = carry
            field = h[:, i] - self.q_diag[i] * s[:, i]  # exclude self
            new = jnp.where(field > 0, 1.0, -1.0)
            delta = new - s[:, i]
            h = h + delta[:, None] * self.q[i][None, :]
            s = s.at[:, i].set(new)
            return (s, h), None

        order = jnp.tile(jnp.arange(self.num_vars), num_sweeps)
        (s, _), _ = jax.lax.scan(step, (s, h), order)
        return s

    # --------------------------------------------------------------- binary
    def obj_bin(self, bits: jax.Array) -> jax.Array:
        """x in {0,1}: x^T Q x, f32 [B] (`mcpg_sampling_qubo_bin`)."""
        x = bits.astype(jnp.float32)
        return jnp.einsum("bi,ij,bj->b", x, self.q, x)

    def sweep_bin(self, bits: jax.Array, num_sweeps: int = 1) -> jax.Array:
        """`x_i <- [sum_{j!=i} Q_ij x_j > -Q_ii/2]` sequentially."""
        x = bits.astype(jnp.float32)
        h = x @ self.q

        def step(carry, i):
            x, h = carry
            field = h[:, i] - self.q_diag[i] * x[:, i]
            new = (field > -self.q_diag[i] / 2.0).astype(jnp.float32)
            delta = new - x[:, i]
            h = h + delta[:, None] * self.q[i][None, :]
            x = x.at[:, i].set(new)
            return (x, h), None

        order = jnp.tile(jnp.arange(self.num_vars), num_sweeps)
        (x, _), _ = jax.lax.scan(step, (x, h), order)
        return x > 0.5


def maxcut_to_qubo(adjacency: np.ndarray) -> np.ndarray:
    """Maxcut as +-1 QUBO: cut(x) = (W - x^T A x / 2) / 2 with W = total
    weight, so maximizing x^T (-A) x maximizes the cut (the PISCO dense
    formulation, `envs/env_ISCO.py:436-444`)."""
    return -np.asarray(adjacency, np.float64)
