"""Cheeger-cut (conductance) objectives and batched local search.

Reference counterpart: `rlsolver/methods/MCPG/sampling.py:184-251`
(`mcpg_sampling_rcheegercut` / `mcpg_sampling_ncheegercut`): minimize
  ratio  cheeger: cut(S) / min(|S|, n - |S|)
  normal cheeger: cut(S) * (1/|S| + 1/(n - |S|))
with a sequential degree-ordered flip sweep maintaining (cut, |S|)
incrementally, rejecting flips that empty either side.

Accelerator-first: the sweep is a `lax.scan` over nodes in degree order; the
per-node cut change uses the padded neighbor table — all chains batched.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rlsolver_tpu.core.graph import Graph


class CheegerEnv:
    def __init__(self, graph: Graph, normalized: bool = False):
        self.graph = graph
        self.num_nodes = graph.num_nodes
        self.normalized = normalized
        nbrs, nbr_w, deg = graph.padded_neighbors()
        # sentinel row: gathered padded neighbors contribute weight 0
        self.nbrs = jnp.asarray(nbrs)
        self.nbr_w = jnp.asarray(nbr_w)
        self.wdeg = jnp.asarray(graph.weighted_degrees())
        self.order = jnp.asarray(graph.degree_sorted_nodes())
        e0, e1, w = graph.edge_arrays()
        self.e0, self.e1, self.ew = jnp.asarray(e0), jnp.asarray(e1), jnp.asarray(w)

    def _ratio(self, cut: jax.Array, size: jax.Array) -> jax.Array:
        n = self.num_nodes
        if self.normalized:
            return cut * (1.0 / size + 1.0 / (n - size))
        return cut / jnp.minimum(size, n - size)

    def cut_and_size(self, bits: jax.Array) -> Tuple[jax.Array, jax.Array]:
        x0 = bits[:, self.e0]
        x1 = bits[:, self.e1]
        cut = ((x0 ^ x1) * self.ew[None]).sum(axis=1)
        return cut, bits.sum(axis=1).astype(jnp.float32)

    def obj(self, bits: jax.Array) -> jax.Array:
        """Cheeger ratio, f32 [B] (minimize; inf when one side is empty)."""
        cut, size = self.cut_and_size(bits)
        ok = (size > 0) & (size < self.num_nodes)
        return jnp.where(ok, self._ratio(cut, size), jnp.inf)

    def seed_bits(self, num_chains: int) -> jax.Array:
        """Reference chain init (`sampling.py:8-15`): chain i starts with
        only the i-th highest-degree node inside S."""
        idx = self.order[jnp.arange(num_chains) % self.num_nodes]
        return jnp.zeros((num_chains, self.num_nodes), bool).at[
            jnp.arange(num_chains), idx
        ].set(True)

    def sweep(self, bits: jax.Array, num_sweeps: int = 1) -> jax.Array:
        """Degree-ordered sequential sweep with incremental (cut, |S|)
        (reference inner loop `sampling.py:199-214`): flip node v when the
        ratio strictly improves and both sides stay non-empty."""
        x = bits.astype(jnp.float32)
        cut, size = self.cut_and_size(bits)
        ratio = self._ratio(cut, size)

        def step(carry, v):
            x, cut, size, ratio = carry
            nbr_in_s = (x[:, self.nbrs[v]] * self.nbr_w[v][None]).sum(axis=1)  # [B]
            sv = x[:, v]
            # flipping v: cut' = cut - (2 x_v - 1) * (wdeg_v - 2 * nbr_in_S)
            new_cut = cut - (2.0 * sv - 1.0) * (self.wdeg[v] - 2.0 * nbr_in_s)
            new_size = size - (2.0 * sv - 1.0)
            valid = (new_size > 0.5) & (new_size < self.num_nodes - 0.5)
            new_ratio = jnp.where(valid, self._ratio(new_cut, new_size), jnp.inf)
            accept = new_ratio < ratio
            # x carries a sentinel column (index num_nodes) for padded
            # neighbor gathers; v < num_nodes so it is never flipped
            x = jnp.where(
                accept[:, None] & (jnp.arange(x.shape[1])[None] == v), 1.0 - x, x
            )
            cut = jnp.where(accept, new_cut, cut)
            size = jnp.where(accept, new_size, size)
            ratio = jnp.where(accept, new_ratio, ratio)
            return (x, cut, size, ratio), None

        # append a sentinel column for the padded-neighbor gather
        x = jnp.concatenate([x, jnp.zeros((x.shape[0], 1))], axis=1)
        order = jnp.tile(self.order, num_sweeps)
        (x, cut, size, ratio), _ = jax.lax.scan(step, (x, cut, size, ratio), order)
        return x[:, : self.num_nodes] > 0.5
