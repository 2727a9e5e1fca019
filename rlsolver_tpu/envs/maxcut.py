"""Pattern-II batched maxcut environment (policy-vector / QUBO methods).

The canonical vectorized simulator of the reference
(`rlsolver/envs/env_L2A.py:24-116`, replicated in env_MCPG/env_k_spin/
env_PPO), redesigned for accelerators:

  * state is `xs: bool[num_sims, num_nodes]`, a pure value — no in-place
    tensors, no lazily re-broadcast index tensors;
  * the objective is one matmul (dense) or an edge gather (sparse),
    see `rlsolver_tpu.ops.cut`;
  * local search keeps flip gains *incrementally* (rank-1 updates) instead of
    recomputing per-node objective sums, and runs entirely inside jit.

Reference semantics preserved exactly (validated by tests):
  * `random_xs` pins node 0 to False to break the cut symmetry
    (`env_L2A.py:82-85`);
  * `local_search` = noisy top-k multi-flip x num_iters with elitist accepts,
    followed by a sequential 1-flip sweep over all nodes
    (`env_L2A.py:87-116`);
  * objective values are integral for integer-weight graphs.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rlsolver_tpu.core.graph import Graph
from rlsolver_tpu.ops import cut as cut_ops
from rlsolver_tpu.ops.reductions import update_xs_by_vs


class MaxcutEnv:
    """Static per-instance data + pure jittable methods.

    All methods are functionally pure; `self` only stores device constants,
    so methods can be wrapped in `jax.jit` / `shard_map` freely.
    """

    def __init__(
        self,
        graph: Graph,
        dtype=jnp.bfloat16,
        mode: str = "auto",
    ):
        self.graph = graph
        self.num_nodes = graph.num_nodes
        self.num_edges = graph.num_edges
        self.mode = mode
        with_dense = mode != "sparse"
        self.cg = cut_ops.CutGraph.build(graph, dtype=dtype, with_dense=with_dense)
        self.if_maximize = True

    # ------------------------------------------------------------------ state
    def random_xs(self, key: jax.Array, num_sims: int) -> jax.Array:
        xs = jax.random.bernoulli(key, 0.5, (num_sims, self.num_nodes))
        return xs.at[:, 0].set(False)

    # -------------------------------------------------------------- objective
    def obj(self, xs: jax.Array) -> jax.Array:
        """Cut values, f32 [B] (integral for integer-weight graphs)."""
        return cut_ops.cut_value(xs, self.cg, self.mode)

    def gains(self, xs: jax.Array) -> jax.Array:
        """Per-node flip gains, f32 [B, N]."""
        return cut_ops.flip_gains(xs, self.cg, self.mode)

    def node_contrib(self, xs: jax.Array) -> jax.Array:
        """Per-node cut contributions (slow-twin parity with
        `calculate_obj_values_for_loop`)."""
        if self.cg.adj is not None and self.mode != "sparse":
            return cut_ops.node_cut_contrib_dense(xs, self.cg)
        return cut_ops.node_cut_contrib_sparse(xs, self.cg)

    # ------------------------------------------------------------ local search
    def local_search(
        self,
        key: jax.Array,
        xs: jax.Array,
        vs: Optional[jax.Array] = None,
        num_iters: int = 8,
        num_spin: int = 8,
        noise_std: float = 0.3,
    ) -> Tuple[jax.Array, jax.Array]:
        """Reference `local_search_inplace` semantics, pure-functional.

        Phase 1 (`env_L2A.py:92-107`): draw a per-(sim, node) acceptance
        threshold as the `num_spin`-th largest noise-perturbed gain, then
        `num_iters` times flip all nodes whose freshly-perturbed gain exceeds
        the threshold and keep the batch if it improves.

        Phase 2 (`env_L2A.py:110-115`): exhaustive sequential 1-flip sweep
        over all nodes — here with incremental gain maintenance instead of a
        full objective recompute per node.
        """
        if vs is None:
            vs = self.obj(xs)
        gains = self.gains(xs)  # "ws" in the reference
        rng_std = (
            (jnp.max(gains, axis=0, keepdims=True) - jnp.min(gains, axis=0, keepdims=True))
            * noise_std
        )  # [1, N] — per-node spread across sims, as in the reference
        key, k0 = jax.random.split(key)
        noisy0 = gains + jax.random.normal(k0, gains.shape) * rng_std
        k_small = self.num_nodes - num_spin  # torch.kthvalue is 1-based smallest
        thresh = jnp.sort(noisy0, axis=1)[:, k_small - 1][:, None]  # [B, 1]

        def flip_iter(carry, k):
            good_xs, good_vs = carry
            noisy = gains + jax.random.normal(k, gains.shape) * rng_std
            mask = noisy > thresh
            xs_try = jnp.logical_xor(good_xs, mask)
            vs_try = self.obj(xs_try)
            good_xs, good_vs = update_xs_by_vs(good_xs, good_vs, xs_try, vs_try)
            return (good_xs, good_vs), None

        (xs, vs), _ = jax.lax.scan(flip_iter, (xs, vs), jax.random.split(key, num_iters))
        xs, vs = self.sweep_1flip(xs, vs)
        return xs, vs

    def sweep_1flip(self, xs: jax.Array, vs: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """One sequential greedy 1-flip sweep over all nodes (all sims in
        parallel), with rank-1 incremental gain updates. Strict-improvement
        accepts match `update_xs_by_vs`. Sign convention: bit 1 -> sign +1."""
        if self.cg.adj is None:
            raise NotImplementedError("sweep_1flip needs the dense adjacency")
        s = cut_ops.signs_from_bits(xs, jnp.float32)
        gains = self.gains(xs)

        def body(i, carry):
            s, gains, vs = carry
            g_i = gains[:, i]  # [B]
            accept = g_i > 0.0
            row = self.cg.adj[i, :].astype(jnp.float32)  # [N]
            s_i = s[:, i]
            delta = -2.0 * (s_i * accept)[:, None] * s * row[None, :]
            gains_new = gains + delta
            gains_new = gains_new.at[:, i].set(jnp.where(accept, -g_i, g_i))
            s_new = s.at[:, i].set(jnp.where(accept, -s_i, s_i))
            vs_new = vs + jnp.where(accept, g_i, 0.0)
            return s_new, gains_new, vs_new

        s, gains, vs = jax.lax.fori_loop(0, self.num_nodes, body, (s, gains, vs))
        return s > 0.0, vs
