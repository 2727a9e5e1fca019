"""Message-passing Q-network for Pattern-I node-selection methods.

Capability-equivalent redesign of the reference MPNN
(`rlsolver/networks/mpnn.py:6-178`): per-node observations are embedded,
refined by `n_layers` rounds of degree-normalized neighborhood aggregation,
and read out to one Q-value per node with a global mean-pooled context.

Accelerator-first differences from the reference (deliberate, not drift):
  * the reference materializes a [B, N, N, obs+1] per-edge feature tensor for
    its edge-embedding layer; here the edge context is computed as
    degree-normalized matmul aggregation of neighbor input features plus a
    normalized-degree channel — identical information flow, O(N^2) matmul
    work on the tensor cores instead of O(N^2 * obs) device-memory traffic;
  * the adjacency is an explicit argument (static per instance), not packed
    inside the observation tensor (`mpnn.py:53-55`);
  * computation can run in bfloat16 (the reference's `use_tensor_core` fp16
    path, `mpnn.py:55-58`) via the `dtype` attribute.
"""

from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax
import jax.numpy as jnp


class MPNN(nn.Module):
    features: int = 64
    n_layers: int = 3
    tied_weights: bool = False
    readout_hidden: Sequence[int] = ()
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, node_obs: jax.Array, adj: jax.Array) -> jax.Array:
        """node_obs: [B, N, obs]; adj: [N, N] (shared) or [B, N, N].

        Returns per-node Q values [B, N].
        """
        f = self.features
        dt = self.dtype
        node_obs = node_obs.astype(dt)
        adj = adj.astype(dt)
        if adj.ndim == 2:
            adj = adj[None]  # broadcast over batch

        deg = jnp.sum((adj != 0).astype(dt), axis=-1, keepdims=True)  # [b,N,1]
        norm = jnp.maximum(deg, 1.0)

        def agg(x):  # degree-normalized neighborhood sum -> [B, N, d]
            return jnp.matmul(adj, x, preferred_element_type=jnp.float32).astype(dt) / norm

        # Node init embedding (reference node_init_embedding_layer).
        h = nn.relu(nn.Dense(f, use_bias=False, dtype=dt, name="node_init")(node_obs))

        # Edge context (reference EdgeAndNodeEmbeddingLayer, reformulated):
        # aggregated neighbor input features + relative degree channel.
        agg_in = agg(node_obs)  # [B, N, obs]
        rel_deg = norm / jnp.max(norm, axis=-2, keepdims=True)
        e = nn.relu(
            nn.Dense(f - 1, use_bias=False, dtype=dt, name="edge_embed")(agg_in)
        )
        rel_deg = jnp.broadcast_to(rel_deg.astype(dt), e.shape[:-1] + (1,))
        e = nn.relu(
            nn.Dense(f, use_bias=False, dtype=dt, name="edge_feature")(
                jnp.concatenate([e, rel_deg], axis=-1)
            )
        )

        # Message-passing rounds (reference UpdateNodeEmbeddingLayer).
        def round_fn(h, idx):
            suffix = "" if self.tied_weights else f"_{idx}"
            m = nn.relu(
                nn.Dense(f, use_bias=False, dtype=dt, name=f"message{suffix}")(
                    jnp.concatenate([agg(h), e], axis=-1)
                )
            )
            return nn.relu(
                nn.Dense(f, use_bias=False, dtype=dt, name=f"update{suffix}")(
                    jnp.concatenate([h, m], axis=-1)
                )
            )

        for i in range(self.n_layers):
            h = round_fn(h, 0 if self.tied_weights else i)

        # Readout (reference ReadoutLayer): local + mean-pooled global context.
        pooled = nn.Dense(f, use_bias=False, dtype=dt, name="pool")(h.mean(axis=-2))
        g = jnp.broadcast_to(pooled[:, None, :], h.shape)
        z = nn.relu(jnp.concatenate([g, h], axis=-1))
        for k, width in enumerate(self.readout_hidden):
            z = nn.relu(nn.Dense(width, dtype=dt, name=f"readout_{k}")(z))
        q = nn.Dense(1, dtype=dt, name="readout_out")(z)
        return q[..., 0].astype(jnp.float32)
