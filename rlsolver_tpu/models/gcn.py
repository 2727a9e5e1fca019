"""Graph convolutional networks (PI-GNN's node classifier, S2V_PPO's
actor-critic backbone).

Reference counterparts: `PIGNN/model.py:9-61` (GCN/GAT node classifier
trained on the relaxed QUBO loss) and `S2V_PPO/model.py` (torch_geometric
GCN actor-critic). Implemented as dense symmetric-normalized adjacency
matmuls (D^-1/2 (A+I) D^-1/2 · H · W) — matmul-friendly, no sparse gathers.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np

from rlsolver_tpu.core.graph import Graph


def normalized_adjacency(graph: Graph, self_loops: bool = True) -> np.ndarray:
    """Symmetric-normalized adjacency D^-1/2 (A [+ I]) D^-1/2, f32 [N, N]."""
    a = graph.adjacency_dense().astype(np.float64)
    if self_loops:
        a = a + np.eye(graph.num_nodes)
    d = a.sum(axis=1)
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(d, 1e-12))
    return (a * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]).astype(np.float32)


class GCN(nn.Module):
    """Stacked GCN layers -> per-node outputs [..., N, out_dim]."""

    hidden: Sequence[int] = (64,)
    out_dim: int = 1
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x: jax.Array, a_norm: jax.Array, deterministic: bool = True):
        """x: [..., N, F]; a_norm: [N, N] normalized adjacency."""
        for i, h in enumerate(self.hidden):
            x = jnp.matmul(a_norm, x, preferred_element_type=jnp.float32)
            x = nn.relu(nn.Dense(h, name=f"gcn{i}")(x))
            if self.dropout > 0:
                x = nn.Dropout(self.dropout, deterministic=deterministic)(x)
        x = jnp.matmul(a_norm, x, preferred_element_type=jnp.float32)
        return nn.Dense(self.out_dim, name="out")(x)


class GCNActorCritic(nn.Module):
    """Per-node policy logits + pooled state value (S2V_PPO's
    `PPOLinearModel` capability)."""

    hidden: Sequence[int] = (64, 64)

    @nn.compact
    def __call__(self, x: jax.Array, a_norm: jax.Array) -> Tuple[jax.Array, jax.Array]:
        h = x
        for i, width in enumerate(self.hidden):
            h = jnp.matmul(a_norm, h, preferred_element_type=jnp.float32)
            h = nn.relu(nn.Dense(width, name=f"gcn{i}")(h))
        logits = nn.Dense(1, name="actor")(h)[..., 0]  # [..., N]
        pooled = h.mean(axis=-2)
        value = nn.Dense(1, name="critic")(nn.relu(nn.Dense(64, name="vh")(pooled)))[..., 0]
        return logits, value
