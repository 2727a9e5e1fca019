"""L2A's `PolicyMLP` (`rlsolver/methods/L2A/network.py:124-143`): maps the
current solution-probability vector to a refined one."""

from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax


class PolicyMLP(nn.Module):
    """Solution-probability refiner: [B, N] -> [B, N] in (0, 1)."""

    num_nodes: int
    hidden: Sequence[int] = (256, 256)

    @nn.compact
    def __call__(self, probs: jax.Array) -> jax.Array:
        x = probs
        for i, width in enumerate(self.hidden):
            x = nn.relu(nn.Dense(width, name=f"hidden_{i}")(x))
        x = nn.Dense(self.num_nodes, name="out")(x)
        return nn.sigmoid(x)
