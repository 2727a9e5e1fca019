"""MCPG's Bernoulli policy (Pattern II), in plain JAX.

BernoulliPolicy is MCPG's `Simpler` (`rlsolver/methods/MCPG.py:169-186`):
a free per-node logit vector mapped through sigmoid and squashed into
(0.2, 0.8) so no bit saturates. It keeps the flax calling convention —
`init(key) -> {"params": {"logits": [N]}}`, `apply(params) -> probs [N]` —
without depending on flax, so the MCPG path imports only JAX and optax.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class BernoulliPolicy:
    """Per-node Bernoulli probabilities, squashed to (lo, lo + span)."""

    num_nodes: int
    lo: float = 0.2
    span: float = 0.6

    def init(self, key: jax.Array) -> dict:
        del key  # zero logits: every bit starts at probability lo + span / 2
        return {"params": {"logits": jnp.zeros((self.num_nodes,), jnp.float32)}}

    def apply(self, params: dict) -> jax.Array:
        return jax.nn.sigmoid(params["params"]["logits"]) * self.span + self.lo
