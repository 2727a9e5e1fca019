"""Attention model (AM) encoder-decoder for TSP with POMO multi-start.

Reference counterpart: `rlsolver/methods/attention_model/AM_TSP/models.py`
(`AutoregressiveTSP` — 3 attention encoder layers over city coords, context
query = graph mean + current + first node embeddings, cross-attention over
encodings, logits = C * tanh(enc . ctx / sqrt(D)) with visited-mask) and
`layers.py` (attention layers with 512-wide FF).

Accelerator-first: one flax module with separate `encode` (runs once per instance,
shared across the POMO axis) and `decode_step` (runs inside the rollout
`lax.scan`); all POMO starts are a batched axis, never physically expanded
per step (the reference's "structured batching", `trainer.py:38-49`).
Normalization is LayerNorm (instead of the reference's BatchNorm) — batch
statistics inside a jitted scan are an anti-pattern under jit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np


class EncoderLayer(nn.Module):
    """MHA + residual + LN, then 512-FF + residual + LN (`layers.py`)."""

    embed_dim: int = 128
    num_heads: int = 4
    ff_hidden: int = 512

    @nn.compact
    def __call__(self, h: jax.Array) -> jax.Array:
        attn = nn.MultiHeadDotProductAttention(
            num_heads=self.num_heads, qkv_features=self.embed_dim, name="mha"
        )(h, h)
        h = nn.LayerNorm(name="ln1")(h + attn)
        ff = nn.Dense(self.embed_dim, name="ff2")(
            nn.relu(nn.Dense(self.ff_hidden, name="ff1")(h))
        )
        return nn.LayerNorm(name="ln2")(h + ff)


class AttentionTSP(nn.Module):
    """AM encoder + POMO-aware single-step decoder."""

    embed_dim: int = 128
    num_heads: int = 4
    num_layers: int = 3
    logit_clip: float = 10.0  # "C" (`models.py:60`)

    @nn.compact
    def __call__(
        self,
        nodes: jax.Array,  # [B, N, 2]
        current: Optional[jax.Array],  # [B, P] int32 or None (first step)
        first: Optional[jax.Array],  # [B, P] int32 or None
        mask: jax.Array,  # [B, P, N] bool, True = allowed
        encoded: Optional[jax.Array] = None,  # [B, N, D] shared encoding
    ) -> Tuple[jax.Array, jax.Array]:
        """Returns (logits [B, P, N], encoded [B, N, D])."""
        if encoded is None:
            h = nn.Dense(self.embed_dim, name="embed")(nodes)
            for i in range(self.num_layers):
                h = EncoderLayer(
                    self.embed_dim, self.num_heads, name=f"enc{i}"
                )(h)
            encoded = h

        b, p, n = mask.shape
        h_mean = encoded.mean(axis=1)  # [B, D]
        query = nn.Dense(self.embed_dim, name="ctx")(h_mean)[:, None, :]
        query = jnp.broadcast_to(query, (b, p, self.embed_dim))
        bidx = jnp.arange(b)[:, None]
        if current is not None:
            cur_h = encoded[bidx, current]  # [B, P, D]
            query = query + nn.Dense(self.embed_dim, name="cur")(cur_h)
        if first is not None:
            first_h = encoded[bidx, first]
            query = query + nn.Dense(self.embed_dim, name="fst")(first_h)

        ctx = nn.MultiHeadDotProductAttention(
            num_heads=self.num_heads, qkv_features=self.embed_dim, name="xattn"
        )(query, encoded, mask=mask[:, None, :, :])  # [B, P, D]
        ctx = nn.Dense(self.embed_dim, name="out")(ctx)

        logits = jnp.einsum("bnd,bpd->bpn", encoded, ctx) / np.sqrt(self.embed_dim)
        logits = self.logit_clip * jnp.tanh(logits)
        return jnp.where(mask, logits, -1e4), encoded

    def encode(self, nodes: jax.Array) -> jax.Array:
        """Encoder only — used once per instance before the rollout scan."""
        b, n, _ = nodes.shape
        dummy_mask = jnp.ones((b, 1, n), bool)
        _, encoded = self(nodes, None, None, dummy_mask, None)
        return encoded
