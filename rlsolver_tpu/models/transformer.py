"""Graph-embedding transformer and the L2A policy/value cell.

Reference counterparts:
  * `GraphTRS` (`rlsolver/methods/L2A/network.py:9-69`): transformer
    auto-encoder over adjacency-matrix rows; its encoder output `seq_graph`
    is the frozen per-node graph embedding consumed by the policy. Pretrained
    by reconstructing the adjacency (`L2A/graph_embedding_pretrain.py`).
  * `TrsCell`/`TrsDecoderLayer` (`rlsolver/methods/L2A/transformer.py:51-155`):
    a decoder layer conditioned on `seq_graph` that maps the current solution
    (as per-node +-1 two-channel "probabilities") to refined per-node flip
    logits, plus a value head summed over nodes.

Notes: both are standard pre-norm-free transformer blocks built on
flax MHA (the reference's per-head group_concat interleaving is an artifact
of torch's packed MultiheadAttention and is not reproduced); all shapes are
batch-major [B, N, ...] rather than torch's seq-major.
"""

from __future__ import annotations

from typing import Optional, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp


def solution_to_prob_channels(xs: jax.Array) -> jax.Array:
    """bool [B, N] -> f32 [B, N, 2] with (+1, -1) channels (reference
    `convert_solution_to_prob`, transformer.py:41-48)."""
    s = jnp.where(xs, 1.0, -1.0)
    return jnp.stack([s, -s], axis=-1)


class ChunkedMHA(nn.Module):
    """Multi-head attention with a bounded score-tensor footprint.

    `nn.MultiHeadDotProductAttention` materializes f32[B, H, N, N] scores —
    16 GB for 256 sims at N = 2000 — which is what capped L2A's sim count
    on large instances. This computes the exact same attention with a
    `lax.map` over query chunks (full key axis per chunk, so softmax is
    exact, not an approximation): peak score memory is
    B * H * q_chunk * N * 4 bytes, bounded by `score_budget`.
    """

    num_heads: int
    score_budget: int = 1 << 28  # 256 MB of f32 scores per call

    @nn.compact
    def __call__(self, q_in: jax.Array, kv_in: jax.Array) -> jax.Array:
        d = q_in.shape[-1]
        h = self.num_heads
        dh = d // h
        q = nn.DenseGeneral((h, dh), name="query")(q_in)  # [B, N, H, dh]
        k = nn.DenseGeneral((h, dh), name="key")(kv_in)
        v = nn.DenseGeneral((h, dh), name="value")(kv_in)
        q = q / jnp.sqrt(dh).astype(q.dtype)
        b, n = q.shape[0], q.shape[1]

        def attend(qc):  # [B, qc, H, dh] -> [B, qc, H, dh]
            scores = jnp.einsum("bqhd,bkhd->bhqk", qc, k)
            w = jax.nn.softmax(scores, axis=-1)
            return jnp.einsum("bhqk,bkhd->bqhd", w, v)

        full_bytes = 4 * b * h * n * n
        if full_bytes <= self.score_budget:
            out = attend(q)
        else:
            qc = max(1, self.score_budget // (4 * b * h * n))
            nc = -(-n // qc)
            qc = -(-n // nc)
            pad = nc * qc - n
            qp = jnp.pad(q, ((0, 0), (0, pad), (0, 0), (0, 0)))
            qp = jnp.moveaxis(qp.reshape(b, nc, qc, h, dh), 1, 0)
            # checkpoint: without it autodiff stacks every chunk's [B, H,
            # qc, N] scores as residuals — the full N^2 tensor again, just
            # sliced — defeating the chunking under grad (L2A's PPO update)
            out = jax.lax.map(jax.checkpoint(attend), qp)  # [nc, B, qc, H, dh]
            out = jnp.moveaxis(out, 0, 1).reshape(b, nc * qc, h, dh)[:, :n]
        return nn.DenseGeneral(d, axis=(-2, -1), name="out")(out)


class _MLP(nn.Module):
    dims: tuple
    act: str = "gelu"

    @nn.compact
    def __call__(self, x):
        act = getattr(nn, self.act)
        for i, d in enumerate(self.dims[:-1]):
            x = act(nn.Dense(d, name=f"fc{i}")(x))
        return nn.Dense(self.dims[-1], name=f"fc{len(self.dims) - 1}")(x)


class EncoderBlock(nn.Module):
    embed_dim: int
    num_heads: int
    mlp_dim: int

    @nn.compact
    def __call__(self, x):
        h = nn.LayerNorm()(x)
        h = ChunkedMHA(num_heads=self.num_heads, name="attn")(h, h)
        x = x + h
        h = nn.LayerNorm()(x)
        h = nn.Dense(self.mlp_dim)(h)
        h = nn.gelu(h)
        h = nn.Dense(self.embed_dim)(h)
        return x + h


class GraphEncoder(nn.Module):
    """Adjacency rows -> per-node embeddings, with a reconstruction head.

    `embed(adj)` gives the frozen `seq_graph` features ([B, N, D], std-
    normalized as in the reference's `get_seq_graph` + layer_norm step,
    transformer.py:322-327); `__call__` additionally decodes the adjacency
    row for pretraining.
    """

    num_nodes: int
    embed_dim: int = 64
    num_heads: int = 4
    num_layers: int = 2
    mlp_dim: int = 256

    @nn.compact
    def __call__(self, adj_rows: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """adj_rows: f32 [B, N, N] -> (recon_logits [B, N, N], seq_graph [B, N, D])."""
        x = _MLP((self.num_nodes, self.mlp_dim, self.embed_dim), name="inp")(adj_rows)
        for i in range(self.num_layers):
            x = EncoderBlock(self.embed_dim, self.num_heads, self.mlp_dim, name=f"enc{i}")(x)
        seq_graph = _MLP((self.embed_dim, self.embed_dim), name="emb")(x)
        recon = _MLP((self.mlp_dim, self.num_nodes), name="dec")(seq_graph)
        return recon, seq_graph

    def embed(self, params, adj_rows: jax.Array) -> jax.Array:
        _, seq_graph = self.apply(params, adj_rows)
        return seq_graph / (jnp.std(seq_graph, axis=-1, keepdims=True) + 1e-6)


class PolicyTrs(nn.Module):
    """L2A policy/value cell: (solution channels, seq_graph) -> per-node
    flip logits + value. One decoder block (the reference trains with
    num_layers=1, `demo_instance.py:111`)."""

    embed_dim: int = 64
    num_heads: int = 4

    @nn.compact
    def __call__(
        self, prob_ch: jax.Array, seq_graph: jax.Array
    ) -> Tuple[jax.Array, jax.Array]:
        """prob_ch: [B, N, 2]; seq_graph: [N, D] (shared across sims).
        Returns (logits [B, N, 2], memory [B, N, D])."""
        b = prob_ch.shape[0]
        g = jnp.broadcast_to(seq_graph[None], (b,) + seq_graph.shape)
        p = nn.Dense(self.embed_dim // 4, name="prob_embed")(prob_ch)
        x = nn.Dense(self.embed_dim, name="mix")(jnp.concatenate([g, p], axis=-1))
        x = x + ChunkedMHA(num_heads=self.num_heads, name="self_attn")(x, x)
        x = x + ChunkedMHA(num_heads=self.num_heads, name="cross_attn")(x, x)
        memory = nn.Dense(self.embed_dim, name="mem_out")(nn.tanh(x))
        logits = nn.Dense(2, name="prob_out")(nn.tanh(x))
        return logits, memory

class PolicyTrsWithValue(nn.Module):
    """PolicyTrs plus the node-summed value head (reference `get_value`,
    transformer.py:147-149): value = MLP(memory) summed over nodes."""

    embed_dim: int = 64
    num_heads: int = 4

    def setup(self):
        self.cell = PolicyTrs(self.embed_dim, self.num_heads)
        self.value_mlp = _MLP((self.embed_dim, 1), act="tanh")

    def __call__(self, prob_ch, seq_graph):
        logits, memory = self.cell(prob_ch, seq_graph)
        value = self.value_mlp(nn.tanh(memory))[..., 0].sum(axis=-1)
        return logits, value

    def logits_value(self, xs, seq_graph):
        return self(solution_to_prob_channels(xs), seq_graph)

    def probs(self, xs, seq_graph):
        logits, _ = self(solution_to_prob_channels(xs), seq_graph)
        return jax.nn.softmax(logits, axis=-1)[..., 0]
