"""S2V constructive maxcut policy for the REINFORCE/baseline zoo.

Reference counterpart: the vendored rl4co S2V model zoo —
`rlsolver/methods/ECO_S2V/rl4co/models/zoo/S2V/{model,policy,encoder,decoder}.py`
— an autoregressive constructive policy (encoder embeds the instance once,
the decoder picks one node per step) trained through
`models/rl/reinforce/reinforce.py` with the baseline family.

Accelerator-first redesign: the encoder is a structure2vec message-passing stack
(dense adjacency matmuls on the tensor cores, Dai et al. 2017 — the "S2V" in
S2V-DQN), the decoder is a per-step masked pointer head, and the whole
construction episode is ONE `lax.scan` inside the jitted train step — no
per-step host round trips. Construction semantics: all nodes start on side
0; each step moves one not-yet-moved node to side 1; after `horizon` steps
the reward is the cut value. Works on batched dense adjacencies of a fixed
N (distribution training), so one compiled program serves every sampled
graph.
"""

from __future__ import annotations

from typing import Optional, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp


class S2VEncoder(nn.Module):
    """structure2vec embedding over a dense adjacency: per layer
    h <- relu(W1 x + W2 (A h) + W3 (A 1)) — neighbor aggregation is a
    dense [B, N, N] @ [B, N, D] matmul (matmul-shaped)."""

    embed_dim: int = 64
    num_layers: int = 3

    @nn.compact
    def __call__(self, adj: jax.Array) -> jax.Array:  # [B, N, N] -> [B, N, D]
        deg = adj.sum(axis=-1, keepdims=True)  # [B, N, 1] weighted degree
        deg_n = deg / jnp.maximum(deg.mean(axis=1, keepdims=True), 1e-6)
        x = jnp.concatenate([deg_n, jnp.ones_like(deg_n)], axis=-1)
        h = nn.Dense(self.embed_dim)(x)
        for _ in range(self.num_layers):
            agg = jnp.einsum("bij,bjd->bid", adj, h) / jnp.maximum(deg, 1.0)
            # LayerNorm keeps activations O(1) so the decoder's tanh heads
            # stay in their linear region (the reference zoo normalizes
            # every encoder layer, `zoo/S2V/policy.py:normalization`)
            h = nn.LayerNorm()(
                nn.relu(
                    nn.Dense(self.embed_dim)(h)
                    + nn.Dense(self.embed_dim)(agg)
                    + nn.Dense(self.embed_dim)(deg_n)
                )
            )
        return h


class S2VConstructivePolicy(nn.Module):
    """Encoder + pointer decoder; call `rollout_s2v_maxcut` to run it."""

    embed_dim: int = 64
    num_layers: int = 3

    def setup(self):
        self.encoder = S2VEncoder(self.embed_dim, self.num_layers)
        self.dec_node = nn.Dense(self.embed_dim)
        self.dec_state = nn.Dense(self.embed_dim)
        self.dec_out = nn.Dense(1)

    def encode(self, adj: jax.Array) -> jax.Array:
        return self.encoder(adj)

    def decode_logits(
        self, h: jax.Array, assigned: jax.Array, adj: jax.Array
    ) -> jax.Array:
        """Per-node selection logits. h [B, N, D] static embeddings;
        assigned [B, N] current side bits; returns [B, N]."""
        side = assigned.astype(jnp.float32)
        # dynamic context: mean embedding of each side + cut-frontier degree
        # (weight of edges from each node into side 1 — the marginal gain
        # signal S2V-DQN feeds its Q head)
        cnt1 = jnp.maximum(side.sum(axis=1, keepdims=True), 1.0)  # [B, 1]
        mean1 = jnp.einsum("bn,bnd->bd", side, h) / cnt1
        frontier = jnp.einsum("bij,bj->bi", adj, side)  # [B, N]
        deg = jnp.maximum(adj.sum(axis=-1), 1.0)
        # normalized marginal gain of moving v to side 1 now:
        # (deg - 2 * frontier) / deg in [-1, 1] — the same hand-computed
        # observable S2V-DQN feeds its Q head (`spinsystem.py` immediate
        # cut change); giving it to the decoder makes "greedy construction"
        # a 1-parameter policy the REINFORCE loop can find quickly
        gain = (deg - 2.0 * frontier) / deg
        ctx = jnp.concatenate(
            [
                jnp.broadcast_to(mean1[:, None, :], h.shape),
                gain[..., None],
                side[..., None],
            ],
            axis=-1,
        )
        z = nn.tanh(self.dec_node(h) + self.dec_state(ctx))
        # rl4co tanh_clipping=10 (`zoo/S2V/policy.py:tanh_clipping`): bounded
        # logits keep the softmax off the one-hot boundary, where the
        # REINFORCE gradient is exactly zero (deterministic collapse)
        return 10.0 * jnp.tanh(self.dec_out(z)[..., 0])  # [B, N]

    def __call__(self, adj: jax.Array) -> jax.Array:
        """Init path: encode + one decode (parameter shapes only)."""
        h = self.encode(adj)
        assigned = jnp.zeros(adj.shape[:2], bool)
        return self.decode_logits(h, assigned, adj)


def cut_value_dense(xs: jax.Array, adj: jax.Array) -> jax.Array:
    """Cut of bool xs [B, N] on dense adj [B, N, N], f32 [B]."""
    s = jnp.where(xs, 1.0, -1.0)
    quad = jnp.einsum("bi,bij,bj->b", s, adj, s)
    w_total = adj.sum(axis=(1, 2)) / 2.0
    return (w_total - quad / 2.0) / 2.0


def rollout_s2v_maxcut(
    model: S2VConstructivePolicy,
    params,
    key: jax.Array,
    adj: jax.Array,
    horizon: Optional[int] = None,
    greedy: bool = False,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Construct solutions autoregressively; returns (xs [B, N] bool,
    logp [B], rewards [B] = cut values). `greedy=True` takes argmax
    (rl4co `val_decode_type="greedy"`)."""
    b, n = adj.shape[0], adj.shape[1]
    horizon = horizon or n // 2
    h = model.apply(params, adj, method=model.encode)

    def step(carry, k):
        assigned, logp = carry
        logits = model.apply(params, h, assigned, adj, method=model.decode_logits)
        logits = jnp.where(assigned, -jnp.inf, logits)  # each node moves once
        if greedy:
            pick = jnp.argmax(logits, axis=1)
        else:
            pick = jax.random.categorical(k, logits, axis=1)
        logp_t = jax.nn.log_softmax(logits, axis=1)[jnp.arange(b), pick]
        assigned = assigned | (jnp.arange(n)[None, :] == pick[:, None])
        return (assigned, logp + logp_t), None

    init = (jnp.zeros((b, n), bool), jnp.zeros((b,), jnp.float32))
    (xs, logp), _ = jax.lax.scan(step, init, jax.random.split(key, horizon))
    return xs, logp, cut_value_dense(xs, adj)
