"""Distribution-wise dREINFORCE/L2A: one policy across a graph family.

Reference counterpart: `rlsolver/methods/L2A/demo_distribution.py:25-500` —
identical to the instance-wise loop (`demo_instance.py`) except that every
reset samples a FRESH graph from the BA/ER/PL distribution, the graph
transformer embeds each new adjacency, and progress is tracked as the mean
best cut over 30 fixed seeded validation instances
(`demo_distribution.py:60,110-125`; `num_instances=30`). This is the
protocol behind the README's distribution-wise benchmark tables
(`Benchmark.rst:17-76`).

Every jitted function takes the dense adjacency as an ARGUMENT
(same [N, N] shape across the family), so training over thousands of
sampled graphs reuses one compiled program — no per-instance retrace.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from rlsolver_tpu.config import GraphType
from rlsolver_tpu.core.generate import generate_graph
from rlsolver_tpu.models.transformer import (
    GraphEncoder,
    PolicyTrsWithValue,
    solution_to_prob_channels,
)
from rlsolver_tpu.ops.counter_rng import seed_from_key
from rlsolver_tpu.ops.pallas.mcpg_sweep import WeightedSweepTables, mcpg_sweep_fused
from rlsolver_tpu.ops.reductions import update_xs_by_vs
from rlsolver_tpu.ops.sampling import sub_set_sampling


# --------------------------------------------------- adjacency-arg primitives
def _cut_value_adj(xs: jax.Array, adj: jax.Array) -> jax.Array:
    """Cut from a dense adjacency argument, f32 [B]:
    cut = (W - s A s / 2) / 2 with s in {-1, +1}, W = total weight."""
    s = jnp.where(xs, 1.0, -1.0)
    quad = jnp.einsum("bi,ij,bj->b", s, adj, s)
    w_total = adj.sum() / 2.0
    return (w_total - quad / 2.0) / 2.0


def flip_gains_adj(xs: jax.Array, adj: jax.Array) -> jax.Array:
    """Per-node cut gain of flipping, f32 [B, N]."""
    s = jnp.where(xs, 1.0, -1.0)
    field = s @ adj  # [B, N]
    return s * field


@dataclasses.dataclass
class L2ADistConfig:
    graph_type: GraphType = GraphType.BA
    num_nodes: int = 64
    num_sims: int = 128
    num_repeats: int = 4
    top_k: int = 8
    seq_len: int = 8
    num_iters: int = 20
    embed_dim: int = 32
    num_heads: int = 4
    pretrain_steps: int = 100
    pretrain_lr: float = 1e-3
    lr: float = 2e-4
    ls_sweeps: int = 1
    num_validation: int = 30  # fixed seeded instances (`num_instances=30`)
    seed: int = 0


def _sample_adj(cfg: L2ADistConfig, seed: int) -> jnp.ndarray:
    g = generate_graph(cfg.graph_type, cfg.num_nodes, seed=seed)
    return jnp.asarray(g.adjacency_dense())


def sweep_1flip_adj(xs: jax.Array, adj: jax.Array, num_sweeps: int = 1) -> jax.Array:
    """Greedy sequential 1-flip sweep with the adjacency as an argument."""
    s = jnp.where(xs, 1.0, -1.0)
    gains = s * (s @ adj)

    def body(i, carry):
        s, gains = carry
        g_i = gains[:, i]
        accept = g_i > 0.0
        row = adj[i, :]
        s_i = s[:, i]
        delta = -2.0 * (s_i * accept)[:, None] * s * row[None, :]
        gains = gains + delta
        gains = gains.at[:, i].set(jnp.where(accept, -g_i, g_i))
        s = s.at[:, i].set(jnp.where(accept, -s_i, s_i))
        return s, gains

    for _ in range(num_sweeps):
        s, gains = jax.lax.fori_loop(0, xs.shape[1], body, (s, gains))
    return s > 0.0


def pretrain_encoder_distribution(cfg: L2ADistConfig):
    """Adjacency auto-encoding over FRESH sampled graphs
    (`train_graph_net_in_graph_distribution`,
    `L2A/graph_embedding_pretrain.py:191`)."""
    enc = GraphEncoder(
        num_nodes=cfg.num_nodes, embed_dim=cfg.embed_dim, num_heads=cfg.num_heads
    )
    key = jax.random.PRNGKey(cfg.seed)
    adj0 = _sample_adj(cfg, 0)
    params = enc.init(key, adj0[None])
    opt = optax.adam(cfg.pretrain_lr)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, adj):
        def loss_fn(p):
            recon, _ = enc.apply(p, adj[None])
            return jnp.mean((recon - adj[None]) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for i in range(cfg.pretrain_steps):
        adj = _sample_adj(cfg, 10_000 + i)
        params, opt_state, loss = step(params, opt_state, adj)
        losses.append(float(loss))
    return enc, params, losses


def train_l2a_distribution(cfg: L2ADistConfig = L2ADistConfig()):
    """Returns (validate_fn results history, final params bundle)."""
    enc, enc_params, _ = pretrain_encoder_distribution(cfg)
    net = PolicyTrsWithValue(embed_dim=cfg.embed_dim, num_heads=cfg.num_heads)
    key = jax.random.PRNGKey(cfg.seed + 1)

    adj0 = _sample_adj(cfg, 0)
    seq0 = enc.embed(enc_params, adj0[None])[0]
    xs0 = jnp.zeros((cfg.num_sims, cfg.num_nodes), bool)
    key, k_init = jax.random.split(key)
    params = net.init(k_init, solution_to_prob_channels(xs0), seq0)
    optimizer = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(cfg.lr))
    opt_state = optimizer.init(params)

    @jax.jit
    def embed(adj):
        return enc.embed(enc_params, adj[None])[0]

    @jax.jit
    def improve_round(params, key, adj, seq_graph, xs, vs):
        """One policy-guided improvement: probs -> top-k resample ->
        sweep -> elitist accept. Returns (xs, vs, logp, reward)."""
        k_sample, k_ls = jax.random.split(key)
        logits, _ = net.apply(params, solution_to_prob_channels(xs), seq_graph)
        probs = jax.nn.softmax(logits, axis=-1)[..., 0]
        cand = sub_set_sampling(k_sample, probs, xs, cfg.num_repeats, cfg.top_k)
        cand = sweep_1flip_adj(cand, adj, cfg.ls_sweeps)
        cand_vs = _cut_value_adj(cand, adj)
        # best of repeats per sim
        vs_r = cand_vs.reshape(cfg.num_repeats, cfg.num_sims)
        rows = jnp.argmax(vs_r, axis=0) * cfg.num_sims + jnp.arange(cfg.num_sims)
        new_xs, new_vs = cand[rows], cand_vs[rows]
        xs2, vs2 = update_xs_by_vs(xs, vs, new_xs, new_vs)
        reward = vs2 - vs
        s = new_xs.astype(jnp.float32)
        p_rows = probs  # row b of new_xs came from sim b
        logp = jnp.log(jnp.clip(s * p_rows + (1 - s) * (1 - p_rows), 1e-8)).sum(axis=1)
        return xs2, vs2, logp, reward

    @jax.jit
    def update(params, opt_state, adj, seq_graph, xs, vs, key):
        def loss_fn(p):
            k = key
            total = 0.0
            xs_c, vs_c = xs, vs
            for t in range(cfg.seq_len):
                k = jax.random.fold_in(k, t)
                k_sample, _ = jax.random.split(k)
                logits, value = net.apply(p, solution_to_prob_channels(xs_c), seq_graph)
                probs = jax.nn.softmax(logits, axis=-1)[..., 0]
                cand = sub_set_sampling(k_sample, probs, xs_c, 1, cfg.top_k)
                cand = sweep_1flip_adj(cand, adj, cfg.ls_sweeps)
                cand_vs = _cut_value_adj(cand, adj)
                xs_new, vs_new = update_xs_by_vs(xs_c, vs_c, cand, cand_vs)
                reward = vs_new - vs_c
                s = jax.lax.stop_gradient(cand.astype(jnp.float32))
                logp = jnp.log(jnp.clip(s * probs + (1 - s) * (1 - probs), 1e-8)).sum(1)
                adv = jax.lax.stop_gradient(reward - reward.mean())
                total = total - jnp.mean(logp * adv)
                xs_c = jax.lax.stop_gradient(xs_new)
                vs_c = jax.lax.stop_gradient(vs_new)
            return total / cfg.seq_len, (xs_c, vs_c)

        (loss, (xs2, vs2)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, xs2, vs2, loss

    def validate(params) -> float:
        """Mean best cut over the fixed seeded validation instances."""
        total = 0.0
        for v in range(cfg.num_validation):
            adj = _sample_adj(cfg, 77_000 + v)
            seq = embed(adj)
            k = jax.random.PRNGKey(1000 + v)
            xs = jax.random.bernoulli(k, 0.5, (cfg.num_sims, cfg.num_nodes))
            vs = _cut_value_adj(xs, adj)
            for t in range(4):
                xs, vs, _, _ = improve_round(
                    params, jax.random.fold_in(k, t), adj, seq, xs, vs
                )
            total += float(jnp.max(vs))
        return total / cfg.num_validation

    history = []
    for it in range(cfg.num_iters):
        adj = _sample_adj(cfg, 50_000 + it)  # FRESH graph every iteration
        seq = embed(adj)
        key, k_x, k_u = jax.random.split(key, 3)
        xs = jax.random.bernoulli(k_x, 0.5, (cfg.num_sims, cfg.num_nodes))
        vs = _cut_value_adj(xs, adj)
        params, opt_state, xs, vs, loss = update(
            params, opt_state, adj, seq, xs, vs, k_u
        )
        history.append({"loss": float(loss), "train_best": float(jnp.max(vs))})
    return {
        "net": net,
        "params": params,
        "encoder": enc,
        "encoder_params": enc_params,
        "validate": validate,
        "history": history,
        "config": cfg,
    }


def _guided_round(
    net,
    params,
    seq_graph,
    key,
    tables,
    adj,
    xs,
    vs,
    *,
    num_repeats: int,
    top_k: int,
    num_sweeps: int,
):
    """One policy-guided packed-search improvement round (the reference's
    rollout-step protocol, `demo_instance.py:141-168`, with the degree-
    ordered MCPG sweep kernel as the parallel local search).

    `tables`: None for the XLA 1-flip sweep (CPU-testable), or the
    `WeightedSweepTables` of the packed GPU sweep kernel, riding as a traced
    argument."""
    k_sample, k_seed, k_pos, k_draw = jax.random.split(key, 4)
    logits, _ = net.apply(params, solution_to_prob_channels(xs), seq_graph)
    probs = jax.nn.softmax(logits, axis=-1)[..., 0]
    cand = sub_set_sampling(k_sample, probs, xs, num_repeats, top_k)
    if num_repeats > 1:
        # epsilon-exploration group: resampling only the policy's top-k
        # UNCERTAIN bits stalls once the policy is confident-but-wrong
        # (round-4 plateau: extra attempts improved 0/10 instances at
        # BA_500). The last repeat group instead perturbs k RANDOM
        # positions of its incumbents at p=0.5 — the basin escape MCPG
        # gets from its temperature-driven MH sampler (`MCPG.py:88-118`).
        s, n = xs.shape
        k_explore = min(top_k, n)
        rand_ids = jax.random.randint(k_pos, (s, k_explore), 0, n)
        rows_e = jnp.arange(s)[:, None]
        explore = xs.at[rows_e, rand_ids].set(
            jax.random.bernoulli(k_draw, 0.5, (s, k_explore))
        )
        cand = jax.lax.dynamic_update_slice_in_dim(
            cand, explore, (num_repeats - 1) * s, axis=0
        )
    if tables is not None:
        bits = mcpg_sweep_fused(
            seed_from_key(k_seed), cand, tables, num_sweeps=num_sweeps
        )
    else:
        bits = sweep_1flip_adj(cand, adj, num_sweeps)
    cand_vs = _cut_value_adj(bits, adj)
    s = xs.shape[0]
    vs_r = cand_vs.reshape(num_repeats, s)
    rows = jnp.argmax(vs_r, axis=0) * s + jnp.arange(s)
    new_xs, new_vs = update_xs_by_vs(xs, vs, bits[rows], cand_vs[rows])
    # MCPG-style incumbent propagation (MCPG.py:376-394): worst <- best
    top = jnp.argmax(new_vs)
    worst = jnp.argmin(new_vs)
    new_xs = new_xs.at[worst].set(new_xs[top])
    new_vs = new_vs.at[worst].set(new_vs[top])
    return new_xs, new_vs


@functools.partial(
    jax.jit,
    static_argnames=("net", "num_repeats", "top_k", "num_sweeps", "block_len"),
)
def _guided_block(
    net,
    params,
    seq_graph,
    key,
    tables,
    adj,
    xs,
    vs,
    *,
    num_repeats: int,
    top_k: int,
    num_sweeps: int,
    block_len: int,
):
    """`block_len` guided rounds as one `lax.scan` program — one dispatch
    per block, not per round. All per-instance data (`tables`,
    `adj`, `seq_graph`) ride as jit ARGUMENTS, so one compiled program
    serves every same-shape instance of a campaign cell (and across
    distributions at the same N)."""

    def body(carry, k):
        xs, vs = carry
        xs, vs = _guided_round(
            net, params, seq_graph, k, tables, adj, xs, vs,
            num_repeats=num_repeats, top_k=top_k, num_sweeps=num_sweeps,
        )
        return (xs, vs), None

    (xs, vs), _ = jax.lax.scan(body, (xs, vs), jax.random.split(key, block_len))
    return xs, vs


def evaluate_l2a_packed(
    bundle: dict,
    graphs: List,
    num_rounds: int = 96,
    num_sims: int = 512,
    num_repeats: int = 16,
    num_sweeps: int = 8,
    seed: int = 0,
    use_packed: Optional[bool] = None,
) -> np.ndarray:
    """Policy-guided inference with the bit-packed Pallas sweep engine.

    The round-2 table showed L2A's eval-time search budget far below
    MCPG's (96 rounds x 2048 candidates x 2 XLA sweeps vs 384 rounds x
    8192 candidates x 8 packed sweeps) — the flagship lost to its own
    baseline on search power, not policy quality. This evaluator drives the
    same `mcpg_sweep_fused` kernel as MCPG's packed sweep under the trained
    distribution-wise policy: per round, the policy conditions on the
    incumbent population, `sub_set_sampling` resamples the top-k most
    uncertain bits into `num_repeats` candidates, the packed degree-ordered
    sweep refines all candidates, and best-of-repeats elitist-updates the
    population (reference protocol `demo_instance.py:141-168` at MCPG-class
    search budgets). The packed kernel runs on a GPU (`use_packed`
    defaults to whether one is the default backend); elsewhere the XLA
    1-flip sweep stands in. Returns the best cut per instance.
    """
    cfg: L2ADistConfig = bundle["config"]
    net, params = bundle["net"], bundle["params"]
    enc, enc_params = bundle["encoder"], bundle["encoder_params"]
    if use_packed is None:
        use_packed = jax.default_backend() == "gpu"

    embed = jax.jit(lambda adj: enc.embed(enc_params, adj[None])[0])
    block_len = 8
    key = jax.random.PRNGKey(seed)
    out = np.zeros(len(graphs))
    for gi, g in enumerate(graphs):
        adj = jnp.asarray(g.adjacency_dense(), jnp.float32)
        tables = WeightedSweepTables.build(g) if use_packed else None
        seq = embed(adj)
        key, k_init = jax.random.split(key)
        xs = jax.random.bernoulli(k_init, 0.5, (num_sims, g.num_nodes))
        vs = _cut_value_adj(xs, adj)
        for _ in range(max(1, num_rounds // block_len)):
            key, k = jax.random.split(key)
            xs, vs = _guided_block(
                net, params, seq, k, tables, adj, xs, vs,
                num_repeats=num_repeats, top_k=cfg.top_k,
                num_sweeps=num_sweeps, block_len=block_len,
            )
        out[gi] = float(jnp.max(vs))
    return out


def evaluate_l2a_distribution(
    bundle: dict,
    adjs: List[np.ndarray],
    num_rounds: int = 48,
    num_sims: Optional[int] = None,
    seed: int = 0,
) -> np.ndarray:
    """Policy-guided inference on specific instances (dense adjacencies).

    The distribution-trained policy is applied to each instance for
    `num_rounds` improvement rounds (probs -> top-k resample -> 1-flip sweep
    -> elitist accept) — the reference's table protocol of evaluating the
    distribution-wise net on the 10 seeded benchmark instances
    (`demo_distribution.py:110-125`). The instances are stacked
    on a leading axis and the whole rollout (vmap over instances, `lax.scan`
    over rounds, a final sweep-to-convergence polish) is ONE jitted call.
    Returns the best cut per instance.
    """
    cfg: L2ADistConfig = bundle["config"]
    net, params = bundle["net"], bundle["params"]
    enc, enc_params = bundle["encoder"], bundle["encoder_params"]
    sims = num_sims or cfg.num_sims
    adj_stack = jnp.asarray(np.stack(adjs))  # [G, N, N]
    num_graphs, n = adj_stack.shape[0], adj_stack.shape[1]

    def improve(key, adj, seq_graph, xs, vs):
        k_sample, k_noise = jax.random.split(key)
        logits, _ = net.apply(params, solution_to_prob_channels(xs), seq_graph)
        probs = jax.nn.softmax(logits, axis=-1)[..., 0]
        cand = sub_set_sampling(k_sample, probs, xs, cfg.num_repeats, cfg.top_k)
        cand = sweep_1flip_adj(cand, adj, cfg.ls_sweeps)
        cand_vs = _cut_value_adj(cand, adj)
        s = xs.shape[0]  # chunked eval may run fewer sims than cfg.num_sims
        vs_r = cand_vs.reshape(cfg.num_repeats, s)
        rows = jnp.argmax(vs_r, axis=0) * s + jnp.arange(s)
        xs, vs = update_xs_by_vs(xs, vs, cand[rows], cand_vs[rows])
        # perturb-and-sweep move (`env_L2A.py:92-107` local-search phase 1):
        # flip the num_spin highest noisy-gain bits, re-sweep, accept if better
        gains = flip_gains_adj(xs, adj)
        noisy = gains + jax.random.normal(k_noise, gains.shape) * (
            0.25 * jnp.std(gains, axis=1, keepdims=True) + 1e-3
        )
        k_spin = max(2, cfg.top_k // 2)
        thresh = jnp.sort(noisy, axis=1)[:, -k_spin][:, None]
        pert = jnp.logical_xor(xs, noisy >= thresh)
        pert = sweep_1flip_adj(pert, adj, cfg.ls_sweeps)
        return update_xs_by_vs(xs, vs, pert, _cut_value_adj(pert, adj))

    block_len = 8  # rounds per jit call (giant single scans compile slowly)

    def block_one(adj, seq, xs, vs, key):
        def body(carry, k):
            xs, vs = carry
            return improve(k, adj, seq, xs, vs), None

        (xs, vs), _ = jax.lax.scan(
            body, (xs, vs), jax.random.split(key, block_len)
        )
        return xs, vs

    block_v = jax.jit(jax.vmap(block_one))

    def polish_one(adj, xs, vs):
        xs = sweep_1flip_adj(xs, adj, 4)
        return jnp.max(jnp.maximum(vs, _cut_value_adj(xs, adj)))

    polish_v = jax.jit(jax.vmap(polish_one))
    embed_v = jax.jit(jax.vmap(lambda adj: enc.embed(enc_params, adj[None])[0]))

    key = jax.random.PRNGKey(seed)
    seqs = embed_v(adj_stack)

    # Memory budget: the policy's cross-attention materializes
    # f32[g, s, heads, N, N] score tensors — 12 GB for 10 graphs x 512 sims
    # at N = 400.
    # Evaluate graph-by-graph and chunk the sim axis so one call's scores
    # stay under ~3 GB; chunks are independent restarts of the same
    # policy-guided search, so the max over chunks is the same protocol.
    heads = getattr(cfg, "num_heads", 4)
    bytes_per_sim = 4 * heads * n * n
    sims_chunk = int(max(8, min(sims, 3e9 // max(1, bytes_per_sim))))
    num_chunks = -(-sims // sims_chunk)
    sims_chunk = -(-sims // num_chunks)  # equalize so every chunk compiles once

    out = np.zeros(num_graphs)
    rounds = max(1, num_rounds // block_len)
    for gi in range(num_graphs):
        adj1, seq1 = adj_stack[gi : gi + 1], seqs[gi : gi + 1]
        best = -np.inf
        for c in range(num_chunks):
            key, k_init = jax.random.split(key)
            xs = jax.random.bernoulli(k_init, 0.5, (1, sims_chunk, n))
            vs = jax.jit(jax.vmap(_cut_value_adj))(xs, adj1)
            for b in range(rounds):
                key, k = jax.random.split(key)
                xs, vs = block_v(adj1, seq1, xs, vs, k[None])
            best = max(best, float(polish_v(adj1, xs, vs)[0]))
        out[gi] = best
    return out
