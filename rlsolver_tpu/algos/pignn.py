"""PI-GNN: physics-inspired GNN trained on a relaxed QUBO Hamiltonian.

Reference counterpart (`rlsolver/methods/PIGNN/main.py:17-101`, model
`PIGNN/model.py:9-61`): a GCN outputs per-node probabilities p in (0, 1);
the loss is the continuous relaxation of the problem Hamiltonian; training
uses early stopping on the loss; the solution is the rounded p > 0.5.

Hamiltonians (standard PI-GNN formulations, matching the reference's eval
targets `eval_maxcut` / `eval_MIS` in `PIGNN/util.py`):
  maxcut: L = -sum_ij w_ij (p_i + p_j - 2 p_i p_j)   (negated expected cut)
  MIS:    L = -sum_i p_i + penalty * sum_ij A_ij p_i p_j
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from rlsolver_tpu.core.graph import Graph
from rlsolver_tpu.models.gcn import GCN, normalized_adjacency
from rlsolver_tpu.ops import cut as cut_ops


@dataclasses.dataclass
class PIGNNConfig:
    hidden: tuple = (64, 64)
    embed_dim: int = 16  # learnable node-id embedding input
    lr: float = 1e-3
    max_steps: int = 2000
    patience: int = 200  # early stopping (reference uses Lightning EarlyStopping)
    tol: float = 1e-5
    penalty: float = 2.0  # MIS constraint weight
    seed: int = 0


def _train(graph: Graph, loss_of_probs, cfg: PIGNNConfig):
    n = graph.num_nodes
    a_norm = jnp.asarray(normalized_adjacency(graph))
    model = GCN(hidden=cfg.hidden, out_dim=1)
    key = jax.random.PRNGKey(cfg.seed)
    k_emb, k_init = jax.random.split(key)
    node_embed = jax.random.normal(k_emb, (n, cfg.embed_dim)) * 0.1
    k_init, k_skip = jax.random.split(k_init)
    params = {
        "gcn": model.init(k_init, node_embed, a_norm),
        "embed": node_embed,
        # see solve_maxcut_pignn_cell: anti-over-smoothing skip readout
        "skip": jax.random.normal(k_skip, (cfg.embed_dim,)) * 0.1,
    }
    opt = optax.adam(cfg.lr)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            logits = model.apply(p["gcn"], p["embed"], a_norm)[..., 0]
            logits = logits + p["embed"] @ p["skip"]
            probs = jax.nn.sigmoid(logits)
            return loss_of_probs(probs), probs

        (loss, probs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, probs

    best_loss, best_probs, since_best = np.inf, None, 0
    for i in range(cfg.max_steps):
        params, opt_state, loss, probs = step(params, opt_state)
        loss = float(loss)
        if loss < best_loss - cfg.tol:
            best_loss, best_probs, since_best = loss, probs, 0
        else:
            since_best += 1
            if since_best >= cfg.patience:
                break
    return np.asarray(best_probs)


def solve_maxcut_pignn(
    graph: Graph, cfg: PIGNNConfig = PIGNNConfig()
) -> Tuple[np.ndarray, float]:
    e_n0, e_n1, e_w = graph.edge_arrays()
    n0, n1, w = jnp.asarray(e_n0), jnp.asarray(e_n1), jnp.asarray(e_w)
    # total-weight normalization: see solve_maxcut_pignn_cell (unnormalized
    # gradients saturate the sigmoid on dense cells at N >= 200)
    tw = max(float(e_w.sum()), 1e-9)

    def loss_of_probs(p):
        return -jnp.sum(w * (p[n0] + p[n1] - 2.0 * p[n0] * p[n1])) / tw

    probs = _train(graph, loss_of_probs, cfg)
    bits = probs > 0.5
    cg = cut_ops.CutGraph.build(graph, dtype=jnp.float32)
    val = float(cut_ops.cut_dense(jnp.asarray(bits[None]), cg)[0])
    return bits, val


def solve_maxcut_pignn_cell(
    graphs, cfg: PIGNNConfig = PIGNNConfig(), chunk: int = 500
):
    """PI-GNN over a whole campaign cell as ONE vmapped jitted program.

    The per-instance variant `solve_maxcut_pignn` bakes `a_norm` and the
    edge arrays into the jaxpr as closure constants and syncs the host
    every optimizer step — per-instance recompiles plus thousands of
    host round-trips. Here all G instances train simultaneously: params
    / optimizer state / normalized adjacency carry a leading instance
    axis, edge arrays are zero-weight-padded to the cell max, training
    runs in `chunk`-step `lax.scan` dispatches with device-side
    best-probs tracking, and early stopping happens at chunk granularity
    (one host sync per chunk). Returns (bits [G, N] bool, cut [G] f32).

    Reference counterpart: per-instance Lightning loop with EarlyStopping
    (`PIGNN/main.py:48-55`).
    """
    n = graphs[0].num_nodes
    g_cnt = len(graphs)
    m_max = max(g.edge_arrays()[0].shape[0] for g in graphs)
    n0s, n1s, ws = [], [], []
    for g in graphs:
        a, b, w = g.edge_arrays()
        pad = m_max - len(a)
        n0s.append(np.pad(a, (0, pad)))
        n1s.append(np.pad(b, (0, pad)))
        ws.append(np.pad(w, (0, pad)))  # w = 0: padded edges are no-ops
    n0 = jnp.asarray(np.stack(n0s))
    n1 = jnp.asarray(np.stack(n1s))
    w = jnp.asarray(np.stack(ws).astype(np.float32))
    a_norm = jnp.asarray(
        np.stack([normalized_adjacency(g) for g in graphs]).astype(np.float32)
    )

    model = GCN(hidden=cfg.hidden, out_dim=1)
    opt = optax.adam(cfg.lr)

    def init_one(key):
        k_emb, k_init, k_skip = jax.random.split(key, 3)
        node_embed = jax.random.normal(k_emb, (n, cfg.embed_dim)) * 0.1
        return {
            "gcn": model.init(k_init, node_embed, a_norm[0]),
            "embed": node_embed,
            # direct embed->logit readout: on dense cells the GCN stack
            # over-smooths (every node converges to the same logit, the
            # rounded solution puts all nodes on one side, cut 0 — observed
            # on ER at N >= 200); the skip path keeps per-node identity
            # trainable regardless of propagation depth
            "skip": jax.random.normal(k_skip, (cfg.embed_dim,)) * 0.1,
        }

    keys = jax.random.split(jax.random.PRNGKey(cfg.seed), g_cnt)
    params = jax.vmap(init_one)(keys)
    opt_state = opt.init(params)

    # normalize by total weight: the raw Hamiltonian's gradient scale grows
    # with edge count, and on dense ER cells at N >= 200 Adam at lr 1e-3
    # drives the logits into sigmoid saturation (observed: whole cells
    # collapsing to near-zero cut, one instance exactly 0.0). The argmin
    # is unchanged; the loss is now O(1) at every size.
    tw = jnp.maximum(jnp.sum(w, axis=1), 1e-9)  # [G]

    def loss_one(p, an, e0, e1, ew, wsum):
        logits = model.apply(p["gcn"], p["embed"], an)[..., 0]
        logits = logits + p["embed"] @ p["skip"]
        probs = jax.nn.sigmoid(logits)
        cut = jnp.sum(ew * (probs[e0] + probs[e1] - 2.0 * probs[e0] * probs[e1]))
        return -cut / wsum, probs

    grad_v = jax.vmap(jax.value_and_grad(loss_one, has_aux=True))

    @jax.jit
    def run_chunk(params, opt_state, best_loss, best_probs):
        def body(carry, _):
            params, opt_state, best_loss, best_probs = carry
            (loss, probs), grads = grad_v(params, a_norm, n0, n1, w, tw)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            better = loss < best_loss - cfg.tol
            best_loss = jnp.where(better, loss, best_loss)
            best_probs = jnp.where(better[:, None], probs, best_probs)
            return (params, opt_state, best_loss, best_probs), None

        return jax.lax.scan(
            body, (params, opt_state, best_loss, best_probs), None, length=chunk
        )[0]

    best_loss = jnp.full((g_cnt,), jnp.inf)
    best_probs = jnp.zeros((g_cnt, n))
    prev = np.full((g_cnt,), np.inf)
    for _ in range(max(1, cfg.max_steps // chunk)):
        params, opt_state, best_loss, best_probs = run_chunk(
            params, opt_state, best_loss, best_probs
        )
        cur = np.asarray(best_loss)
        if np.all(cur > prev - cfg.tol):  # no instance improved this chunk
            break
        prev = cur
    bits = np.asarray(best_probs) > 0.5
    xb = bits.astype(np.int8)
    n0_h, n1_h, w_h = np.stack(n0s), np.stack(n1s), np.stack(ws)
    cut_e = (np.take_along_axis(xb, n0_h, 1) ^ np.take_along_axis(xb, n1_h, 1))
    vals = (cut_e * w_h).sum(axis=1).astype(np.float32)
    return bits, vals


def solve_mis_pignn(
    graph: Graph, cfg: PIGNNConfig = PIGNNConfig()
) -> Tuple[np.ndarray, float]:
    e_n0, e_n1, _ = graph.edge_arrays()
    n0, n1 = jnp.asarray(e_n0), jnp.asarray(e_n1)

    def loss_of_probs(p):
        return -jnp.sum(p) + cfg.penalty * jnp.sum(p[n0] * p[n1])

    probs = _train(graph, loss_of_probs, cfg)
    bits = (probs > 0.5).copy()
    # repair any residual violations (drop the later endpoint), then make the
    # set maximal by greedily adding non-conflicting nodes in prob order
    for a, b in zip(e_n0, e_n1):
        if bits[a] and bits[b]:
            bits[b] = False
    nbrs, _, deg = graph.padded_neighbors()
    for v in np.argsort(-probs):
        if not bits[v] and not bits[nbrs[v, : deg[v]]].any():
            bits[v] = True
    return bits, float(bits.sum())
