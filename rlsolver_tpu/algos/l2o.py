"""Learning-to-optimize solvers: seq2seq REINFORCE and k_spin L2O-LSTM.

Reference counterparts:
  * `rlsolver/methods/seq2seq/main.py:34-90` — an LSTM re-reads its own
    sampled solution each step, emits per-node Bernoulli probs, trained by
    REINFORCE with centered advantage on the dense-matmul maxcut energy
    (`cal_obj` `main.py:27-31`);
  * `rlsolver/methods/k_spin/k_spin_Ising.py:37-90` + `net.py:21-32`
    (`OptNet`) — an LSTM optimizer iterates a RELAXED solution vector,
    trained by direct backprop through the differentiable objective summed
    along the trajectory, plus a coupling term between consecutive
    solutions (`calc_obj_for_two_graphs_vmap`).

Both are batched over envs and run their full inner loops inside jit.
The relaxed maxcut objective is the expected cut
E[cut] = sum_ij w_ij (p_i + p_j - 2 p_i p_j), one dense matmul.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax

from rlsolver_tpu.core.graph import Graph
from rlsolver_tpu.ops import cut as cut_ops


def expected_cut(probs: jax.Array, adj: jax.Array) -> jax.Array:
    """E[cut] for independent Bernoulli(p) nodes, f32 [B].

    = 1/2 sum_ij A_ij (p_i + p_j - 2 p_i p_j) over the symmetric dense A
    (each edge counted once)."""
    deg = adj.sum(axis=1)  # weighted degree
    lin = probs @ deg  # sum_i p_i * wdeg_i = sum_ij A_ij p_i (per edge twice)
    quad = jnp.einsum("bi,ij,bj->b", probs, adj, probs)
    return lin - quad


class SolverLSTM(nn.Module):
    """LSTM over the whole solution vector -> per-node probs
    (`seq2seq/main.py:34-52` Solver and `k_spin/net.py:21-32` OptNet)."""

    num_nodes: int
    hidden: int = 256

    @nn.compact
    def __call__(self, carry, x):
        carry, h = nn.OptimizedLSTMCell(self.hidden, name="lstm")(carry, x)
        logits = nn.Dense(self.num_nodes, name="out")(h)
        probs = nn.sigmoid(logits)
        # squash away from {0, 1} (`main.py:50`)
        return carry, (probs - 0.5) * 0.999999 + 0.5

    def init_carry(self, key, batch):
        return nn.OptimizedLSTMCell(self.hidden, parent=None).initialize_carry(
            key, (batch, self.num_nodes)
        )


# ----------------------------------------------------------------- seq2seq
@dataclasses.dataclass
class Seq2SeqConfig:
    num_envs: int = 64
    num_steps: int = 200
    hidden: int = 256
    lr: float = 1e-4
    grad_clip: float = 1.0
    seed: int = 0


def solve_maxcut_seq2seq(graph: Graph, cfg: Seq2SeqConfig = Seq2SeqConfig()):
    """REINFORCE training loop; returns (best bits, best cut, history)."""
    adj = jnp.asarray(graph.adjacency_dense())
    model = SolverLSTM(graph.num_nodes, cfg.hidden)
    opt = optax.chain(optax.clip_by_global_norm(cfg.grad_clip), optax.adam(cfg.lr))
    cg = cut_ops.CutGraph.build(graph, dtype=jnp.float32)

    key = jax.random.PRNGKey(cfg.seed)
    k_init, k_sample, key = jax.random.split(key, 3)
    sample = jax.random.bernoulli(k_sample, 0.5, (cfg.num_envs, graph.num_nodes))
    carry = model.init_carry(k_init, cfg.num_envs)
    params = model.init(k_init, carry, sample.astype(jnp.float32))
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, carry, sample, key):
        key, k = jax.random.split(key)

        def loss_fn(p):
            new_carry, probs = model.apply(p, carry, sample.astype(jnp.float32))
            new_sample = jax.random.bernoulli(k, probs)
            cuts = cut_ops.cut_value(new_sample, cg)
            adv = cuts - cuts.mean()
            s = new_sample.astype(jnp.float32)
            logp = jnp.log(s * probs + (1.0 - s) * (1.0 - probs)).sum(axis=1)
            # maximize E[adv * logp]  (`get_return` `main.py:65-69`)
            return -jnp.mean(jax.lax.stop_gradient(adv) * logp), (
                new_carry,
                new_sample,
                cuts,
            )

        (loss, (carry2, sample2, cuts)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        carry2 = jax.tree.map(jax.lax.stop_gradient, carry2)
        return params, opt_state, carry2, sample2, key, loss, cuts

    best_cut, best_bits, history = -np.inf, None, []
    for _ in range(cfg.num_steps):
        params, opt_state, carry, sample, key, loss, cuts = step(
            params, opt_state, carry, sample, key
        )
        c = float(jnp.max(cuts))
        if c > best_cut:
            best_cut = c
            best_bits = np.asarray(sample[int(jnp.argmax(cuts))])
        history.append({"loss": float(loss), "max_cut": c})
    return best_bits, best_cut, history


# --------------------------------------------------------------------- L2O
@dataclasses.dataclass
class L2OConfig:
    num_envs: int = 64
    episode_length: int = 16
    num_epochs: int = 100
    hidden: int = 256
    lr: float = 1e-4
    coupling: float = 0.2  # consecutive-solution coupling weight
    gamma: float = 0.98
    seed: int = 0


def solve_maxcut_l2o(graph: Graph, cfg: L2OConfig = L2OConfig()):
    """Train an LSTM optimizer by direct backprop through the relaxed
    objective along the trajectory (`k_spin_Ising.py:51-80` semantics).
    Returns (best bits, best cut, history)."""
    adj = jnp.asarray(graph.adjacency_dense())
    model = SolverLSTM(graph.num_nodes, cfg.hidden)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(cfg.lr))
    cg = cut_ops.CutGraph.build(graph, dtype=jnp.float32)

    key = jax.random.PRNGKey(cfg.seed)
    k_init, key = jax.random.split(key)
    carry0 = model.init_carry(k_init, cfg.num_envs)
    x0 = jnp.full((cfg.num_envs, graph.num_nodes), 0.5)
    params = model.init(k_init, carry0, x0)
    opt_state = opt.init(params)

    def cross_cut(p_prev, p_cur):
        """Expected cut between two relaxed solutions
        (`calc_obj_for_two_graphs_vmap` capability): rewards the optimizer
        for moving to complementary configurations."""
        lin = (p_prev + p_cur) @ adj.sum(axis=1) / 2.0
        quad = jnp.einsum("bi,ij,bj->b", p_prev, adj, p_cur)
        return lin - quad

    @jax.jit
    def epoch(params, opt_state, key):
        key, k_start = jax.random.split(key)
        start = jax.random.uniform(k_start, (cfg.num_envs, graph.num_nodes))

        def loss_fn(p):
            def body(carry, _):
                (lstm_carry, x_prev) = carry
                lstm_carry, x = model.apply(p, lstm_carry, x_prev)
                obj = expected_cut(x, adj)
                obj = obj + cfg.coupling * cross_cut(
                    jax.lax.stop_gradient(x_prev), x
                )
                return (lstm_carry, x), (obj, x)

            (_, x_last), (objs, xs) = jax.lax.scan(
                body, (carry0, start), None, length=cfg.episode_length
            )
            discounts = cfg.gamma ** jnp.arange(cfg.episode_length - 1, -1, -1)
            loss = -jnp.mean(objs * discounts[:, None])
            return loss, xs

        (loss, xs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        bits = xs[-1] > 0.5
        cuts = cut_ops.cut_value(bits, cg)
        return params, opt_state, key, loss, bits, cuts

    best_cut, best_bits, history = -np.inf, None, []
    for _ in range(cfg.num_epochs):
        params, opt_state, key, loss, bits, cuts = epoch(params, opt_state, key)
        c = float(jnp.max(cuts))
        if c > best_cut:
            best_cut = c
            best_bits = np.asarray(bits[int(jnp.argmax(cuts))])
        history.append({"loss": float(loss), "max_cut": c})
    return best_bits, best_cut, history
