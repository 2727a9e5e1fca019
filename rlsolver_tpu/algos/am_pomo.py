"""POMO training/inference for the TSP attention model.

Reference counterpart: `rlsolver/methods/attention_model/AM_TSP/trainer.py`
(`DistributedPOMOTrainer` — POMO multi-start rollouts with the shared-
baseline REINFORCE loss `_compute_loss_core:180-198`, NCCL DDP over
instance batches, grad clip + lr schedule) and `train.py:29`.

Accelerator-first: the whole rollout is a `lax.scan` over tour steps with the
encoder output computed once and closed over (the reference re-checkpoints
the decoder per step); POMO starts are an extra batch axis of size P = N
(rollout p starts at city p). Data-parallel training shards the instance
axis over the mesh with `psum` gradients (DDP equivalent). Inference adds
the standard x8 coordinate-symmetry augmentation.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from rlsolver_tpu.models.attention_tsp import AttentionTSP


def tour_lengths(nodes: jax.Array, actions: jax.Array) -> jax.Array:
    """nodes [B, N, 2], actions [B, P, N] permutations -> lengths [B, P]."""
    b, p, n = actions.shape
    coords = jnp.take_along_axis(
        nodes[:, None, :, :], actions[..., None], axis=2
    )  # [B, P, N, 2]
    diffs = coords - jnp.roll(coords, -1, axis=2)
    return jnp.sqrt((diffs**2).sum(-1) + 1e-10).sum(-1)


def rollout_pomo(
    model: AttentionTSP,
    params,
    key: jax.Array,
    nodes: jax.Array,
    pomo_size: Optional[int] = None,
    greedy: bool = False,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """POMO rollout: P rollouts per instance, rollout p starts at city p.

    Returns (actions [B, P, N], log_probs [B, P] summed over steps,
    lengths [B, P]).
    """
    b, n, _ = nodes.shape
    p = pomo_size or n
    encoded = model.apply(params, nodes, method=AttentionTSP.encode)

    first = jnp.broadcast_to(jnp.arange(p)[None, :] % n, (b, p)).astype(jnp.int32)
    visited = jnp.zeros((b, p, n), bool).at[
        jnp.arange(b)[:, None], jnp.arange(p)[None, :], first
    ].set(True)

    def step(carry, k):
        visited, current, logp_sum = carry
        logits, _ = model.apply(
            params, nodes, current, first, ~visited, encoded
        )
        if greedy:
            action = jnp.argmax(logits, axis=-1)
        else:
            action = jax.random.categorical(k, logits)
        action = action.astype(jnp.int32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        step_lp = jnp.take_along_axis(logp, action[..., None], axis=-1)[..., 0]
        visited = visited.at[
            jnp.arange(b)[:, None], jnp.arange(p)[None, :], action
        ].set(True)
        return (visited, action, logp_sum + step_lp), action

    keys = jax.random.split(key, n - 1)
    (visited, _, logp_sum), actions_rest = jax.lax.scan(
        step, (visited, first, jnp.zeros((b, p))), keys
    )
    actions = jnp.concatenate(
        [first[None], actions_rest], axis=0
    )  # [N, B, P]
    actions = jnp.moveaxis(actions, 0, 2)  # [B, P, N]
    lengths = tour_lengths(nodes, actions)
    return actions, logp_sum, lengths


@dataclasses.dataclass
class POMOConfig:
    num_cities: int = 20
    embed_dim: int = 128
    num_heads: int = 4
    num_layers: int = 3
    batch_size: int = 64
    pomo_size: Optional[int] = None  # default = num_cities
    num_steps: int = 200
    lr: float = 1e-4
    grad_clip: float = 1.0
    seed: int = 0


class POMOTrainState(NamedTuple):
    params: dict
    opt_state: tuple
    key: jax.Array


def make_pomo_step(model: AttentionTSP, cfg: POMOConfig, axis_name: Optional[str] = None):
    """One training step: sample a fresh uniform instance batch, POMO
    rollout, shared-baseline REINFORCE (`trainer.py:192-196`)."""
    optimizer = optax.chain(
        optax.clip_by_global_norm(cfg.grad_clip), optax.adam(cfg.lr)
    )

    def pmean(x):
        return jax.lax.pmean(x, axis_name) if axis_name else x

    def step(state: POMOTrainState):
        key, k_data, k_roll = jax.random.split(state.key, 3)
        if axis_name:
            shard = jax.lax.axis_index(axis_name)
            k_data = jax.random.fold_in(k_data, shard)
            k_roll = jax.random.fold_in(k_roll, shard)
        nodes = jax.random.uniform(k_data, (cfg.batch_size, cfg.num_cities, 2))

        def loss_fn(params):
            actions, logp, lengths = rollout_pomo(
                model, params, k_roll, nodes, cfg.pomo_size
            )
            baseline = lengths.mean(axis=1, keepdims=True)  # POMO shared baseline
            advantage = lengths - baseline
            logp = jnp.clip(logp, -5.0 * cfg.num_cities)  # `trainer.py:194`
            loss = jnp.mean(advantage * logp)
            return loss, lengths

        (loss, lengths), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params
        )
        grads = pmean(grads)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        metrics = {
            "loss": pmean(loss),
            "mean_length": pmean(lengths.mean()),
            "best_length": pmean(lengths.min(axis=1).mean()),
        }
        return POMOTrainState(params, opt_state, key), metrics

    return optimizer, step


def init_pomo_state(model: AttentionTSP, cfg: POMOConfig, optimizer) -> POMOTrainState:
    key = jax.random.PRNGKey(cfg.seed)
    k_init, key = jax.random.split(key)
    nodes = jnp.zeros((1, cfg.num_cities, 2))
    mask = jnp.ones((1, 1, cfg.num_cities), bool)
    dummy = jnp.zeros((1, 1), jnp.int32)  # materialize the cur/fst branches
    params = model.init(k_init, nodes, dummy, dummy, mask, None)
    return POMOTrainState(params, optimizer.init(params), key)


def train_pomo(cfg: POMOConfig = POMOConfig()):
    """Single-chip POMO training; returns (model, state, history)."""
    model = AttentionTSP(cfg.embed_dim, cfg.num_heads, cfg.num_layers)
    optimizer, step = make_pomo_step(model, cfg)
    state = init_pomo_state(model, cfg, optimizer)
    jit_step = jax.jit(step)
    history = []
    for _ in range(cfg.num_steps):
        state, metrics = jit_step(state)
        history.append({k: float(v) for k, v in metrics.items()})
    return model, state, history


def beam_search(
    model: AttentionTSP,
    params,
    nodes: jax.Array,
    beam_width: int = 4,
) -> Tuple[jax.Array, jax.Array]:
    """Batched beam-search decoding (the rl4co `utils/decoding.py` beam
    strategy). Expands the `beam_width` best partial tours per instance by
    total log-probability; all beams start at city 0.

    Returns (tours [B, N], lengths [B]) — the best COMPLETED tour per
    instance by length among the final beams.
    """
    b, n, _ = nodes.shape
    k = beam_width
    encoded = model.apply(params, nodes, method=AttentionTSP.encode)

    first = jnp.zeros((b, k), jnp.int32)
    visited = jnp.zeros((b, k, n), bool).at[:, :, 0].set(True)
    # beam 0 is the only live beam initially (all start identically);
    # dead beams use a large FINITE sentinel: -inf would turn into NaN in
    # the score-carry arithmetic and top_k over NaN is backend-defined
    dead = -1e9
    scores = jnp.where(jnp.arange(k)[None, :] == 0, 0.0, dead)
    scores = jnp.broadcast_to(scores, (b, k))
    tours = jnp.zeros((b, k, n), jnp.int32)

    def step(carry, t):
        visited, current, scores, tours = carry
        logits, _ = model.apply(params, nodes, current, first, ~visited, encoded)
        logp = jax.nn.log_softmax(logits, axis=-1)  # [B, K, N]
        cand = scores[:, :, None] + logp  # total score per (beam, city)
        flat = cand.reshape(b, k * n)
        top_scores, top_idx = jax.lax.top_k(flat, k)  # [B, K]
        beam_idx = top_idx // n
        city = (top_idx % n).astype(jnp.int32)
        bidx = jnp.arange(b)[:, None]
        visited = visited[bidx, beam_idx]
        tours = tours[bidx, beam_idx]
        current = city
        visited = visited.at[bidx, jnp.arange(k)[None, :], city].set(True)
        tours = tours.at[:, :, t].set(city)
        return (visited, current, top_scores, tours), None

    current = jnp.zeros((b, k), jnp.int32)
    (visited, current, scores, tours), _ = jax.lax.scan(
        step, (visited, current, scores, tours), jnp.arange(1, n)
    )
    # tours[:, :, 0] stays city 0
    lengths = tour_lengths(nodes, tours)  # [B, K]
    lengths = jnp.where(scores > dead / 2, lengths, jnp.inf)
    best = jnp.argmin(lengths, axis=1)
    bidx = jnp.arange(b)
    return tours[bidx, best], lengths[bidx, best]


def augment_coords_x8(nodes: jax.Array) -> jax.Array:
    """The POMO x8 symmetry augmentation: (x,y) reflections/swaps.
    nodes [B, N, 2] -> [8B, N, 2]."""
    x, y = nodes[..., 0], nodes[..., 1]
    variants = [
        (x, y), (1 - x, y), (x, 1 - y), (1 - x, 1 - y),
        (y, x), (1 - y, x), (y, 1 - x), (1 - y, 1 - x),
    ]
    return jnp.concatenate(
        [jnp.stack(v, axis=-1) for v in variants], axis=0
    )


def infer_pomo(
    model: AttentionTSP,
    params,
    nodes: jax.Array,
    augment: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy POMO inference with optional x8 augmentation; returns
    (best tours [B, N], best lengths [B])."""
    b, n, _ = nodes.shape
    inp = augment_coords_x8(nodes) if augment else nodes
    actions, _, lengths = rollout_pomo(
        model, params, jax.random.PRNGKey(0), inp, greedy=True
    )
    reps = 8 if augment else 1
    lengths = lengths.reshape(reps, b, n)
    actions = actions.reshape(reps, b, n, n)
    flat = lengths.reshape(reps, b, n)
    # best over (augmentation, pomo) axes
    best_rep_pomo = jnp.argmin(flat.transpose(1, 0, 2).reshape(b, -1), axis=1)
    rep_idx, pomo_idx = best_rep_pomo // n, best_rep_pomo % n
    best_actions = actions[rep_idx, jnp.arange(b), pomo_idx]
    best_lengths = lengths[rep_idx, jnp.arange(b), pomo_idx]
    return np.asarray(best_actions), np.asarray(best_lengths)
