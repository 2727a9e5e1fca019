"""Prioritized experience replay as a pure pytree.

Reference counterpart: `rlsolver/elegantrl/train/replay_buffer.py:11-307` —
the multi-env `ReplayBuffer` with the `SumTree` proportional-PER variant
(`:226-307`) and buffer save/load (`:181-212`).

Accelerator-first: instead of a pointer-chasing sum tree, priorities live in a flat
[capacity] vector and sampling is `jax.random.categorical` over
log-priorities — O(capacity) streaming elementwise work, branch-free, and
trivially correct; importance weights follow the standard (N * P(i))^-beta
formula. Buffer persistence goes through the orbax checkpoint helpers
(`rlsolver_tpu.train.checkpoint`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class PrioritizedReplay(NamedTuple):
    data: tuple  # pytree of [capacity, ...] arrays
    priorities: jax.Array  # f32 [capacity], 0 = empty slot
    ptr: jax.Array
    size: jax.Array
    alpha: jax.Array  # priority exponent
    max_priority: jax.Array

    @staticmethod
    def create(example: tuple, capacity: int, alpha: float = 0.6) -> "PrioritizedReplay":
        data = jax.tree.map(
            lambda x: jnp.zeros((capacity,) + jnp.asarray(x).shape, jnp.asarray(x).dtype),
            example,
        )
        return PrioritizedReplay(
            data,
            jnp.zeros(capacity),
            jnp.int32(0),
            jnp.int32(0),
            jnp.float32(alpha),
            jnp.float32(1.0),
        )


def per_add(buf: PrioritizedReplay, item: tuple) -> PrioritizedReplay:
    """Insert with max priority (new samples always seen at least once)."""
    cap = buf.priorities.shape[0]
    i = buf.ptr
    data = jax.tree.map(lambda d, x: d.at[i].set(x), buf.data, item)
    priorities = buf.priorities.at[i].set(buf.max_priority**buf.alpha)
    return buf._replace(
        data=data,
        priorities=priorities,
        ptr=(i + 1) % cap,
        size=jnp.minimum(buf.size + 1, cap),
    )


def per_sample(
    buf: PrioritizedReplay, key: jax.Array, batch: int, beta: float = 0.4
) -> Tuple[tuple, jax.Array, jax.Array]:
    """Returns (batch pytree, indices, importance weights normalized to
    max 1). Sampling is proportional to stored priorities."""
    logits = jnp.where(buf.priorities > 0, jnp.log(buf.priorities + 1e-12), -jnp.inf)
    idx = jax.random.categorical(key, logits, shape=(batch,))
    batch_data = jax.tree.map(lambda d: d[idx], buf.data)
    probs = buf.priorities / jnp.maximum(buf.priorities.sum(), 1e-12)
    w = (jnp.maximum(buf.size, 1) * probs[idx]) ** (-beta)
    w = w / jnp.max(w)
    return batch_data, idx, w


def per_update(
    buf: PrioritizedReplay, idx: jax.Array, td_errors: jax.Array
) -> PrioritizedReplay:
    """Write back |TD error|-based priorities for the sampled indices."""
    pr = (jnp.abs(td_errors) + 1e-6) ** buf.alpha
    priorities = buf.priorities.at[idx].set(pr)
    max_priority = jnp.maximum(buf.max_priority, jnp.max(jnp.abs(td_errors) + 1e-6))
    return buf._replace(priorities=priorities, max_priority=max_priority)
