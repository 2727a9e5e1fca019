"""Counter-based uint32 hash: the randomness of the fused kernels.

A GPU kernel has no hardware random-number generator, and the fused MCPG
kernels (`ops/pallas/mh_sampler.py`, `ops/pallas/mcpg_sweep.py`) need one
draw per (chain, step). `hash_u32(seed, chain, step)` gives it as a pure
function of its three counters, written once in `jax.numpy` and called both
inside the Pallas kernels and by their XLA twins, so kernel and twin consume
the identical stream and agree bit for bit (interpret mode here, compiled
on the card).

The mixer is the "lowbias32" integer finalizer (xor-shift-multiply, good
avalanche on all 32 output bits), applied once after folding in the seed
and chain and again after folding in the step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_GOLDEN = 0x9E3779B9
_STEP_MUL = 0x85EBCA77


def _mix(x: jax.Array) -> jax.Array:
    x = x ^ (x >> 16)
    x = x * jnp.uint32(_M1)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(_M2)
    return x ^ (x >> 16)


def hash_u32(seed, chain, step) -> jax.Array:
    """uint32 draw for (seed, chain, step); arguments broadcast like jnp.

    All three are reinterpreted as uint32 (int32 seeds keep their bits)."""
    seed, chain, step = (_as_u32(v) for v in (seed, chain, step))
    x = _mix(seed ^ (chain * jnp.uint32(_GOLDEN)))
    return _mix(x ^ (step * jnp.uint32(_STEP_MUL)) ^ jnp.uint32(_GOLDEN))


def _as_u32(v) -> jax.Array:
    v = jnp.asarray(v)
    if v.dtype == jnp.uint32:
        return v
    if v.dtype == jnp.int32:
        return jax.lax.bitcast_convert_type(v, jnp.uint32)
    return v.astype(jnp.uint32)


def seed_from_key(key: jax.Array) -> jax.Array:
    """One int32 kernel seed drawn from a JAX PRNG key."""
    return jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max, jnp.int32)
