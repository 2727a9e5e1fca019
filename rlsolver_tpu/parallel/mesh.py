"""Device mesh construction and env-axis sharding helpers.

The reference's only true multi-accelerator paths are NCCL DDP with per-rank
env shards (`rlsolver/methods/S2V_PPO/train_ddp.py:16-61,216-217`) and a
process-pipe actor-learner topology (`elegantrl/train/run.py:141-359`). The
single-program replacement (SURVEY.md section 2.9) is one SPMD program:

  * a 1-D mesh over all chips with axis "env";
  * environment state sharded along the sim axis;
  * network parameters replicated (models are small);
  * `psum`/`pmax` over the mesh for losses, metrics, and incumbent tracking.

Everything here works identically on a real pod slice and on the virtual
8-device CPU mesh used by tests.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ENV_AXIS = "env"


def make_mesh(num_devices: Optional[int] = None, axis_name: str = ENV_AXIS) -> Mesh:
    """A 1-D mesh over (the first `num_devices`) local devices."""
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def env_sharding(mesh: Mesh, axis_name: str = ENV_AXIS) -> NamedSharding:
    """Shard the leading (sim) axis of env state across the mesh."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_env_batch(mesh: Mesh, xs: jax.Array, axis_name: str = ENV_AXIS) -> jax.Array:
    """Place a [B, ...] batch with B sharded over the mesh."""
    return jax.device_put(xs, env_sharding(mesh, axis_name))


def shard_rollout(
    mesh: Mesh,
    fn: Callable,
    out_specs=None,
    axis_name: str = ENV_AXIS,
    replicated_args: Sequence[int] = (),
):
    """Wrap a per-shard rollout `fn(*args) -> out` in shard_map + jit.

    Array args are sharded on their leading axis except positions listed in
    `replicated_args` (e.g. parameter pytrees, scalars); outputs are sharded
    on their leading axis unless `out_specs` (a PartitionSpec pytree matching
    fn's output structure) says otherwise. Inside `fn`, collectives over
    `axis_name` are available (`jax.lax.psum(..., axis_name)` etc.).
    """
    if out_specs is None:
        out_specs = P(axis_name)

    def spec_for(i):
        return P() if i in replicated_args else P(axis_name)

    def wrapped(*args):
        in_specs = tuple(
            jax.tree.map(lambda _: spec_for(i), arg) for i, arg in enumerate(args)
        )
        return jax.shard_map(
            fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
        )(*args)

    return jax.jit(wrapped)


def psum_metric(x: jax.Array, axis_name: str = ENV_AXIS) -> jax.Array:
    return jax.lax.psum(x, axis_name)


def pmax_metric(x: jax.Array, axis_name: str = ENV_AXIS) -> jax.Array:
    return jax.lax.pmax(x, axis_name)
