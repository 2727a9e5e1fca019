"""Multi-host setup: distributed init, 2-D meshes, cross-host collectives.

Reference counterpart (SURVEY.md section 2.9 / section 5): the reference's
only multi-accelerator substrate is NCCL `torch.distributed` process groups
(`S2V_PPO/train_ddp.py:16-61`) plus `mp.spawn` launchers. The JAX
equivalent is `jax.distributed.initialize` once per host and ONE SPMD
program over a mesh with axes ("host", "device"): intra-host collectives
ride the cards' NVLink, the host axis rides the network. Environments shard over both axes;
params replicate; `psum` over the flattened ("host", "device") pair is the
DDP all-reduce.

Everything here works identically on a real multi-host slice and on the
virtual 8-device CPU mesh used by tests (host axis simulated).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

HOST_AXIS = "host"
DEVICE_AXIS = "device"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """`jax.distributed.initialize` wrapper; no-op on a single process.

    Pass the arguments explicitly (coordinator `host:port`, process count
    and index) on CPU and GPU clusters. Returns True if distributed mode
    is active after the call.
    """
    if jax.process_count() > 1:
        return True
    if coordinator_address is None and num_processes in (None, 1):
        return False  # single-process run; nothing to do
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_count() > 1


def make_host_device_mesh(
    num_hosts: Optional[int] = None, axis_names: Tuple[str, str] = (HOST_AXIS, DEVICE_AXIS)
) -> Mesh:
    """2-D mesh [hosts, devices-per-host] over all global devices.

    With real multi-host JAX, rows follow process boundaries
    (devices sorted by process_index); single-process tests pass
    `num_hosts` to simulate the host axis on local devices.
    """
    devices = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n = len(devices)
    hosts = num_hosts or max(1, jax.process_count())
    if n % hosts != 0:
        raise ValueError(f"{n} devices not divisible into {hosts} hosts")
    grid = np.asarray(devices).reshape(hosts, n // hosts)
    return Mesh(grid, axis_names)


def env_sharding_2d(mesh: Mesh) -> NamedSharding:
    """Shard a [B, ...] env batch over BOTH axes (B = hosts * devices * local)."""
    return NamedSharding(mesh, P((HOST_AXIS, DEVICE_AXIS)))


def replicated_2d(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def psum_all(x: jax.Array) -> jax.Array:
    """Sum over the full mesh: within a host and across hosts."""
    return jax.lax.psum(x, (HOST_AXIS, DEVICE_AXIS))


def pmean_all(x):
    return jax.lax.pmean(x, (HOST_AXIS, DEVICE_AXIS))


def pmax_all(x: jax.Array) -> jax.Array:
    return jax.lax.pmax(x, (HOST_AXIS, DEVICE_AXIS))


def shard_rollout_2d(mesh: Mesh, fn, replicated_args: Sequence[int] = ()):
    """shard_map a per-shard rollout over the 2-D mesh: array args sharded
    on their leading axis over (host, device) except `replicated_args`;
    outputs sharded on their leading axis."""
    spec = P((HOST_AXIS, DEVICE_AXIS))

    def wrapped(*args):
        in_specs = tuple(
            jax.tree.map(lambda _: P() if i in replicated_args else spec, arg)
            for i, arg in enumerate(args)
        )
        return jax.shard_map(
            fn, mesh=mesh, in_specs=in_specs, out_specs=spec, check_vma=False
        )(*args)

    return jax.jit(wrapped)
