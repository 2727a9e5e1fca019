"""Pallas kernels (Triton route) for MCPG's two hot loops on the GPU.

`mh_sampler.mh_sample_fused` runs the Metropolis-Hastings proposal rounds
and `mcpg_sweep.mcpg_sweep_fused` the degree-ordered local-search sweeps,
each on bit-packed chains held in registers, with randomness from the
shared counter hash (`ops/counter_rng.py`). Each has a plain XLA twin
(`mh_sample_reference`, `mcpg_sweep_reference`) that it matches bit for
bit; the CPU tests run the kernels in interpret mode.
"""

from rlsolver_tpu.ops.pallas.mcpg_sweep import (
    WeightedSweepTables,
    mcpg_sweep_fused,
    mcpg_sweep_reference,
    sweep_noise,
)
from rlsolver_tpu.ops.pallas.mh_sampler import (
    mh_sample_fused,
    mh_sample_reference,
    pack_bits,
    unpack_bits,
)

__all__ = [
    "WeightedSweepTables",
    "mcpg_sweep_fused",
    "mcpg_sweep_reference",
    "sweep_noise",
    "mh_sample_fused",
    "mh_sample_reference",
    "pack_bits",
    "unpack_bits",
]
