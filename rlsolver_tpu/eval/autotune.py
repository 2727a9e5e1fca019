"""Throughput autotuner: pick the best env-batch size for this chip.

Reference counterpart: `find_best_num_sims_maxcut`
(`rlsolver/envs/env_L2A.py:143-230`) — sweeps `num_sims` multipliers,
prints steps/sec and GPU RAM, and reports the knee. Same capability here
as a reusable helper: time any `fn(num_sims) -> jittable work` over a
sweep of batch sizes and return the throughput-optimal one. Used to pick
`num_sims` for MCPG/local-search runs on a new accelerator generation.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

import jax


def measure_throughput(
    run: Callable[[int], object], num_sims: int, reps: int = 3
) -> float:
    """Items/sec for `run(num_sims)` (first call excluded: compile)."""
    out = run(num_sims)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run(num_sims)
    jax.block_until_ready(out)
    return num_sims * reps / (time.perf_counter() - t0)


def find_best_num_sims(
    run: Callable[[int], object],
    candidates: Optional[Sequence[int]] = None,
    reps: int = 3,
    verbose: bool = False,
) -> Tuple[int, List[Tuple[int, float]]]:
    """Sweep batch sizes; returns (best num_sims, [(num_sims, items/s)]).

    Default sweep: powers of two 2^8 .. 2^14 (the reference sweeps
    multipliers of a base sim count up to 2^16). OOM candidates are
    skipped and recorded with throughput 0.
    """
    if candidates is None:
        candidates = [2**k for k in range(8, 15)]
    results: List[Tuple[int, float]] = []
    for n in candidates:
        try:
            tp = measure_throughput(run, n, reps)
        except Exception:  # OOM or compile failure at this size
            tp = 0.0
        results.append((n, tp))
        if verbose:
            print(f"num_sims={n:>7}  throughput={tp:,.0f}/s")
    best = max(results, key=lambda t: t[1])[0]
    return best, results
