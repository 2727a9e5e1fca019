"""Debug/observability helpers: profiler traces, memory gauges, NaN guards.

Reference counterparts (SURVEY.md section 5): `gpu_info_str` /
`show_gpu_memory` (`methods/util.py:76-85,578-592`), the inf-check
`check_tensor` (`envs/env_ISCO.py:446-448`), and the print-based timers.
Equivalents here: `jax.profiler` traces, device memory stats, and
pytree-wide finiteness assertions.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler trace (view with TensorBoard/XProf)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_memory_str(device=None) -> str:
    """Human-readable live/peak device memory (`show_gpu_memory` twin)."""
    device = device or jax.devices()[0]
    stats = getattr(device, "memory_stats", lambda: None)()
    if not stats:
        return f"{device}: memory stats unavailable"
    gb = 1024**3
    live = stats.get("bytes_in_use", 0) / gb
    peak = stats.get("peak_bytes_in_use", 0) / gb
    limit = stats.get("bytes_limit", 0) / gb
    return f"{device}: live {live:.2f} GiB, peak {peak:.2f} GiB, limit {limit:.2f} GiB"


def assert_finite(tree, name: str = "tree") -> None:
    """Host-side finiteness check over a pytree (`check_tensor` twin)."""
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        arr = np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
            keystr = jax.tree_util.keystr(path)
            raise FloatingPointError(f"non-finite values in {name}{keystr}")


@contextlib.contextmanager
def nan_guard() -> Iterator[None]:
    """Enable jax debug-NaNs inside the scope (opt-in, slows compiles)."""
    prev = jax.config.read("jax_debug_nans")
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)
