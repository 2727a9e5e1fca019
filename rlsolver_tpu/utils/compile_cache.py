"""JAX's persistent compilation cache, at one place per checkout.

`JAX_COMPILATION_CACHE_DIR`, when set, is the cache: JAX reads it itself
and nothing here overrides it. Otherwise the cache lives at a fixed path
inside the checkout (`.jax_cache/`, listed in `.gitignore`), so every run
from this checkout — the CLI, `bench.py`, `chip_smoke.py` — finds the
programs an earlier run compiled.
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    if jax.config.jax_compilation_cache_dir != path:
        jax.config.update("jax_compilation_cache_dir", path)
    return path
