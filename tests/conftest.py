"""Test configuration.

The CPU lane is the default: JAX runs on the CPU with 8 virtual devices, so
the sharding tests see a mesh, and the Pallas kernels run in interpret
mode. `JAX_PLATFORMS` is set to "cpu" only where the caller left it unset;
the GPU lane runs the `gpu`-marked tests on a card with

    JAX_PLATFORMS=cuda python -m pytest tests/test_gpu_kernels.py -m gpu -q

Whether a card is there is decided inside the `gpu` fixture, never while
modules are imported: a GPU test skips where JAX's default backend is not
a GPU.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import rlsolver_tpu  # noqa: E402,F401


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU as JAX's default backend (compiled kernels)"
    )


@pytest.fixture(scope="session")
def gpu():
    """The card, or a skip where JAX's default backend is not a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs a GPU (run: JAX_PLATFORMS=cuda python -m pytest "
            "tests/test_gpu_kernels.py -m gpu)"
        )
    return jax.devices()[0]


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def small_graphs():
    """A few deterministic small instances used across test modules."""
    from rlsolver_tpu.config import GraphType
    from rlsolver_tpu.core.generate import generate_graph

    return {
        "BA_32": generate_graph(GraphType.BA, 32, seed=0),
        "ER_24": generate_graph(GraphType.ER, 24, seed=1),
        "PL_40": generate_graph(GraphType.PL, 40, seed=2),
    }


@pytest.fixture(scope="session")
def gset14_path():
    """The toy gset instance shipped with the reference (14 nodes, 40 edges)."""
    path = "/root/reference/rlsolver/data/gset/gset_14.txt"
    if not os.path.exists(path):
        pytest.skip("reference data not mounted")
    return path
