"""The GPU bring-up contract, checked on the CPU: the fused paths refuse a
non-GPU backend, the main path imports without optional packages, the
compile cache has one home, `chip_smoke.py` fails without a card, both
kernels lower for CUDA at G22 widths, and the data-parallel MCPG step keeps
its replicas identical."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rlsolver_tpu.core.generate import gnm_graph, graph_from_name

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "overrides", [{"sampler": "fused"}, {"sweep_mode": "packed"}],
    ids=["fused", "packed"],
)
def test_mcpg_fast_modes_raise_without_gpu(overrides):
    from rlsolver_tpu.algos.mcpg import MCPGConfig, solve_maxcut_mcpg

    cfg = MCPGConfig(total_mcmc_num=4, repeat_times=2, max_epoch_num=1, **overrides)
    with pytest.raises(RuntimeError, match="GPU kernel"):
        solve_maxcut_mcpg(graph_from_name("BA_20_ID0"), cfg)


def test_l2a_fused_ls_raises_without_gpu():
    from rlsolver_tpu.algos.l2a import L2AConfig, _l2a_setup

    with pytest.raises(RuntimeError, match="GPU kernel"):
        _l2a_setup(graph_from_name("BA_20_ID0"), L2AConfig(fused_ls=True))


BLOCKED = ("flax", "networkx", "orbax", "pandas", "matplotlib")
MAIN_PATH = (
    "rlsolver_tpu.run",
    "rlsolver_tpu.algos.mcpg",
    "rlsolver_tpu.classical.greedy",
    "rlsolver_tpu.core.generate",
    "rlsolver_tpu.core.io",
    "rlsolver_tpu.envs.maxcut",
    "rlsolver_tpu.ops.pallas",
    "rlsolver_tpu.parallel.mesh",
    "rlsolver_tpu.problems.objectives",
    "rlsolver_tpu.utils.compile_cache",
    "chip_smoke",
)


def test_main_path_imports_without_optional_packages():
    code = f"""
import importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
for m in {MAIN_PATH!r}:
    importlib.import_module(m)
from rlsolver_tpu.algos.mcpg import MCPGConfig, _build_steps
from rlsolver_tpu.core.generate import gnm_graph
from rlsolver_tpu.envs.maxcut import MaxcutEnv
from rlsolver_tpu.ops.sweeps import SweepData
g = gnm_graph(40, 100, seed=1)
_build_steps(MaxcutEnv(g), SweepData.build(g), MCPGConfig())
assert not [m for m in sys.modules if m.split(".")[0] in {BLOCKED!r}]
print("clean")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    from rlsolver_tpu.utils.compile_cache import enable_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch, restore_cache_dir):
    from rlsolver_tpu.utils.compile_cache import DEFAULT_DIR, enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert enable_compile_cache() == DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    assert enable_compile_cache() == DEFAULT_DIR  # same path on every call
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _run_smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("kernel", ["mh", "sweep_unit", "sweep_pm1"])
def test_kernels_lower_for_cuda_at_g22_width(kernel, monkeypatch):
    """Pallas -> Triton IR at the real widths: the rehearsal of what the
    card's compiler is handed (it cannot be asked here)."""
    from rlsolver_tpu.ops.pallas import mcpg_sweep, mh_sampler

    monkeypatch.setattr(mh_sampler, "require_gpu", lambda *a: None)
    monkeypatch.setattr(mcpg_sweep, "require_gpu", lambda *a: None)
    bits = jax.ShapeDtypeStruct((8192, 2000), jnp.bool_)
    seed = jax.ShapeDtypeStruct((), jnp.int32)
    if kernel == "mh":
        probs = jax.ShapeDtypeStruct((2000,), jnp.float32)
        fn = lambda s, p, b: mh_sampler.mh_sample_fused.__wrapped__(s, p, b, 400)  # noqa: E731
        args = (seed, probs, bits)
    else:
        tables = mcpg_sweep.WeightedSweepTables.build(gnm_graph(signed=kernel == "sweep_pm1"))
        fn = lambda s, b, t: mcpg_sweep.mcpg_sweep_fused.__wrapped__(s, b, t, num_sweeps=8)  # noqa: E731
        args = (seed, bits, tables)
    text = jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1
    name = "mh_sample_fused" if kernel == "mh" else "mcpg_sweep_fused"
    assert name in text


@pytest.mark.parametrize("ndev", [1, 4])
def test_sharded_mcpg_step_keeps_replicas_identical(ndev):
    from rlsolver_tpu.algos.mcpg import MCPGConfig, make_sharded_mcpg_step
    from rlsolver_tpu.envs.maxcut import MaxcutEnv
    from rlsolver_tpu.ops.sweeps import SweepData
    from rlsolver_tpu.parallel.mesh import make_mesh, replicated, shard_env_batch
    from rlsolver_tpu.problems.objectives import obj_maxcut

    g = graph_from_name("BA_48_ID3")
    env = MaxcutEnv(g)
    mesh = make_mesh(ndev)
    cfg = MCPGConfig(num_ls=2, change_times=4)
    policy, optimizer, step = make_sharded_mcpg_step(env, SweepData.build(g), cfg, mesh)
    rep = replicated(mesh)
    params = jax.device_put(policy.init(jax.random.PRNGKey(0)), rep)
    opt_state = jax.device_put(optimizer.init(params), rep)
    xs = shard_env_batch(mesh, env.random_xs(jax.random.PRNGKey(1), 8 * ndev))
    assert len({s.device for s in xs.addressable_shards}) == ndev
    for i in range(2):
        params, opt_state, ls, cuts = step(
            params, opt_state, jax.device_put(jnp.uint32(i), rep), xs
        )
    copies = [np.asarray(s.data) for s in params["params"]["logits"].addressable_shards]
    assert len(copies) == ndev
    for c in copies[1:]:
        np.testing.assert_array_equal(c.view(np.uint32), copies[0].view(np.uint32))
    assert np.abs(copies[0]).max() > 0  # the update moved the logits
    best = int(jnp.argmax(cuts))
    assert float(cuts[best]) == obj_maxcut(np.asarray(ls[best]).astype(int), g)


def test_gnm_graph_is_seeded_g22_class():
    g = gnm_graph()
    assert (g.num_nodes, g.num_edges) == (2000, 19990)
    edges = np.asarray(g.edges)
    assert (edges[:, 0] < edges[:, 1]).all()  # no self loops, one per pair
    assert len({(int(a), int(b)) for a, b in edges}) == 19990
    assert set(np.unique(np.asarray(g.weights)).tolist()) == {1.0}
    again = gnm_graph()
    np.testing.assert_array_equal(np.asarray(again.edges), edges)
    assert not np.array_equal(np.asarray(gnm_graph(seed=23).edges), edges)


def test_gnm_graph_signed_weights():
    g = gnm_graph(signed=True)
    w = np.asarray(g.weights)
    assert set(np.unique(w).tolist()) == {-1.0, 1.0}
    assert 0.45 < (w < 0).mean() < 0.55
    np.testing.assert_array_equal(np.asarray(g.edges), np.asarray(gnm_graph().edges))
