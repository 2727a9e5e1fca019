"""Parity against the reference implementation's own objective functions.

The reference at /root/reference is importable pure Python (objectives use
networkx/numpy only). These tests use it as a live ORACLE: identical
solutions must score identically under `rlsolver/methods/util_obj.py` and
our `rlsolver_tpu.problems.objectives` / device kernels — the "seed-matched
cut parity" contract of BASELINE.json. Skipped when the reference tree is
not mounted.
"""

import os
import sys

import numpy as np
import pytest

REF_ROOT = "/root/reference"
pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(REF_ROOT, "rlsolver")),
    reason="reference tree not mounted",
)


@pytest.fixture(scope="module")
def ref_obj():
    sys.path.insert(0, REF_ROOT)
    # the reference unconditionally imports plotly for result plotting;
    # stub it (not installed here, and irrelevant to the objectives)
    import types

    if "plotly" not in sys.modules:
        plotly = types.ModuleType("plotly")
        plotly.io = types.ModuleType("plotly.io")
        plotly.graph_objects = types.ModuleType("plotly.graph_objects")
        sys.modules["plotly"] = plotly
        sys.modules["plotly.io"] = plotly.io
        sys.modules["plotly.graph_objects"] = plotly.graph_objects
    import importlib

    mod = importlib.import_module("rlsolver.methods.util_obj")
    return mod


@pytest.fixture(scope="module")
def instances():
    from rlsolver_tpu.config import GraphType
    from rlsolver_tpu.core.generate import generate_graph

    return [
        generate_graph(GraphType.BA, 32, seed=0),
        generate_graph(GraphType.ER, 24, seed=1),
        generate_graph(GraphType.PL, 40, seed=2),
    ]


def random_solutions(n, count=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(count, n) < 0.5).astype(np.int64)


def test_maxcut_objective_parity(ref_obj, instances):
    from rlsolver_tpu.problems.objectives import obj_maxcut

    for g in instances:
        nxg = g.to_networkx()
        for sol in random_solutions(g.num_nodes, seed=3):
            ours = obj_maxcut(sol, g)
            theirs = ref_obj.obj_maxcut(sol.tolist(), nxg)
            assert abs(ours - float(theirs)) < 1e-6


def test_maxcut_device_kernel_parity(ref_obj, instances):
    import jax.numpy as jnp

    from rlsolver_tpu.envs.maxcut import MaxcutEnv

    for g in instances:
        nxg = g.to_networkx()
        env_dense = MaxcutEnv(g)
        env_sparse = MaxcutEnv(g, mode="sparse")
        sols = random_solutions(g.num_nodes, seed=4)
        dev_dense = np.asarray(env_dense.obj(jnp.asarray(sols, bool)))
        dev_sparse = np.asarray(env_sparse.obj(jnp.asarray(sols, bool)))
        for i, sol in enumerate(sols):
            theirs = float(ref_obj.obj_maxcut(sol.tolist(), nxg))
            assert dev_dense[i] == theirs
            assert dev_sparse[i] == theirs


def test_graph_partitioning_parity(ref_obj, instances):
    from rlsolver_tpu.problems.objectives import obj_graph_partitioning

    for g in instances:
        nxg = g.to_networkx()
        n = g.num_nodes
        # balanced and unbalanced solutions
        for sol in [
            np.asarray([i % 2 for i in range(n)]),
            np.asarray([0] * (n // 2) + [1] * (n - n // 2)),
            random_solutions(n, count=1, seed=5)[0],
        ]:
            ours = obj_graph_partitioning(sol, g)
            theirs = float(ref_obj.obj_graph_partitioning(sol.tolist(), nxg))
            if theirs <= -1e5 or ours <= -1e5:
                # infeasible (unbalanced): both must flag it; the -INF
                # sentinel constants differ between implementations
                assert theirs <= -1e5 and ours <= -1e5
            else:
                assert abs(ours - theirs) < 1e-6


def test_mvc_mis_parity(ref_obj, instances):
    from rlsolver_tpu.problems.objectives import (
        obj_maximum_independent_set,
        obj_minimum_vertex_cover,
    )
    from rlsolver_tpu.classical.greedy import greedy_mis, greedy_mvc

    for g in instances:
        nxg = g.to_networkx()
        # feasible solutions from our greedy solvers
        mis_bits, _ = greedy_mis(g)
        mvc_bits, _ = greedy_mvc(g)
        ours_mis = obj_maximum_independent_set(mis_bits.astype(np.int64), g)
        theirs_mis = float(ref_obj.obj_MIS(mis_bits.astype(np.int64).tolist(), nxg))
        assert abs(ours_mis - theirs_mis) < 1e-6
        ours_mvc = obj_minimum_vertex_cover(mvc_bits.astype(np.int64), g)
        theirs_mvc = float(
            ref_obj.obj_MVC(mvc_bits.astype(np.int64).tolist(), nxg)
        )
        assert abs(ours_mvc - theirs_mvc) < 1e-6


def test_graph_coloring_parity(ref_obj, instances):
    from rlsolver_tpu.classical.coloring import dsatur
    from rlsolver_tpu.problems.objectives import obj_graph_coloring

    for g in instances:
        nxg = g.to_networkx()
        colors, k = dsatur(g)
        ours = obj_graph_coloring(colors.astype(np.int64), g)
        theirs = float(ref_obj.obj_graph_coloring(colors.astype(np.int64).tolist(), nxg))
        assert abs(ours - theirs) < 1e-6


def test_gset_file_reader_parity(ref_obj):
    """Our reader and the reference reader agree on the shipped instance."""
    path = os.path.join(REF_ROOT, "rlsolver/data/gset/gset_14.txt")
    if not os.path.exists(path):
        pytest.skip("gset_14 not present")
    from rlsolver.methods.util_read_data import read_nxgraph

    from rlsolver_tpu.core.graph import Graph
    from rlsolver_tpu.core.io import read_graph

    ours = read_graph(path)
    theirs = Graph.from_networkx(read_nxgraph(path))
    assert ours.num_nodes == theirs.num_nodes
    np.testing.assert_array_equal(ours.edges, theirs.edges)
    np.testing.assert_array_equal(ours.weights, theirs.weights)


def test_signed_weight_maxcut_parity(ref_obj):
    """+-1 edge weights (the G11/G32-class Gset shape): objective, device
    kernels, and the signed 1-flip sweep all agree with the
    reference oracle (`util_obj.py:31` sums signed adjacency entries)."""
    import jax.numpy as jnp

    from rlsolver_tpu.config import GraphType
    from rlsolver_tpu.core.generate import generate_graph
    from rlsolver_tpu.core.graph import Graph
    from rlsolver_tpu.envs.maxcut import MaxcutEnv
    from rlsolver_tpu.problems.objectives import obj_maxcut

    base = generate_graph(GraphType.BA, 32, seed=6)
    edges = [
        (a, b, -1.0 if (a + b) % 2 else 1.0) for a, b, _ in base.to_edge_list()
    ]
    g = Graph.from_edge_list(base.num_nodes, edges, name="BA_32_pm1")
    nxg = g.to_networkx()
    env = MaxcutEnv(g)
    sols = random_solutions(g.num_nodes, seed=7)
    dev = np.asarray(env.obj(jnp.asarray(sols, bool)))
    for i, sol in enumerate(sols):
        theirs = float(ref_obj.obj_maxcut(sol.tolist(), nxg))
        assert abs(obj_maxcut(sol, g) - theirs) < 1e-6
        assert dev[i] == theirs
    # the signed sweep's accepted state must re-score consistently
    bits = jnp.asarray(sols, bool)
    swept, _ = env.sweep_1flip(bits, env.obj(bits))
    vs = np.asarray(env.obj(swept))
    for i in range(sols.shape[0]):
        theirs = float(ref_obj.obj_maxcut(np.asarray(swept)[i].astype(int).tolist(), nxg))
        assert vs[i] == theirs
        assert vs[i] >= dev[i]  # sweep never worsens the cut
