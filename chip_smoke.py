"""Smoke run of the MCPG main path on one NVIDIA GPU.

    python chip_smoke.py            # phases 1-3, one card
    python chip_smoke.py --multi    # phase 4 only: data-parallel MCPG, 4 cards

Each phase prints one JSON line, also appended to chiprun_out/chip_smoke.jsonl.
A line before the last gives the card's name and power limit as nvidia-smi
reports them; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

and is printed only if every phase passed. Without a GPU as JAX's first
device, or if any phase fails, the script exits non-zero without it.

 1. device: platform, kind, count, JAX version, compile cache, card.
 2. kernels at G22 widths (2000 nodes, 19,990 edges, unit and +-1 weights;
    8192 chains, 400 MH rounds, 8 sweeps): each Pallas kernel bit-exact
    against its XLA twin, the device objective against the host one, the
    GPU test lane, then each kernel's time beside the plain XLA path it
    replaces (compile time apart).
 3. MCPG end to end: the CLI (`python -m rlsolver_tpu --alg mcpg`, then
    `--fast`) on a G22-class gset file, and `solve_maxcut_mcpg` at the
    gset_22 preset's full population under a time budget; every best cut
    is re-scored on the host and must beat greedy.
 4. --multi: the env-sharded MCPG step with the fused kernels over a 1-D
    mesh of 4 cards against the same chain count on 1 card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out")
N, EDGES, CHAINS, MH_ROUNDS, SWEEPS = 2000, 19990, 8192, 400, 8


def emit(record: dict) -> None:
    line = json.dumps(record)
    print(line, flush=True)
    with open(os.path.join(OUT, "chip_smoke.jsonl"), "a") as f:
        f.write(line + "\n")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card() -> str:
    """nvidia-smi's name and power limit, read by a child that has no JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def timed(fn, *args, reps: int = 5):
    """(output, compile seconds, median and min run seconds) of jit(fn)."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        runs.append(time.perf_counter() - t0)
    return out, t_compile, float(np.median(runs)), float(min(runs))


def phase_device(cache_dir: str) -> dict:
    d = jax.devices()[0]
    return {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices()), "jax": jax.__version__,
        "compile_cache": cache_dir, "card": card(),
    }


def phase_kernels() -> dict:
    import pytest

    from rlsolver_tpu.core.generate import gnm_graph
    from rlsolver_tpu.envs.maxcut import MaxcutEnv
    from rlsolver_tpu.ops.pallas.mcpg_sweep import (
        WeightedSweepTables,
        mcpg_sweep_fused,
        mcpg_sweep_reference,
        sweep_noise_grid,
    )
    from rlsolver_tpu.ops.pallas.mh_sampler import mh_sample_fused, mh_sample_reference
    from rlsolver_tpu.ops.sampling import metropolis_bitflip_scan
    from rlsolver_tpu.ops.sweeps import SweepData, degree_ordered_sweep, mcpg_init_values
    from rlsolver_tpu.problems.objectives import obj_maxcut

    rep: dict = {"chains": CHAINS, "mh_rounds": MH_ROUNDS, "sweeps": SWEEPS}
    key = jax.random.PRNGKey(0)
    probs = jax.random.uniform(key, (N,), minval=0.2, maxval=0.8)
    bits = jax.random.bernoulli(jax.random.fold_in(key, 1), 0.5, (CHAINS, N))
    seed = jnp.int32(7)

    out, tc, tk, tk_min = timed(lambda s, p, b: mh_sample_fused(s, p, b, MH_ROUNDS), seed, probs, bits)
    ref, _, _, _ = timed(lambda s, p, b: mh_sample_reference(s, p, b, MH_ROUNDS), seed, probs, bits, reps=1)
    check(bool(jnp.array_equal(out, ref)), "mh_sample_fused == mh_sample_reference")
    _, xc, tx, tx_min = timed(lambda k, p, b: metropolis_bitflip_scan(k, p, b, MH_ROUNDS), key, probs, bits)
    rep["mh"] = {
        "bit_exact_vs_twin": True, "kernel_s": tk, "kernel_min_s": tk_min,
        "kernel_compile_s": tc, "xla_scan_s": tx, "xla_scan_min_s": tx_min,
        "xla_scan_compile_s": xc, "speedup": tx / tk,
    }

    for signed in (False, True):
        g = gnm_graph(N, EDGES, seed=22, signed=signed)
        t = WeightedSweepTables.build(g)
        out, tc, tk, tk_min = timed(
            lambda s, b, tt: mcpg_sweep_fused(s, b, tt, num_sweeps=SWEEPS), seed, bits, t
        )
        noise = sweep_noise_grid(7, CHAINS, SWEEPS * N)
        ref, _, _, _ = timed(
            lambda nz, b: mcpg_sweep_reference(nz, b, t, g, num_sweeps=SWEEPS),
            noise, bits, reps=1,
        )
        check(bool(jnp.array_equal(out, ref)), f"mcpg_sweep_fused == twin ({g.name})")
        data = SweepData.build(g)
        _, xc, tx, tx_min = timed(
            lambda k, b: degree_ordered_sweep(k, mcpg_init_values(b), data, num_sweeps=SWEEPS),
            key, bits,
        )
        env = MaxcutEnv(g)
        vs = np.asarray(env.obj(out))
        rows = np.asarray(out[:: CHAINS // 16])
        host = [obj_maxcut(r, g) for r in rows]
        check(list(vs[:: CHAINS // 16]) == host, f"env.obj == host obj_maxcut ({g.name})")
        rep["sweep_pm1" if signed else "sweep_unit"] = {
            "bit_exact_vs_twin": True,
            "twin_matmul_precision": "HIGHEST (f32)",
            "env_obj_equals_host_on_rows": len(host),
            "env_obj_precision": "bf16 adjacency and signs, f32 accumulation",
            "kernel_s": tk, "kernel_min_s": tk_min, "kernel_compile_s": tc,
            "xla_sweep_s": tx, "xla_sweep_min_s": tx_min, "xla_sweep_compile_s": xc,
            "speedup": tx / tk, "mean_cut_after": float(vs.mean()),
        }

    # the GPU test lane, in this process (one process uses the card)
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(ROOT, "tests", "test_gpu_kernels.py")])
    summary = [ln for ln in buf.getvalue().splitlines() if ln.strip()][-1:]
    rep["gpu_test_lane"] = {"exit_code": int(rc), "summary": summary}
    check(int(rc) == 0, f"GPU test lane passed: {summary}")
    return rep


def phase_mcpg() -> dict:
    from rlsolver_tpu import run
    from rlsolver_tpu.algos.mcpg import GSET_PRESETS, solve_maxcut_mcpg
    from rlsolver_tpu.classical.greedy import greedy_maxcut
    from rlsolver_tpu.core.generate import gnm_graph
    from rlsolver_tpu.core.io import read_graph, write_graph
    from rlsolver_tpu.problems.objectives import obj_maxcut

    data_dir = os.path.join(OUT, "data")
    path = os.path.join(data_dir, "G22like_2000_19990.txt")
    write_graph(gnm_graph(N, EDGES, seed=22, name="G22like"), path)
    g = read_graph(path)
    greedy = float(greedy_maxcut(g)[1])
    rep: dict = {"instance": path, "greedy_cut": greedy}

    solutions = {}
    mcpg = run.SOLVERS["mcpg"]

    def recording(graph, seed, fast=False):
        out = mcpg(graph, seed, fast=fast)
        solutions[fast] = out
        return out

    run.SOLVERS["mcpg"] = recording
    try:
        for fast in (False, True):
            argv = ["--alg", "mcpg", "--data-dir", data_dir, "--no-write"]
            t0 = time.perf_counter()
            check(run.main(argv + (["--fast"] if fast else [])) == 0, "CLI exit 0")
            bits, cut = solutions[fast][0], float(solutions[fast][1])
            host = obj_maxcut(np.asarray(bits).astype(int), g)
            check(host == cut, f"CLI best cut re-scores on the host ({cut} vs {host})")
            check(cut > greedy, f"MCPG cut {cut} beats greedy {greedy}")
            rep["cli_fast" if fast else "cli_xla"] = {
                "best_cut": cut, "host_cut": host, "wall_s": time.perf_counter() - t0,
            }
    finally:
        run.SOLVERS["mcpg"] = mcpg

    cfg = dataclasses.replace(
        GSET_PRESETS["gset_22"], sampler="fused", sweep_mode="packed", max_epoch_num=1
    )
    t0 = time.perf_counter()
    bits, cut, ev = solve_maxcut_mcpg(g, cfg, time_budget=30.0)
    host = obj_maxcut(np.asarray(bits).astype(int), g)
    check(host == float(cut), f"full-population best cut re-scores ({cut} vs {host})")
    check(float(cut) > greedy, f"full-population cut {cut} beats greedy {greedy}")
    stats = jax.devices()[0].memory_stats() or {}
    rep["full_population"] = {
        "chains": cfg.total_mcmc_num * cfg.repeat_times, "preset": "gset_22",
        "sampler": cfg.sampler, "sweep_mode": cfg.sweep_mode,
        "rounds": len(ev.records) - 1, "best_cut": float(cut), "host_cut": host,
        "wall_s": time.perf_counter() - t0,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "bytes_limit": stats.get("bytes_limit"),
    }
    return rep


def phase_multi() -> dict:
    from rlsolver_tpu.algos.mcpg import MCPGConfig, make_sharded_mcpg_step
    from rlsolver_tpu.core.generate import gnm_graph
    from rlsolver_tpu.envs.maxcut import MaxcutEnv
    from rlsolver_tpu.ops.sweeps import SweepData
    from rlsolver_tpu.parallel.mesh import make_mesh, replicated, shard_env_batch
    from rlsolver_tpu.problems.objectives import obj_maxcut

    check(len(jax.devices()) >= 4, f"4 devices, found {len(jax.devices())}")
    g = gnm_graph(N, EDGES, seed=22)
    env, data = MaxcutEnv(g), SweepData.build(g)
    cfg = MCPGConfig(sampler="fused", sweep_mode="packed", num_ls=SWEEPS)
    total = 4 * CHAINS
    xs0 = env.random_xs(jax.random.PRNGKey(1), total)
    rep: dict = {"chains": total, "cards": card().splitlines()}
    for ndev in (1, 4):
        mesh = make_mesh(ndev)
        policy, optimizer, step = make_sharded_mcpg_step(env, data, cfg, mesh)
        rep_sh = replicated(mesh)
        params = jax.device_put(policy.init(jax.random.PRNGKey(0)), rep_sh)
        opt_state = jax.device_put(optimizer.init(params), rep_sh)
        xs = shard_env_batch(mesh, xs0)
        spread = sorted((s.device.id, s.data.shape[0]) for s in xs.addressable_shards)
        check(len({d for d, _ in spread}) == ndev, f"chains spread over {ndev} devices: {spread}")
        check(all(rows == total // ndev for _, rows in spread), f"equal shards: {spread}")
        seed = jax.device_put(jnp.uint32(3), rep_sh)
        params, opt_state, ls, cuts = jax.block_until_ready(step(params, opt_state, seed, xs))
        runs = []
        for i in range(5):
            t0 = time.perf_counter()
            params, opt_state, ls, cuts = jax.block_until_ready(
                step(params, opt_state, jax.device_put(jnp.uint32(4 + i), rep_sh), xs)
            )
            runs.append(time.perf_counter() - t0)
        copies = [np.asarray(s.data).view(np.uint32) for s in
                  params["params"]["logits"].addressable_shards]
        check(len(copies) == ndev, "one params copy per device")
        check(all(np.array_equal(copies[0], c) for c in copies[1:]),
              "replicated params bit-identical across shards")
        best = int(jnp.argmax(cuts))
        host = obj_maxcut(np.asarray(ls[best]).astype(int), g)
        check(host == float(cuts[best]), f"best cut re-scores ({float(cuts[best])} vs {host})")
        rep[f"cards_{ndev}"] = {
            "step_s": float(np.median(runs)), "step_min_s": float(min(runs)),
            "shards": spread, "params_identical": True, "best_cut": host,
        }
    rep["speedup_4_vs_1"] = rep["cards_1"]["step_s"] / rep["cards_4"]["step_s"]
    return rep


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the 4-card data-parallel MCPG phase")
    args = p.parse_args(argv)
    import rlsolver_tpu  # noqa: F401  (fails outside a checkout of the repo)
    from rlsolver_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX's first device is {dev.platform!r}, not a GPU",
              file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    phases = [("device", lambda: phase_device(cache_dir))]
    if args.multi:
        phases.append(("multi", phase_multi))
    else:
        phases += [("kernels", phase_kernels), ("mcpg", phase_mcpg)]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            rec = {"phase": name, "ok": True, **fn()}
        except Exception as e:  # report every phase; the exit code says it failed
            traceback.print_exc()
            rec = {"phase": name, "ok": False, "error": repr(e)}
            failed.append(name)
        rec["phase_s"] = time.perf_counter() - t0
        emit(rec)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
