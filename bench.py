"""Benchmark: maxcut env-steps/s on one GPU on a G22-sized instance.

Workload (matches BASELINE.json config 2): 8192 parallel Pattern-II QUBO
envs on a 2000-node / 19990-edge G22-class graph (`core/generate.gnm_graph`),
running the policy-targeted random-flip MCMC rollout (MCPG's
`metro_sampling` semantics) as the bit-packed Pallas kernel
(`ops/pallas/mh_sampler.py:mh_sample_fused`), with a full objective
evaluation per jit call. One env-step = one MCMC proposal round applied to
one env. A second figure times one complete MCPG sampling round (MH
proposals + packed sweeps + objective + elitist reduce) per jit call.

Prints ONE JSON line with the metric, the device it ran on (platform,
device_kind, device count, and the card's name and power limit from
nvidia-smi); vs_baseline is relative to the 10M steps/s north star
(BASELINE.md #5). Fails without a GPU.
"""

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from rlsolver_tpu.core.generate import gnm_graph
    from rlsolver_tpu.envs.maxcut import MaxcutEnv
    from rlsolver_tpu.ops.pallas.mcpg_sweep import WeightedSweepTables, mcpg_sweep_fused
    from rlsolver_tpu.ops.pallas.mh_sampler import mh_sample_fused
    from rlsolver_tpu.ops.reductions import update_xs_by_vs
    from rlsolver_tpu.problems.objectives import obj_maxcut
    from rlsolver_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX's first device is {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()

    num_envs = 8192
    rounds_per_call = 1024  # fused MCMC proposal rounds per jit call

    graph = gnm_graph(2000, 19990, seed=22, name="G22like")
    env = MaxcutEnv(graph)
    key = jax.random.PRNGKey(0)
    xs = env.random_xs(key, num_envs)
    probs = jnp.full((graph.num_nodes,), 0.5, jnp.float32)

    @jax.jit
    def rollout(seed, xs):
        xs = mh_sample_fused(seed, probs, xs, rounds_per_call)
        return xs, env.obj(xs)

    # Warmup / compile.
    xs, vs = rollout(jnp.int32(0), xs)
    vs.block_until_ready()

    # Correctness guard: device objective == host objective on one sample.
    host_v = obj_maxcut(np.asarray(xs[0]).astype(int), graph)
    assert float(vs[0]) == host_v, f"objective mismatch {float(vs[0])} != {host_v}"

    # Timed steady state (calls are chained through xs; the final scalar
    # read below forces execution of the whole chain).
    num_calls = 32
    t0 = time.time()
    for i in range(num_calls):
        xs, vs = rollout(jnp.int32(i + 1), xs)
    float(vs[0])
    elapsed = time.time() - t0
    steps_per_sec = num_calls * rounds_per_call * num_envs / elapsed

    # ---- full-iteration metric: one complete MCPG round per jit call —
    # MH proposals (2 * change_times = 2 * N/10 rounds, `MCPG.py:100-102`)
    # + num_ls packed anti-majority sweeps + objective + elitist reduce.
    # Only the proposals count as env-steps; sweep/objective/reduce are the
    # pipeline overhead the headline metric amortizes away.
    proposal_rounds = 2 * (graph.num_nodes // 10)
    num_ls = 8
    tables = WeightedSweepTables.build(graph)

    @jax.jit
    def full_iteration(seed, xs, best_xs, best_vs):
        mh = mh_sample_fused(seed, probs, xs, proposal_rounds)
        ls = mcpg_sweep_fused(seed + 1, mh, tables, num_sweeps=num_ls)
        vs = env.obj(ls)
        best_xs, best_vs = update_xs_by_vs(best_xs, best_vs, ls, vs)
        return ls, best_xs, best_vs

    best_xs, best_vs = xs, env.obj(xs)
    xs, best_xs, best_vs = full_iteration(jnp.int32(0), xs, best_xs, best_vs)
    best_vs.block_until_ready()
    full_calls = 16
    t0 = time.time()
    for i in range(full_calls):
        xs, best_xs, best_vs = full_iteration(jnp.int32(2 * i + 2), xs, best_xs, best_vs)
    float(best_vs[0])
    full_elapsed = time.time() - t0
    full_steps_per_sec = full_calls * proposal_rounds * num_envs / full_elapsed

    print(
        json.dumps(
            {
                "metric": "maxcut_env_steps_per_sec_per_chip_G22_8k_envs",
                "value": steps_per_sec,
                "unit": "env-steps/s",
                "vs_baseline": steps_per_sec / 1e7,
                # Pattern-II target: >= 10M env-steps/s/chip on G22 with 8k
                # envs (BASELINE.md section 5 north star).
                "pattern2_target_env_steps_per_sec": 1e7,
                "full_iteration_env_steps_per_sec": full_steps_per_sec,
                "full_iteration_detail": (
                    f"{proposal_rounds} MH proposal rounds + {num_ls} packed "
                    "sweeps + objective + elitist reduce per jit call"
                ),
                "best_cut_after_bench": float(jnp.max(best_vs)),
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                    "card": card,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
