"""rlsolver_tpu: a JAX framework for massively-parallel combinatorial
optimization with reinforcement learning, run on NVIDIA GPUs.

Built from scratch on JAX/XLA (jit + vmap + shard_map, Pallas kernels for hot
sampling loops). Capability parity target: Open-Finance-Lab/RLSolver (see
SURVEY.md for the structural analysis of the reference).

Layers (cf. SURVEY.md section 1):
  core/       instance IO, graph containers, generators, codecs, result files
  problems/   per-problem objective functions (host reference + batched device)
  ops/        batched device primitives: cut/energy reductions, flip gains,
              MCMC sampling, elitist reductions; Pallas kernels under ops/pallas
  envs/       pure-functional vectorized environments (Pattern I and II)
  models/     flax networks (MPNN, policy nets, graph transformer)
  algos/      RL methods (MCPG, dREINFORCE/L2A, DQN/ECO, PPO, ISCO, ...)
  classical/  greedy / simulated annealing / GA / random walk / local search
  solvers/    host-side MILP/QUBO solver adapters (optional)
  parallel/   mesh construction, shard_map rollout wrappers, collectives
  train/      unified trainer loop utilities
  eval/       evaluator, recorders, benchmark harness
"""

__version__ = "0.1.0"
