"""Calibrate MCPG config for the distribution-wise quality table.

Runs MCPG on BA_100_ID0..9 (reference avg: 284.1, README.md:360) with a
candidate config and prints per-instance cuts, the average, and wall time.
"""

import _bootstrap  # noqa: F401  (puts the repo root on sys.path)

import sys
import time

import numpy as np

from rlsolver_tpu.algos.mcpg import MCPGConfig, solve_maxcut_mcpg
from rlsolver_tpu.core.generate import graph_from_name

mode = sys.argv[1] if len(sys.argv) > 1 else "sequential"
n = int(sys.argv[2]) if len(sys.argv) > 2 else 100
ids = range(int(sys.argv[3]) if len(sys.argv) > 3 else 10)

cfg = MCPGConfig(
    total_mcmc_num=512,
    repeat_times=64,
    num_ls=8,
    max_epoch_num=6,
    reset_epoch_num=64,
    sweep_mode=mode,
)
cuts = []
for i in ids:
    g = graph_from_name(f"BA_{n}_ID{i}")
    t0 = time.time()
    _, v, _ = solve_maxcut_mcpg(g, cfg)
    dt = time.time() - t0
    cuts.append(v)
    print(f"BA_{n}_ID{i}: cut={v:.0f}  ({dt:.1f}s)", flush=True)
print(f"avg={np.mean(cuts):.1f}  mode={mode}")
