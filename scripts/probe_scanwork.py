"""Bisect the long-scan worker-crash boundary that `algos/isco.py` guards.

On an earlier backend, single `lax.scan` ISCO segments crashed the device
worker ("kernel fault") when they got too long, and the boundary tracked
N * segment_steps, not segment length alone:

    N=500 x 1000 steps  CRASH      N=500 x 800  PASS
    N=300 x 1000        PASS       N=700 x 700  PASS (rebalanced)

`algos/isco.py` guards with SCAN_WORK_BUDGET = 3.2e5 node-steps. This
prober finds whether a device still has such a boundary: for each N it
binary-searches the largest passing segment length, EACH ATTEMPT IN ITS OWN
SUBPROCESS (a crash can leave that process's backend unusable). Run it
alone on the card: one process at a time.

Usage: python scripts/probe_scanwork.py [--ns 300,500,700,1000]
       [--lo 200] [--hi 2000] [--graphs 10]
Prints one line per probe and a final boundary table; exit 0 always (the
findings are the output).
"""

from __future__ import annotations

import _bootstrap  # noqa: F401  (puts the repo root on sys.path)

import argparse
import os
import subprocess
import sys

CHILD = r"""
import sys
from rlsolver_tpu.algos.isco import ISCOConfig, solve_maxcut_isco_cell
import rlsolver_tpu.algos.isco as isco_mod
from rlsolver_tpu.core.generate import graph_from_name

n, seg, g_cnt = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
# force the probe's segment length through the module guard
isco_mod.MAX_SCAN_SEGMENT = seg
isco_mod.SCAN_WORK_BUDGET = n * seg
gs = [graph_from_name(f"BA_{n}_ID{i}") for i in range(g_cnt)]
cfg = ISCOConfig(batch_size=256, chain_length=seg, seed=0)
bits, vals = solve_maxcut_isco_cell(gs, cfg, mode="dense")
print(f"OK N={n} seg={seg}", flush=True)
"""


def probe(n: int, seg: int, g_cnt: int) -> bool:
    r = subprocess.run(
        [sys.executable, "-u", "-c", CHILD, str(n), str(seg), str(g_cnt)],
        capture_output=True, text=True, timeout=1800, env=os.environ,
    )
    ok = r.returncode == 0 and "OK" in r.stdout
    tail = (r.stdout + r.stderr).strip().splitlines()
    tail = tail[-1][:120] if tail else ""
    print(f"{'PASS' if ok else 'CRASH'} N={n} seg={seg}: {tail}", flush=True)
    return ok


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--ns", default="300,500,700,1000")
    p.add_argument("--lo", type=int, default=200)
    p.add_argument("--hi", type=int, default=2000)
    p.add_argument("--graphs", type=int, default=10)
    args = p.parse_args()
    boundary = {}
    for n in (int(x) for x in args.ns.split(",")):
        lo, hi = args.lo, args.hi  # invariant: lo passes (checked), hi crashes
        if not probe(n, lo, args.graphs):
            boundary[n] = f"< {lo}"
            continue
        if probe(n, hi, args.graphs):
            boundary[n] = f">= {hi}"
            continue
        while hi - lo > max(50, lo // 8):
            mid = (lo + hi) // 2
            if probe(n, mid, args.graphs):
                lo = mid
            else:
                hi = mid
        boundary[n] = f"pass<={lo} crash>={hi} (N*seg ~ {n * lo}-{n * hi})"
    print("boundary table:", flush=True)
    for n, b in boundary.items():
        print(f"  N={n}: {b}", flush=True)


if __name__ == "__main__":
    main()
