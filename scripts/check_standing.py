"""Flagship-standing check (VERDICT round-2 item #1).

Prints per-(dist, N) cell averages for GA / MCPG / L2A from
results_quality/dist_table.csv and flags every cell where L2A < GA
(required everywhere) or, on BA rows, L2A < MCPG (the reference's
dREINFORCE relative standing, /root/reference/README.md:356-371).
"""

from __future__ import annotations

import _bootstrap  # noqa: F401  (puts the repo root on sys.path)

import collections
import csv
import sys

IN = "results_quality/dist_table.csv"


def main():
    cells = collections.defaultdict(lambda: collections.defaultdict(dict))
    for r in csv.reader(open(IN)):
        if r and r[0] != "dist":
            d = cells[(r[0], int(r[1]))][r[3]]
            g = int(r[2])
            d[g] = max(d.get(g, float("-inf")), float(r[4]))  # best-row-wins
    bad = incomplete = 0
    for (dist, n) in sorted(cells, key=lambda k: (k[0], k[1])):
        algs = cells[(dist, n)]
        if "l2a" not in algs:
            continue

        def avg(a, gids=None):
            v = algs.get(a)
            if not v:
                return None
            if gids is not None:
                v = {g: v[g] for g in gids}
            return sum(v.values()) / len(v) if v else None

        # compare averages over the INTERSECTION of recorded instance ids
        # (round-3 advisor finding: partially filled cells compared
        # averages over different instance subsets)
        flags, note = [], ""
        for rival, label, active in (
            ("ga", "L2A<GA", True),
            ("mcpg", "L2A<MCPG", dist == "BA"),
        ):
            if not active or rival not in algs:
                continue
            common = sorted(set(algs["l2a"]) & set(algs[rival]))
            if len(common) < 10:
                note = f" incomplete({len(common)}/10)"
            if not common:
                continue
            if avg("l2a", common) < avg(rival, common) - 1e-9:
                flags.append(label)
        if note and not flags:
            incomplete += 1
        else:
            bad += bool(flags)

        def s(a):
            v = avg(a)
            return f"{v:7.1f}" if v is not None else "    nan"

        print(
            f"{dist}_{n:<5d} GA {s('ga')}  MCPG {s('mcpg')}"
            f"  L2A {s('l2a')}  {' '.join(flags) or 'ok'}{note}"
        )
    print(f"{bad} failing cells ({incomplete} incomplete cells excluded)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
