"""Render results_quality/dist_table.csv into the distribution-wise
benchmark table (reference `README.md:356-371`, `Benchmark.rst:17-76`):
per (distribution, N) average best cut per method over the 10 seeded
instances, plus the HiGHS time-limited bound and the MCPG/L2A gap to it.

Writes results_quality/DIST_TABLE.md. Usage: python scripts/summarize_quality.py
"""

from __future__ import annotations

import _bootstrap  # noqa: F401  (puts the repo root on sys.path)

import collections
import csv
import os

IN = "results_quality/dist_table.csv"
OUT = "results_quality/DIST_TABLE.md"
ALGS = [
    "rw", "greedy", "sdp", "sa", "ga", "s2v", "eco", "pignn", "jumanji",
    "isco", "mcpg", "l2a", "milp", "bound",
]
LABEL = {
    "rw": "RandomWalk", "greedy": "Greedy", "sdp": "SDP-GW", "sa": "SA",
    "ga": "GA+tabu", "s2v": "S2V-DQN", "eco": "ECO-DQN", "pignn": "PI-GNN",
    "jumanji": "Jumanji", "isco": "ISCO", "mcpg": "MCPG", "l2a": "L2A",
    "milp": "HiGHS-60s", "bound": "bound",
}


def main():
    by_gid = collections.defaultdict(dict)  # (dist, n) -> alg -> {gid: obj}
    with open(IN) as f:
        for r in csv.reader(f):
            if not r or r[0] == "dist":
                continue
            dist, n, gid, alg, obj = r[0], int(r[1]), int(r[2]), r[3], float(r[4])
            cell = by_gid[(dist, n)].setdefault(alg, {})
            if alg in ("specb", "milp_bound"):
                # every recorded bound is certified: keep the tightest
                cell[gid] = min(cell.get(gid, obj), obj)
            else:
                # best-row-wins for maximization algs (mirrors
                # instance_wise semantics): a --redo attempt that happens
                # to score worse can never degrade the published table
                # (round-4 advisor finding on later-rows-win)
                cell[gid] = max(cell.get(gid, obj), obj)
    rows = {
        k: {alg: list(d.values()) for alg, d in cell.items()}
        for k, cell in by_gid.items()
    }

    def avg(v):
        return sum(v) / len(v)

    # "bound" = per-instance min of the HiGHS MILP dual bound and the
    # certified Poljak-Rendl spectral bound (both valid maxcut upper
    # bounds; the spectral one is the tight one from N >= 200)
    for key, cell_g in by_gid.items():
        parts = [cell_g.get("milp_bound"), cell_g.get("specb")]
        parts = [p for p in parts if p]
        if parts:
            gids = set.intersection(*(set(p) for p in parts))
            if gids:
                rows[key]["bound"] = [
                    min(p[g] for p in parts) for g in sorted(gids)
                ]

    lines = [
        "# Distribution-wise maxcut benchmark (10 seeded instances per cell)",
        "",
        "Average best cut per method; reference protocol `README.md:356-371`.",
        "Instances are the seeded `{dist}_{N}_ID{i}` generator contract",
        "(`core/generate.py`), identical to the reference's `load_mygraph2`",
        "seeding. `bound` is the per-instance min of the HiGHS time-limited",
        "MILP dual bound and the certified Poljak-Rendl spectral bound",
        "(`classical/spectral_bound.py`) — the license-free analogue of the",
        "reference's Gurobi-1h 'obj bound' column (`README.md:335`); `gap%` =",
        "(bound - alg) / bound for the best learned method.",
        "",
    ]
    for dist in ("BA", "ER", "PL"):
        ns = sorted(n for (d, n) in rows if d == dist)
        if not ns:
            continue
        lines.append(f"## {dist}")
        lines.append("")
        header = "| N | " + " | ".join(LABEL[a] for a in ALGS) + " | best-RL gap% |"
        lines.append(header)
        lines.append("|" + "---|" * (len(ALGS) + 2))
        for n in ns:
            cell = rows[(dist, n)]
            vals = []
            for a in ALGS:
                if a in cell and len(cell[a]) > 0:
                    suffix = "*" if len(cell[a]) < 10 else ""
                    vals.append(f"{avg(cell[a]):.1f}{suffix}")
                else:
                    vals.append("—")
            rl = max(
                (avg(cell[a]) for a in ("mcpg", "l2a") if a in cell), default=None
            )
            if rl is not None and "bound" in cell:
                gap = (avg(cell["bound"]) - rl) / avg(cell["bound"]) * 100
                gap_s = f"{gap:+.2f}"
            else:
                gap_s = "—"
            lines.append(f"| {n} | " + " | ".join(vals) + f" | {gap_s} |")
        lines.append("")
    lines.append("`*` = fewer than 10 instances recorded yet (run in progress).")
    lines.append("")

    # Per-column compute disclosure (round-4 VERDICT #1/#2: one line per
    # column; multi-attempt columns additionally itemized in the
    # convergence-pass section below). Budgets are the scripts' defaults —
    # quality_table.py / eco_distribution.py are the source of truth.
    lines.append("## Per-column compute budgets")
    lines.append("")
    lines.extend([
        "- RandomWalk/Greedy/SDP-GW/SA/GA+tabu: one run per instance at the"
        " `quality_table.py` classical budgets (SA 256 chains x 12N steps;"
        " GA 40-64 generations).",
        "- S2V-DQN: per-cell training, 6144/3072 loop steps x 32 envs,"
        " greedy eval over 32 random inits.",
        "- ECO-DQN: ONE network per distribution trained at N=200"
        " (`eco_distribution.py`: 32768 loop steps x 64 envs = 2.1M"
        " transitions, 48-graph rotating pool, bf16 MPNN,"
        " validation-selected checkpoint), inferred across all sizes with"
        " 50/32 greedy rollouts — the reference train-once/infer-across"
        " protocol (`ECO_S2V/config.py:33-83`).",
        "- PI-GNN / Jumanji / ISCO: per-cell runs at the `quality_table.py`"
        " budgets (jumanji 100/80 PPO iters; isco 256/96 chains x"
        " max(600, 2N) segmented annealed steps).",
        "- MCPG: 256 chains x 32 repeats, 6 epochs (plus symmetric"
        " convergence passes below).",
        "- L2A: distribution-trained policy (60 iters) + packed-sweep"
        " guided search, 128/256 rounds x 512 sims x 16 repeats (plus"
        " symmetric convergence passes below).",
        "- bound: HiGHS 60s MILP dual min'd with the certified"
        " Poljak-Rendl spectral bound (4k-12k subgradient iters).",
    ])
    lines.append("")

    # Protocol disclosure (round-3 advisor finding: retry passes must be
    # symmetric and disclosed). boost_log.csv records every convergence-
    # pass attempt appended on top of the single-run campaign rows.
    boost_path = "results_quality/boost_log.csv"
    if os.path.exists(boost_path):
        per_cell = collections.defaultdict(lambda: collections.defaultdict(
            lambda: [0, 0.0]))
        with open(boost_path) as f:
            for r in csv.reader(f):
                if r and r[0] != "dist":
                    c = per_cell[(r[0], int(r[1]))][r[2]]
                    c[0] += 1
                    c[1] += float(r[5])
        lines.append("## Convergence-pass protocol")
        lines.append("")
        lines.append(
            "Cells below received extra best-of-k attempts beyond the single"
        )
        lines.append(
            "campaign run; attempts and budgets are applied symmetrically to"
        )
        lines.append(
            "the methods being compared (`scripts/standing_pass.py`):"
        )
        lines.append("")
        for (dist, n) in sorted(per_cell):
            parts = ", ".join(
                f"{alg}: +{cnt} attempts ({sec:.0f}s total)"
                for alg, (cnt, sec) in sorted(per_cell[(dist, n)].items())
            )
            lines.append(f"- {dist}_{n}: {parts}")
        lines.append("")

    # RL-vs-classical dominance check (VERDICT round-1 done criterion)
    viol = []
    for (dist, n), cell in sorted(rows.items()):
        if "ga" in cell and ("mcpg" in cell or "l2a" in cell):
            rl = max(avg(cell[a]) for a in ("mcpg", "l2a") if a in cell)
            if rl < avg(cell["ga"]) - 1e-9:
                viol.append(f"{dist}_{n}: best RL {rl:.1f} < GA {avg(cell['ga']):.1f}")
    lines.append("## MCPG/L2A >= GA check")
    lines.append("")
    if viol:
        lines.extend(f"- VIOLATION {v}" for v in viol)
    else:
        lines.append("- holds at every (distribution, N) recorded so far")
    lines.append("")

    # Flagship standing (round-3 done criterion, reference README.md:356-371:
    # dREINFORCE >= every baseline; >= MCPG on the BA rows)
    viol2 = []
    for (dist, n), cell in sorted(rows.items()):
        if "l2a" not in cell:
            continue
        l2a = avg(cell["l2a"])
        if "ga" in cell and l2a < avg(cell["ga"]) - 1e-9:
            viol2.append(f"{dist}_{n}: L2A {l2a:.1f} < GA {avg(cell['ga']):.1f}")
        if dist == "BA" and "mcpg" in cell and l2a < avg(cell["mcpg"]) - 1e-9:
            viol2.append(
                f"{dist}_{n}: L2A {l2a:.1f} < MCPG {avg(cell['mcpg']):.1f}"
            )
    lines.append("## L2A flagship check (>= GA everywhere, >= MCPG on BA)")
    lines.append("")
    if viol2:
        lines.extend(f"- VIOLATION {v}" for v in viol2)
    else:
        lines.append("- holds at every (distribution, N) recorded so far")
    lines.append("")

    # Learned-method sanity (round-4 VERDICT #1 done criteria): ECO >=
    # greedy everywhere, ECO >= S2V at N <= 500 (reference ordering,
    # Benchmark.rst:17-30), and NO learned column below random walk.
    viol3 = []
    learned = ("s2v", "eco", "pignn", "jumanji", "isco", "mcpg", "l2a")
    for (dist, n), cell in sorted(rows.items()):
        if "eco" in cell and "greedy" in cell and avg(cell["eco"]) < avg(
            cell["greedy"]
        ) - 1e-9:
            viol3.append(
                f"{dist}_{n}: ECO {avg(cell['eco']):.1f} < greedy "
                f"{avg(cell['greedy']):.1f}"
            )
        if (
            n <= 500
            and "eco" in cell
            and "s2v" in cell
            and avg(cell["eco"]) < avg(cell["s2v"]) - 1e-9
        ):
            viol3.append(
                f"{dist}_{n}: ECO {avg(cell['eco']):.1f} < S2V "
                f"{avg(cell['s2v']):.1f}"
            )
        for a in learned:
            if a in cell and "rw" in cell and avg(cell[a]) < avg(
                cell["rw"]
            ) - 1e-9:
                viol3.append(
                    f"{dist}_{n}: {LABEL[a]} {avg(cell[a]):.1f} < RandomWalk "
                    f"{avg(cell['rw']):.1f}"
                )
    lines.append(
        "## Learned-method checks (ECO >= greedy; ECO >= S2V at N<=500; "
        "no learned column < RandomWalk)"
    )
    lines.append("")
    if viol3:
        lines.extend(f"- VIOLATION {v}" for v in viol3)
    else:
        lines.append("- holds at every (distribution, N) recorded so far")
    lines.append("")

    with open(OUT, "w") as f:
        f.write("\n".join(lines))
    print("\n".join(lines))


if __name__ == "__main__":
    main()
