"""(Weighted) MaxSAT: instance container, batched evaluation, local sweep.

Reference counterpart: `rlsolver/methods/MCPG/dataloader.py:169-276`
(`maxsat_dataloader` — DIMACS .cnf and weighted .wcnf with hard clauses) and
`MCPG/sampling.py:253-286` (`mcpg_sampling_maxsat` — sequential
variable-order local search with scatter-max clause evaluation, noisy
accepts).

Accelerator-first redesign: clauses live in a padded [C, K] literal table (var index
+ sign), so clause satisfaction is one gather + max; the per-variable local
search is a `lax.scan` over variables whose body touches only the padded
set of clauses containing that variable — all chains in parallel.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class MaxSatInstance:
    """num_vars, clauses as (vars [C,K] int32, signs [C,K] int8 with 0 pad),
    per-clause weights [C] f32. `hard_weight` marks the wcnf hard-clause
    weight (None for plain cnf)."""

    num_vars: int
    clause_vars: np.ndarray
    clause_signs: np.ndarray
    weights: np.ndarray
    hard_weight: Optional[float] = None
    name: str = ""

    @property
    def num_clauses(self) -> int:
        return int(self.clause_vars.shape[0])

    @staticmethod
    def from_clauses(
        num_vars: int,
        clauses: Sequence[Sequence[int]],
        weights: Optional[Sequence[float]] = None,
        hard_weight: Optional[float] = None,
        name: str = "",
    ) -> "MaxSatInstance":
        """clauses use DIMACS convention: 1-indexed, negative = negated."""
        k = max(len(c) for c in clauses)
        cv = np.zeros((len(clauses), k), np.int32)
        cs = np.zeros((len(clauses), k), np.int8)
        for ci, clause in enumerate(clauses):
            for j, lit in enumerate(clause):
                if lit == 0:
                    raise ValueError("literal 0 inside a clause")
                cv[ci, j] = abs(lit) - 1
                cs[ci, j] = 1 if lit > 0 else -1
        w = (
            np.ones(len(clauses), np.float32)
            if weights is None
            else np.asarray(weights, np.float32)
        )
        return MaxSatInstance(num_vars, cv, cs, w, hard_weight, name)

    @staticmethod
    def from_cnf(path: str, name: str = "") -> "MaxSatInstance":
        """Parse DIMACS .cnf / weighted .wcnf (reference format contract
        `dataloader.py:169-276`: wcnf line = `<weight> <lits...> 0`)."""
        weighted = path.endswith(".wcnf")
        clauses: List[List[int]] = []
        weights: List[float] = []
        num_vars = 0
        hard_weight = None
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts or parts[0] == "c":
                    continue
                if parts[0] == "p":
                    num_vars = int(parts[2])
                    if weighted and len(parts) > 4:
                        hard_weight = float(parts[4])
                    continue
                if weighted:
                    weights.append(float(parts[0]))
                    lits = [int(x) for x in parts[1:] if x != "0"]
                else:
                    weights.append(1.0)
                    lits = [int(x) for x in parts if x != "0"]
                if lits:
                    clauses.append(lits)
        return MaxSatInstance.from_clauses(
            num_vars, clauses, weights, hard_weight, name or path
        )


class MaxSatEnv:
    """Static device arrays + pure jittable objective / local search."""

    def __init__(self, inst: MaxSatInstance):
        self.inst = inst
        self.num_vars = inst.num_vars
        self.num_clauses = inst.num_clauses
        self.cv = jnp.asarray(inst.clause_vars)
        self.cs = jnp.asarray(inst.clause_signs, jnp.float32)
        self.w = jnp.asarray(inst.weights)

        # var -> clauses padded table (for the sweep): for each var, the
        # clauses containing it, padded with clause index C (sentinel)
        occur: List[List[int]] = [[] for _ in range(inst.num_vars)]
        for ci in range(inst.num_clauses):
            for j in range(inst.clause_vars.shape[1]):
                if inst.clause_signs[ci, j] != 0:
                    occur[int(inst.clause_vars[ci, j])].append(ci)
        max_occ = max(1, max(len(o) for o in occur)) if occur else 1
        vc = np.full((inst.num_vars, max_occ), inst.num_clauses, np.int32)
        for v, occ in enumerate(occur):
            vc[v, : len(occ)] = occ
        self.var_clauses = jnp.asarray(vc)
        # degree-style sweep order: most-occurring variables first
        # (reference iterates `data.ndata[3]` order, a degree sort)
        self.sweep_order = jnp.asarray(
            np.argsort(-np.asarray([len(o) for o in occur], np.int64), kind="stable").astype(
                np.int32
            )
        )

    def clause_sat(self, spins: jax.Array) -> jax.Array:
        """Per-clause satisfaction, bool [B, C], from spins ±1 [B, N]."""
        lits = spins[:, self.cv] * self.cs[None]  # [B, C, K]
        return jnp.max(lits, axis=2) > 0

    def obj(self, bits: jax.Array) -> jax.Array:
        """Weighted satisfied-clause count, f32 [B] (maximize)."""
        spins = bits.astype(jnp.float32) * 2.0 - 1.0
        return (self.clause_sat(spins) * self.w[None]).sum(axis=1)

    def random_bits(self, key: jax.Array, num_chains: int) -> jax.Array:
        return jax.random.bernoulli(key, 0.5, (num_chains, self.num_vars))

    def sweep(
        self, key: jax.Array, bits: jax.Array, num_sweeps: int = 1, noise: float = 0.5
    ) -> jax.Array:
        """Sequential variable sweep (`mcpg_sampling_maxsat` inner loop):
        flip variable v if the weighted sat gain beats U(-noise, noise).
        All chains in parallel; clauses touched per step are the padded
        occurrence list of v only.
        """
        b = bits.shape[0]
        spins = bits.astype(jnp.float32) * 2.0 - 1.0
        # pad a sentinel clause (always false, weight 0)
        cv = jnp.concatenate([self.cv, jnp.zeros((1, self.cv.shape[1]), jnp.int32)])
        cs = jnp.concatenate([self.cs, jnp.zeros((1, self.cs.shape[1]))])
        w = jnp.concatenate([self.w, jnp.zeros((1,))])

        def local_sat(spins, clause_ids):
            """Weighted sat over the given clauses, [B, D]."""
            lits = spins[:, cv[clause_ids]] * cs[clause_ids][None]  # [B, D, K]
            return (jnp.max(lits, axis=2) > 0) * w[clause_ids][None]

        def step(spins, inp):
            v, k = inp
            cids = self.var_clauses[v]  # [D]
            sat_old = local_sat(spins, cids).sum(axis=1)  # [B]
            flipped = spins.at[:, v].mul(-1.0)
            sat_new = local_sat(flipped, cids).sum(axis=1)
            u = jax.random.uniform(k, (b,), minval=-noise, maxval=noise)
            accept = sat_new > sat_old + u
            spins = jnp.where(
                accept[:, None] & (jnp.arange(self.num_vars)[None] == v), -spins, spins
            )
            return spins, None

        order = jnp.tile(self.sweep_order, num_sweeps)
        keys = jax.random.split(key, order.shape[0])
        spins, _ = jax.lax.scan(step, spins, (order, keys))
        return spins > 0
