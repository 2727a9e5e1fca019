"""ISCO / PISCO: gradient-informed path-auxiliary MCMC samplers.

Capability-parity rebuild of the reference ISCO family
(`rlsolver/envs/env_ISCO.py:10-174,365-448`, driver
`rlsolver/methods/ISCO/main_ISCO_maxcut.py:18-45`):

  * proposal: sample `path_length` bit flips *without replacement* from a
    softmax over per-bit energy-change scores (Gumbel top-k with per-chain
    k), flip them jointly;
  * accept: path-auxiliary detailed balance — forward/backward ordered
    no-replacement log-likelihoods (`noreplacement_sampling_renormalize`,
    `rlsolver/methods/util.py:507-555`) enter the MH ratio;
  * anneal: linear temperature decay over the chain; adaptive Poisson path
    length steered to a 0.574 acceptance rate (`main_ISCO_maxcut.py:26-31`);
  * PISCO: the dense matmul formulation of the energy
    (`env_ISCO.py:436-444`) — here the default, since flip scores come from
    the dense gains matmul.

Accelerator-first deviation (documented): the reference estimates per-bit energy
changes by autograd through a relaxed energy (`get_local_dist`,
`env_ISCO.py:51-63`), a first-order approximation. For quadratic
pseudo-boolean energies (maxcut, MIS) the exact flip deltas are one matmul,
so this implementation uses exact deltas — same structure, strictly better
proposals. The whole annealing chain is one `lax.scan` under jit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rlsolver_tpu.core.graph import Graph
from rlsolver_tpu.core.result import write_graph_result
from rlsolver_tpu.ops import cut as cut_ops
from rlsolver_tpu.ops import objectives as dobj


# ---------------------------------------------------- no-replacement log-liks
def log1mexp(x: jax.Array) -> jax.Array:
    """log(1 - exp(-|x|)) (reference `util.py:502-505`)."""
    x = -jnp.abs(x)
    return jnp.where(x > -0.693, jnp.log(-jnp.expm1(x)), jnp.log1p(-jnp.exp(x)))


def noreplacement_renormalize(ll: jax.Array) -> jax.Array:
    """Sequential renormalization for ordered no-replacement sampling: entry
    t becomes log P(item_t | items_0..t-1 removed) (reference
    `util.py:507-512`)."""
    base = jnp.max(ll, axis=-1, keepdims=True)
    prob = jnp.exp(ll - base)
    ll_delta = jnp.log(jnp.cumsum(prob, axis=-1) - prob) + base
    return jnp.clip(ll - log1mexp(ll_delta), max=0.0)


class ProposalInfo(NamedTuple):
    mask: jax.Array  # [B, N] 0/1 selected flips
    perturbed_ll: jax.Array  # [B, N] gumbel-perturbed logits
    ll_forward: jax.Array  # [B] forward ordered selection log-lik


def sample_flip_set(
    key: jax.Array, log_prob: jax.Array, path_length: jax.Array
) -> ProposalInfo:
    """Gumbel top-k no-replacement flip-set sampling with per-chain k
    (reference `multinomial`, `util.py:514-555`)."""
    b, n = log_prob.shape
    g = log_prob - jnp.log(-jnp.log(jax.random.uniform(key, log_prob.shape)))
    sorted_g = jnp.sort(g, axis=-1)  # ascending
    thresh = jnp.take_along_axis(sorted_g, (n - path_length)[:, None], axis=1)
    mask = (g >= thresh).astype(jnp.float32)
    # ordered forward log-lik: sort by descending gumbel, renormalize, keep
    # the selected prefix
    order = jnp.argsort(-g, axis=-1)
    sorted_ll = jnp.take_along_axis(log_prob, order, axis=-1)
    idx_ll = noreplacement_renormalize(sorted_ll)
    sel_sorted = jnp.take_along_axis(mask, order, axis=-1)
    ll_forward = jnp.sum(idx_ll * sel_sorted, axis=-1)
    return ProposalInfo(mask=mask, perturbed_ll=g, ll_forward=ll_forward)


def reverse_ll(
    log_prob_y: jax.Array, info: ProposalInfo
) -> jax.Array:
    """Log-lik of re-selecting the same flip set from y, in the reverse
    order of the forward selection (reference `ll_y2x`,
    `env_ISCO.py:65-78`)."""
    backwd_idx = jnp.argsort(info.perturbed_ll, axis=-1)  # ascending
    masked_ll = jnp.where(info.mask.astype(bool), log_prob_y, -1e18)
    backwd_ll = jnp.take_along_axis(masked_ll, backwd_idx, axis=-1)
    backwd_mask = jnp.take_along_axis(info.mask, backwd_idx, axis=-1)
    ll = noreplacement_renormalize(backwd_ll)
    return jnp.sum(jnp.where(backwd_mask.astype(bool), ll, 0.0), axis=-1)


# single lax.scan segments that are too long crashed the device worker of
# an earlier backend ("kernel fault"). Bisection on 10-graph x 256-chain
# cells:
#   N=500 x 1000 steps  CRASH      N=500 x 800  PASS
#   N=700 x  700 steps  CRASH      N=600 x 600  PASS
# i.e. the boundary tracks N * segment_steps (~between 3.6e5 and 4.9e5),
# not segment length alone. Budget 3.2e5 keeps a safety margin.
MAX_SCAN_SEGMENT = 800
SCAN_WORK_BUDGET = 320_000


def _segment_cap(n: int) -> int:
    return max(32, min(MAX_SCAN_SEGMENT, SCAN_WORK_BUDGET // max(1, n)))


# ------------------------------------------------------------------- sampler
@dataclasses.dataclass
class ISCOConfig:
    batch_size: int = 32
    chain_length: int = 200
    init_temperature: float = 1.0
    final_temperature: float = 1e-4
    target_accept: float = 0.574  # reference main_ISCO_maxcut.py:31
    mu_lr: float = 0.01
    mu_init: float = 10.0
    seed: int = 0


class ISCOSampler:
    """Path-auxiliary sampler over a quadratic pseudo-boolean energy.

    `energy_fn(x) -> [B]` (higher = better, MAXIMIZED) and
    `flip_delta_fn(x) -> [B, N]` (exact energy change of each single flip).

    Both callables may instead take a second `data` pytree argument; pass
    the pytree through `step(..., data=...)` / `run(key, data)` and the
    instance data rides as a jit ARGUMENT instead of a baked-in closure
    constant, so same-shape instances share one compiled program
    (per-instance recompiles would dominate the cost of a campaign cell).
    """

    def __init__(
        self,
        num_nodes: int,
        energy_fn: Callable[..., jax.Array],
        flip_delta_fn: Callable[..., jax.Array],
        cfg: ISCOConfig = ISCOConfig(),
    ):
        self.num_nodes = num_nodes
        self.energy_fn = energy_fn
        self.flip_delta_fn = flip_delta_fn
        self.cfg = cfg

    def _energy(self, x, data):
        return self.energy_fn(x) if data is None else self.energy_fn(x, data)

    def _flip_delta(self, x, data):
        return (
            self.flip_delta_fn(x)
            if data is None
            else self.flip_delta_fn(x, data)
        )

    def step(self, key, x, path_length, temperature, data=None):
        """One path-auxiliary MH step. x: f32 {0,1} [B, N]."""
        k_prop, k_acc = jax.random.split(key)
        e_x_raw = self._energy(x, data)
        scores_x = self._flip_delta(x, data) / (2.0 * temperature)
        log_prob_x = jax.nn.log_softmax(scores_x, axis=-1)
        info = sample_flip_set(k_prop, log_prob_x, path_length)
        y = x * (1 - info.mask) + info.mask * (1 - x)

        e_y_raw = self._energy(y, data)
        scores_y = self._flip_delta(y, data) / (2.0 * temperature)
        log_prob_y = jax.nn.log_softmax(scores_y, axis=-1)
        ll_y2x = reverse_ll(log_prob_y, info)

        log_acc = jnp.clip(
            (e_y_raw - e_x_raw) / temperature + ll_y2x - info.ll_forward, max=0.0
        )
        u = jax.random.uniform(k_acc, log_acc.shape)
        accept = jnp.log(u + 1e-24) < log_acc
        x_new = jnp.where(accept[:, None], y, x)
        return x_new, jnp.where(accept, e_y_raw, e_x_raw), jnp.exp(log_acc)

    def temperatures(self, total: int) -> jax.Array:
        cfg = self.cfg
        steps = jnp.arange(total)
        temps = cfg.init_temperature - steps / total * (
            cfg.init_temperature - cfg.final_temperature
        )
        return jnp.maximum(temps, 1e-6)

    def init_carry(self, key: jax.Array, data=None):
        cfg = self.cfg
        b, n = cfg.batch_size, self.num_nodes
        key, k_init = jax.random.split(key)
        x0 = jax.random.bernoulli(k_init, 0.5, (b, n)).astype(jnp.float32)
        mu0 = jnp.full((b,), cfg.mu_init)
        return (x0, mu0, x0, self._energy(x0, data), key)

    def run_segment(self, carry, temps: jax.Array, data=None):
        """Scan a temperature segment; chainable (the carry threads x, mu,
        incumbents and the RNG key). Single scans longer than ~800 steps
        crashed the device worker of an earlier backend outright (chain
        1000 at any N; chain 800 was fine), so long chains are
        python-looped over <= 800-step compiled segments."""
        cfg = self.cfg
        b, n = cfg.batch_size, self.num_nodes

        def body(carry, temp):
            x, mu, best_x, best_e, key = carry
            key, k_pl, k_step = jax.random.split(key, 3)
            path_length = jnp.clip(
                jax.random.poisson(k_pl, mu, (b,)), 1, n
            ).astype(jnp.int32)
            x, energy, acc = self.step(k_step, x, path_length, temp, data)
            mu = jnp.clip(mu + cfg.mu_lr * (acc - cfg.target_accept), 1.0, float(n))
            better = energy > best_e
            best_e = jnp.where(better, energy, best_e)
            best_x = jnp.where(better[:, None], x, best_x)
            return (x, mu, best_x, best_e, key), None

        return jax.lax.scan(body, carry, temps)[0]

    def run(self, key: jax.Array, data=None) -> Tuple[jax.Array, jax.Array]:
        """Full annealed chain as one jitted scan. Returns
        (best_x [B, N], best_energy [B]). For chains longer than ~800 use
        segmented execution (see `run_segment`)."""
        carry = self.init_carry(key, data)
        carry = self.run_segment(carry, self.temperatures(self.cfg.chain_length), data)
        return carry[2], carry[3]


# ------------------------------------------------------------ problem fronts
def solve_maxcut_isco(
    graph: Graph,
    cfg: ISCOConfig = ISCOConfig(),
    mode: str = "dense",
    instance_file: Optional[str] = None,
    time_budget: Optional[float] = None,
    record=None,
):
    """ISCO (mode='sparse') / PISCO (mode='dense', matmul) for maxcut.
    Returns (best bits, best cut).

    `time_budget` (seconds): keep launching fresh annealed chain batches
    through the SAME compiled program until the budget is exhausted (the
    fixed-time benchmark protocol, reference `README.md:335`); `record(i,
    best)` is called after each batch."""
    cg = cut_ops.CutGraph.build(graph, dtype=jnp.float32, with_dense=mode == "dense")

    def energy(x):
        return cut_ops.cut_value(x > 0.5, cg, mode)

    def flip_delta(x):
        return cut_ops.flip_gains(x > 0.5, cg, mode)

    sampler = ISCOSampler(graph.num_nodes, energy, flip_delta, cfg)
    start = time.time()
    # segment long chains (see MAX_SCAN_SEGMENT)
    nseg = -(-cfg.chain_length // _segment_cap(graph.num_nodes))
    seg_len = -(-cfg.chain_length // nseg)
    temps = sampler.temperatures(nseg * seg_len).reshape(nseg, seg_len)
    init_jit = jax.jit(sampler.init_carry)
    seg_jit = jax.jit(sampler.run_segment)

    def run_jit(key):
        carry = init_jit(key)
        for s in range(nseg):
            carry = seg_jit(carry, temps[s])
        return carry[2], carry[3]

    best_x, best_e = run_jit(jax.random.PRNGKey(cfg.seed))
    i = int(jnp.argmax(best_e))
    bits = np.asarray(best_x[i] > 0.5)
    val = float(best_e[i])
    if record is not None:
        record(0, val)
    restart = 0
    while time_budget is not None and time.time() - start < time_budget:
        restart += 1
        bx, be = run_jit(jax.random.PRNGKey(cfg.seed + restart))
        j = int(jnp.argmax(be))
        if float(be[j]) > val:
            val = float(be[j])
            bits = np.asarray(bx[j] > 0.5)
        if record is not None:
            record(restart, val)
    if instance_file is not None:
        write_graph_result(
            val, time.time() - start, graph.num_nodes, "isco", bits.astype(int), instance_file
        )
    return bits, val


def solve_maxcut_isco_cell(
    graphs: Sequence[Graph],
    cfg: ISCOConfig = ISCOConfig(),
    mode: str = "dense",
) -> Tuple[np.ndarray, np.ndarray]:
    """ISCO over a whole campaign cell (same-node-count instances) as ONE
    vmapped jitted program: the per-instance `CutGraph` rides as a jit
    argument with a stacked leading axis, so a 10-instance cell costs one
    compile and one launch instead of 10 of each (the per-instance
    variant `solve_maxcut_isco` bakes the graph into the jaxpr as a
    closure constant). Returns (best bits [G, N], best cut [G]).

    Reference protocol: `main_ISCO_maxcut.py:18-45` run per instance; the
    batching here is a device-side restructuring, not a semantic change —
    chains are independent across instances.
    """
    n = graphs[0].num_nodes
    if any(g.num_nodes != n for g in graphs):
        raise ValueError("cell instances must share num_nodes")
    cgs = [
        cut_ops.CutGraph.build(g, jnp.float32, with_dense=mode == "dense")
        for g in graphs
    ]
    if mode == "dense":
        # dense paths never read the per-edge arrays, and their [m] shapes
        # differ across ER instances (would force a retrace): stub them.
        stub = jnp.zeros(1, jnp.int32)
        cgs = [
            cg._replace(n0=stub, n1=stub, w=jnp.zeros(1, jnp.float32))
            for cg in cgs
        ]
    else:
        # pad edge arrays to the cell max with weight-0 (0, 0) self-loops:
        # XOR(x0, x0) = 0 and w = 0 keep every objective/gain exact.
        m_max = max(int(cg.n0.shape[0]) for cg in cgs)
        cgs = [
            cg._replace(
                n0=jnp.pad(cg.n0, (0, m_max - cg.n0.shape[0])),
                n1=jnp.pad(cg.n1, (0, m_max - cg.n1.shape[0])),
                w=jnp.pad(cg.w, (0, m_max - cg.w.shape[0])),
            )
            for cg in cgs
        ]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *cgs)
    axes = cut_ops.CutGraph(
        num_nodes=None, adj=0 if mode == "dense" else None,
        n0=0, n1=0, w=0, deg_w=0, total_w=0,
    )

    def energy(x, cg):
        return cut_ops.cut_value(x > 0.5, cg, mode)

    def flip_delta(x, cg):
        return cut_ops.flip_gains(x > 0.5, cg, mode)

    sampler = ISCOSampler(n, energy, flip_delta, cfg)

    # rebind num_nodes as a STATIC python int in each wrapper: jit traces
    # every pytree leaf, and segment_sum (sparse flip gains) needs a
    # concrete num_segments. Long chains are python-looped over <= 800-step
    # compiled segments (see MAX_SCAN_SEGMENT).
    def init_one(key, cg):
        return sampler.init_carry(key, cg._replace(num_nodes=n))

    def seg_one(carry, temps, cg):
        return sampler.run_segment(carry, temps, cg._replace(num_nodes=n))

    nseg = -(-cfg.chain_length // _segment_cap(n))
    seg_len = -(-cfg.chain_length // nseg)
    temps = sampler.temperatures(nseg * seg_len).reshape(nseg, seg_len)
    init_v = jax.jit(jax.vmap(init_one, in_axes=(0, axes)))
    seg_v = jax.jit(jax.vmap(seg_one, in_axes=(0, None, axes)))
    keys = jax.random.split(jax.random.PRNGKey(cfg.seed), len(graphs))
    carry = init_v(keys, stacked)
    for s in range(nseg):
        carry = seg_v(carry, temps[s], stacked)
    best_x, best_e = carry[2], carry[3]  # [G, B, N], [G, B]
    idx = jnp.argmax(best_e, axis=1)
    bits = jnp.take_along_axis(best_x, idx[:, None, None], axis=1)[:, 0] > 0.5
    vals = jnp.max(best_e, axis=1)
    return np.asarray(bits), np.asarray(vals)


def solve_mis_isco(
    graph: Graph, cfg: ISCOConfig = ISCOConfig(), penalty: float = 1.01
):
    """ISCO for maximum independent set: energy = |S| - penalty * violations
    (reference `ISCO_MIS.model`, `env_ISCO.py:162-170`). Returns
    (best feasible bits, size) with a final violation-repair pass."""
    e = dobj.EdgeArrays.build(graph)
    adj = jnp.asarray(graph.adjacency_dense(), jnp.float32)

    def energy(x):
        return dobj.obj_maximum_independent_set(x > 0.5, e, penalty=penalty)

    def flip_delta(x):
        xb = (x > 0.5).astype(jnp.float32)
        sel_nbrs = jnp.matmul(xb, adj, preferred_element_type=jnp.float32)
        direction = 1.0 - 2.0 * xb  # +1 when adding, -1 when removing
        return direction * (1.0 - penalty * sel_nbrs)

    sampler = ISCOSampler(graph.num_nodes, energy, flip_delta, cfg)
    best_x, best_e = jax.jit(sampler.run)(jax.random.PRNGKey(cfg.seed))
    i = int(jnp.argmax(best_e))
    bits = np.asarray(best_x[i] > 0.5).copy()
    # repair: drop one endpoint of any remaining violated edge
    n0, n1, _ = graph.edge_arrays()
    for a, b in zip(n0, n1):
        if bits[a] and bits[b]:
            bits[b] = False
    return bits, float(bits.sum())
