"""TNCO: tensor-network contraction-ordering environment (Pattern II).

Reference counterpart: `rlsolver/methods/L2A/TNCO_simulator.py:649-910`
(`EnvTNCO`) and the standalone copy
`methods_problem_specific/tensor_train/TNCO_env.py:741-`. Capabilities:

  * a tensor network is given as an adjacency list `nodes_list` (per tensor,
    the list of connected tensors); every bond dimension is 2 (qubit gates);
  * a solution is an order over the contractible ("run") edges; dangling/open
    edges (`ban_edges` of them) are numbered last and never contracted
    (`TNCO_simulator.py:609-624` sorts ban edges to large indices);
  * the objective (to MINIMIZE) is log10 of the total scalar-multiplication
    count of contracting the network in that order
    (`get_log10_multiple_times` `TNCO_simulator.py:690-711`);
  * solutions are exposed in three codecs: integer edge permutations,
    continuous per-edge priorities (local search operates here,
    `TNCO_local_search.py:46-73`), and fixed-width binary rank encodings of
    `num_bases = ceil(log2 run_edges)` bits per edge (policy methods operate
    here, `TNCO_simulator.py:684-688`).

Accelerator-first redesign:
  * the contraction simulation is a `lax.scan` over the `run_edges` steps
    with a batched cluster state (`dims [B, N, N] f32`, `bool [B, N, N]`),
    replacing the reference's per-step python loop over envs
    (`update_pow_vectorized` `TNCO_simulator.py:869-883` still loops to do
    the cluster broadcast; here it is one masked `where`);
  * per-step pow-counts are small integers/half-integers -> exact in f32;
    the final log10-sum-exp2 uses the reference's max-shift trick
    (`get_multiple_times_vectorized` `TNCO_simulator.py:797-804`) in f32 on
    device, with an `accurate` host path in float64 for validation
    (the device path stays in f32 — SURVEY.md section 7.3).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ----------------------------------------------------------------- topologies
def tensor_train_nodes(length: int = 4) -> Tuple[List[List[int]], int]:
    """Tensor-train (MPS) with one dangling leg per site.

    Matches `get_nodes_list_and_band_edges_of_tensor_train`
    (`TNCO_simulator.py:541-553`): sites 0..L-1 in a chain, each connected to
    a virtual leaf node L+i representing its open index; `ban_edges = L`.
    """
    nodes: List[List[int]] = [[] for _ in range(length)]
    for i in range(length):
        if i > 0:
            nodes[i].append(i - 1)
        if i < length - 1:
            nodes[i].append(i + 1)
        nodes[i].append(i + length)
        nodes.append([i])
    return nodes, length


def tensor_ring_nodes(length: int = 4) -> Tuple[List[List[int]], int]:
    """Tensor ring (`TNCO_simulator.py:528-539`)."""
    nodes: List[List[int]] = [[] for _ in range(length)]
    for i in range(length):
        nodes[i].append((i - 1) % length)
        nodes[i].append((i + 1) % length)
        nodes[i].append(i + length)
        nodes.append([i])
    return nodes, length


def tensor_tree_nodes(depth: int = 3) -> Tuple[List[List[int]], int]:
    """Balanced binary tensor tree (`TNCO_simulator.py:556-581`)."""
    depth -= 1
    num_nodes = 2 ** (depth + 1) - 1
    ban_edges = 2**depth
    tree: List[List[int]] = [[] for _ in range(num_nodes)]

    def add_edges(d: int, node: int = 0, parent: int = -1) -> None:
        if parent >= 0:
            tree[node].append(parent)
        if d == 0:
            return
        left, right = node * 2 + 1, node * 2 + 2
        tree[node].append(left)
        tree[node].append(right)
        add_edges(d - 1, left, node)
        add_edges(d - 1, right, node)

    add_edges(depth)
    return tree, ban_edges


def random_circuit_nodes(
    num_qubits: int, num_layers: int, seed: int = 0
) -> Tuple[List[List[int]], int]:
    """Sycamore-style random-circuit tensor network (closed amplitude).

    The reference ships hand-generated sycamore node lists
    (`TNCO_simulator.py:7-` NodesSycamoreN12M14 etc., ~4k lines each); this
    builds networks of the same *shape* programmatically: a brickwork of
    2-qubit gates over `num_qubits` wires, each gate a rank-4 tensor
    connected to the previous tensor on each of its two wires. Closed
    network (no dangling edges): `ban_edges = 0`.
    """
    rng = np.random.RandomState(seed)
    nodes: List[List[int]] = []
    # one initial rank-1 tensor per qubit wire
    frontier = []
    for q in range(num_qubits):
        nodes.append([])
        frontier.append(q)
    for layer in range(num_layers):
        offset = layer % 2
        pairs = [(q, q + 1) for q in range(offset, num_qubits - 1, 2)]
        if not pairs:
            continue
        rng.shuffle(pairs)
        for a, b in pairs:
            gate = len(nodes)
            nodes.append([frontier[a], frontier[b]])
            nodes[frontier[a]].append(gate)
            nodes[frontier[b]].append(gate)
            frontier[a] = gate
            frontier[b] = gate
    # close the network with one final rank-1 tensor per wire
    for q in range(num_qubits):
        cap = len(nodes)
        nodes.append([frontier[q]])
        nodes[frontier[q]].append(cap)
    return nodes, 0


# ------------------------------------------------------------------ container
@dataclasses.dataclass(frozen=True)
class TensorNetwork:
    """Host-side tensor network: per-edge endpoints, ban edges last.

    `edge_nodes[e] = (n0, n1)`; edges with id >= run_edges are dangling and
    never contracted. Edge numbering reproduces the reference's contract
    (`get_edges_ary` `TNCO_simulator.py:594-624`): enumerate node pairs from
    the *last* node backwards, then flip ids (`max - id`) so dangling edges
    (which touch the highest-numbered leaf nodes) land on the largest ids.
    """

    num_nodes: int
    edge_nodes: np.ndarray  # [E, 2] int32
    ban_edges: int
    name: str = ""

    @property
    def num_edges(self) -> int:
        return int(self.edge_nodes.shape[0])

    @property
    def run_edges(self) -> int:
        return self.num_edges - self.ban_edges

    @property
    def num_bases(self) -> int:
        """Bits per edge in the binary rank codec (`TNCO_simulator.py:684`)."""
        return max(1, math.ceil(math.log2(self.num_edges)))

    @property
    def num_bits(self) -> int:
        return self.run_edges * self.num_bases

    @staticmethod
    def from_nodes_list(
        nodes_list: Sequence[Sequence[int]], ban_edges: int, name: str = ""
    ) -> "TensorNetwork":
        num_nodes = len(nodes_list)
        # Assign edge ids walking nodes from last to first (reference order),
        # then flip so ban edges (touching trailing leaf nodes) come last.
        seen = {}
        raw_id = 0
        for i in range(num_nodes - 1, -1, -1):
            for j in nodes_list[i]:
                a, b = (i, j) if i < j else (j, i)
                if (a, b) not in seen:
                    seen[(a, b)] = raw_id
                    raw_id += 1
        num_edges = raw_id
        edge_nodes = np.zeros((num_edges, 2), np.int32)
        for (a, b), rid in seen.items():
            eid = num_edges - 1 - rid
            edge_nodes[eid] = (a, b)
        return TensorNetwork(num_nodes, edge_nodes, ban_edges, name)

    def node2s_to_edge_sort(self, node2s: Sequence[Sequence[int]]) -> np.ndarray:
        """Node-pair contraction sequence -> edge contraction order
        (`convert_node2s_to_edge_sort` `TNCO_env.py:914-958`): for each
        (i, j) pair contract the smallest shared edge id, then all remaining
        shared edges (parallel bonds), merging the edge sets."""
        edges_tmp = [set() for _ in range(self.num_nodes)]
        for e, (a, b) in enumerate(self.edge_nodes):
            edges_tmp[a].add(int(e))
            edges_tmp[b].add(int(e))
        edge_sort: List[int] = []
        edge_rest = set(range(self.run_edges))
        for i0, i1 in node2s:
            inter = edges_tmp[i0] & edges_tmp[i1]
            e = sorted(inter)[0]
            edge_sort.append(e)
            ejs = sorted(edge_rest & (inter - {e}))
            edge_sort.extend(ejs)
            edge_rest.discard(e)
            edge_rest -= set(ejs)
            union = edges_tmp[i0] | edges_tmp[i1]
            edges_tmp[i0] = union
            edges_tmp[i1] = union
        if len(edge_sort) != self.run_edges:
            raise ValueError(
                f"node2s covers {len(edge_sort)} of {self.run_edges} run edges"
            )
        return np.asarray(edge_sort, np.int32)


_REFERENCE_TNCO_ENV = (
    "/root/reference/rlsolver/methods_problem_specific/tensor_train/TNCO_env.py"
)


def load_reference_tnco_constant(name: str, path: str = _REFERENCE_TNCO_ENV):
    """Load a list constant (e.g. 'NodesSycamoreN53M12',
    'Node2sSycamoreN53N20Test1') from the mounted reference source by AST
    literal extraction — the actual shipped sycamore circuits
    (`TNCO_env.py:30-525`), imported as data without executing torch code.
    """
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name) and target.id == name:
                    return ast.literal_eval(node.value)
    raise KeyError(f"{name} not found in {path}")


def sycamore_network(m: int = 12) -> TensorNetwork:
    """The shipped circuit_n53_m<m> sycamore tensor network (ban_edges=0,
    as in the reference unit tests `TNCO_env.py:1005,1040`)."""
    nodes_list = load_reference_tnco_constant(f"NodesSycamoreN53M{m}")
    return TensorNetwork.from_nodes_list(nodes_list, 0, name=f"sycamore_n53_m{m}")


# ------------------------------------------------------------------------ env
class TncoEnv:
    """Static per-network data + pure jittable methods (minimization)."""

    def __init__(self, network: TensorNetwork):
        self.network = network
        self.num_nodes = network.num_nodes
        self.num_edges = network.num_edges
        self.ban_edges = network.ban_edges
        self.run_edges = network.run_edges
        self.num_bases = network.num_bases
        self.num_bits = network.num_bits
        self.if_maximize = False

        self.edge_n0 = jnp.asarray(network.edge_nodes[:, 0])
        self.edge_n1 = jnp.asarray(network.edge_nodes[:, 1])

        # initial cluster state: dims[i][j] = log2 bond contribution of
        # original node j inside cluster i; every incident edge contributes
        # one factor of 2 (`get_node_dims_arys` `TNCO_simulator.py:627-635`)
        dims0 = np.zeros((network.num_nodes, network.num_nodes), np.float32)
        for n0, n1 in network.edge_nodes:
            dims0[n0, n1] += 1.0
            dims0[n1, n0] += 1.0
        self.dims0 = jnp.asarray(dims0)
        self.bool0 = jnp.asarray(np.eye(network.num_nodes, dtype=bool))
        self._base_numbers = jnp.asarray(
            2.0 ** np.arange(self.num_bases - 1, -1, -1), jnp.float32
        )

    # ----------------------------------------------------------------- codecs
    def bits_to_edge_sorts(self, xs: jax.Array) -> jax.Array:
        """bits [B, num_bits] -> contraction order [B, run_edges] int32.

        Each edge's `num_bases` bits form its big-endian rank; the order is
        the stable argsort of ranks (`convert_binary_xs_to_edge_sorts`
        `TNCO_simulator.py:864-872`; ours covers run edges only — the
        reference encodes banned edges too but never contracts them).
        """
        b = xs.shape[0]
        view = xs.reshape(b, self.run_edges, self.num_bases).astype(jnp.float32)
        ranks = (view * self._base_numbers).sum(axis=2)
        return jnp.argsort(ranks, axis=1).astype(jnp.int32)

    def edge_sorts_to_bits(self, edge_sorts: jax.Array) -> jax.Array:
        """Inverse codec: order [B, R] -> canonical bits [B, num_bits].

        Edge e's rank = its position in the order; rank bits big-endian
        (`convert_edge_sorts_to_binary_xs` `TNCO_simulator.py:874-887`).
        """
        b, r = edge_sorts.shape
        pos = jnp.broadcast_to(jnp.arange(r, dtype=jnp.int32), (b, r))
        ranks = jnp.zeros((b, r), jnp.int32).at[
            jnp.arange(b)[:, None], edge_sorts
        ].set(pos)
        shifts = jnp.arange(self.num_bases - 1, -1, -1, dtype=jnp.int32)
        bits = (ranks[:, :, None] >> shifts[None, None, :]) & 1
        return bits.reshape(b, self.num_bits).astype(bool)

    def priorities_to_edge_sorts(self, fs: jax.Array) -> jax.Array:
        """Continuous priorities [B, R] -> order (local-search codec)."""
        return jnp.argsort(fs, axis=1).astype(jnp.int32)

    # -------------------------------------------------------------- objective
    def contraction_pow_counts(self, edge_sorts: jax.Array) -> jax.Array:
        """Per-step log2 multiplication counts, f32 [B, R] (exact integers).

        Simulates contracting edges in the given order. Semantics match
        `update_pow_vectorized` (`TNCO_simulator.py:869-883`): contracting an
        edge merges its two endpoint clusters; the step cost exponent is the
        sum of both clusters' external log2 dims plus half the internal ones;
        edges inside an already-merged cluster cost nothing.
        """
        num_envs = edge_sorts.shape[0]
        env_ids = jnp.arange(num_envs)

        def step(carry, edge_is):
            dims, bools = carry  # [B, N, N] f32 / bool
            n0 = self.edge_n0[edge_is]  # [B]
            n1 = self.edge_n1[edge_is]
            dims0 = dims[env_ids, n0]  # [B, N]
            dims1 = dims[env_ids, n1]
            bool0 = bools[env_ids, n0]
            bool1 = bools[env_ids, n1]
            if_diff = ~bool0[env_ids, n1]  # [B]
            diff_f = if_diff.astype(jnp.float32)

            ct_dims = dims0 + dims1 * diff_f[:, None]  # [B, N]
            ct_bool = bool0 | bool1
            pow_count = (
                ct_dims.sum(axis=1) - (ct_dims * ct_bool).sum(axis=1) * 0.5
            ) * diff_f

            # zero internal bonds, then broadcast the merged cluster row to
            # every member node (one masked where per step; the reference
            # loops over envs here)
            new_row = jnp.where(ct_bool, 0.0, ct_dims)  # [B, N]
            mask = ct_bool[:, :, None] & if_diff[:, None, None]  # [B, N, 1]
            dims = jnp.where(mask, new_row[:, None, :], dims)
            bools = jnp.where(mask, ct_bool[:, None, :], bools)
            return (dims, bools), pow_count

        dims = jnp.broadcast_to(self.dims0, (num_envs,) + self.dims0.shape)
        bools = jnp.broadcast_to(self.bool0, (num_envs,) + self.bool0.shape)
        (_, _), pows = jax.lax.scan(step, (dims, bools), edge_sorts.T)
        return pows.T  # [B, R]

    def log10_multiple_times(self, edge_sorts: jax.Array) -> jax.Array:
        """log10 of total multiplication count, f32 [B] (max-shift stable,
        `get_multiple_times_vectorized` `TNCO_simulator.py:797-804`)."""
        pows = self.contraction_pow_counts(edge_sorts)
        shift = jnp.max(pows, axis=1)
        total = jnp.sum(jnp.exp2(pows - shift[:, None]), axis=1)
        return jnp.log10(total) + shift * (1.0 / np.log2(10.0))

    def obj(self, xs: jax.Array) -> jax.Array:
        """Objective from the binary codec (`calculate_obj_values`
        `TNCO_simulator.py:860-863`). Lower is better."""
        return self.log10_multiple_times(self.bits_to_edge_sorts(xs))

    def obj_priorities(self, fs: jax.Array) -> jax.Array:
        return self.log10_multiple_times(self.priorities_to_edge_sorts(fs))

    def log10_multiple_times_accurate(self, edge_sorts) -> np.ndarray:
        """Host float64 twin (`get_multiple_times_accurately`
        `TNCO_simulator.py:785-795`) for precision validation."""
        pows = np.asarray(self.contraction_pow_counts(jnp.asarray(edge_sorts)))
        out = np.zeros(pows.shape[0], np.float64)
        for i, row in enumerate(pows.astype(np.float64)):
            shift = row.max()
            out[i] = math.log10(np.exp2(row - shift).sum()) + shift * math.log10(2.0)
        return out

    # ------------------------------------------------------------------ state
    def random_edge_sorts(self, key: jax.Array, num_sims: int) -> jax.Array:
        perm = jax.vmap(lambda k: jax.random.permutation(k, self.run_edges))(
            jax.random.split(key, num_sims)
        )
        return perm.astype(jnp.int32)

    def random_xs(self, key: jax.Array, num_sims: int) -> jax.Array:
        """Random orderings in the binary codec (`generate_xs_randomly`
        `TNCO_simulator.py:853-857`)."""
        return self.edge_sorts_to_bits(self.random_edge_sorts(key, num_sims))

    # ----------------------------------------------------------- local search
    def local_search(
        self,
        key: jax.Array,
        fs: jax.Array,
        vs: Optional[jax.Array] = None,
        num_iters: int = 8,
        num_spin: int = 8,
        noise_std: float = 0.3,
    ) -> Tuple[jax.Array, jax.Array]:
        """Priority-space random search (`SolverLocalSearch.random_search`
        `TNCO_local_search.py:46-73`): perturb `num_spin` random edge
        priorities with Gaussian noise, re-evaluate, accept if better.
        Returns (fs, vs) with vs = log10 cost (minimized).
        """
        if vs is None:
            vs = self.obj_priorities(fs)
        num_sims = fs.shape[0]

        def ls_iter(carry, k):
            good_fs, good_vs = carry
            k_idx, k_noise = jax.random.split(k)
            idx = jax.random.randint(k_idx, (num_sims, num_spin), 0, self.run_edges)
            noise = jax.random.normal(k_noise, (num_sims, num_spin)) * noise_std
            fs_try = good_fs.at[jnp.arange(num_sims)[:, None], idx].add(noise)
            vs_try = self.obj_priorities(fs_try)
            better = vs_try < good_vs
            good_fs = jnp.where(better[:, None], fs_try, good_fs)
            good_vs = jnp.where(better, vs_try, good_vs)
            return (good_fs, good_vs), None

        (fs, vs), _ = jax.lax.scan(ls_iter, (fs, vs), jax.random.split(key, num_iters))
        return fs, vs

    def ranks_to_priorities(self, edge_sorts: jax.Array) -> jax.Array:
        """Normalized rank priorities (`matching_sorts(...)/num_edges`,
        `TNCO_local_search.py:56-57`)."""
        b, r = edge_sorts.shape
        pos = jnp.broadcast_to(jnp.arange(r, dtype=jnp.float32), (b, r))
        ranks = jnp.zeros((b, r), jnp.float32).at[
            jnp.arange(b)[:, None], edge_sorts
        ].set(pos)
        return ranks / r
