"""Agent-network topologies for the consensus-based method (paper §V-D, A4).

The port's own copy of ``repro.core.topology`` (numpy only): the same graph
families, seeds, neighbor lists and weight tables, so that a topology built
here is identical, array for array, to the JAX package's.

The paper requires G strongly connected and undirected (A4). We provide the
standard families used in its experiments (random k-regular-ish graphs with
mu2 = 1.4384 / 2.5188 analogues, adjacent-chain for "Merge" with mu2 = 0.3820)
plus ring / torus / star / fully-connected, the graph Laplacian (eq. 55), its
algebraic connectivity mu2, and the consensus mixing matrix P = I - eps * La.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    """Undirected agent graph with adjacency matrix ``adj`` (0/1, zero diag)."""

    name: str
    adj: np.ndarray  # (m, m) symmetric 0/1

    def __post_init__(self):
        a = np.asarray(self.adj)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError("adjacency must be square")
        if not np.array_equal(a, a.T):
            raise ValueError("A4 requires an undirected graph (symmetric adj)")
        if np.any(np.diag(a) != 0):
            raise ValueError("no self loops")

    @property
    def m(self) -> int:
        return self.adj.shape[0]

    @property
    def degrees(self) -> np.ndarray:
        return self.adj.sum(axis=1)

    @property
    def max_degree(self) -> int:
        """Delta := max_i |Omega_i| + 1 per the paper's step-size bound."""
        return int(self.degrees.max()) + 1

    @property
    def n_edges(self) -> int:
        return int(self.adj.sum()) // 2

    def neighbors(self, i: int) -> np.ndarray:
        return np.nonzero(self.adj[i])[0]

    def is_connected(self) -> bool:
        m = self.m
        seen = np.zeros(m, bool)
        stack = [0]
        seen[0] = True
        while stack:
            v = stack.pop()
            for u in np.nonzero(self.adj[v])[0]:
                if not seen[u]:
                    seen[u] = True
                    stack.append(int(u))
        return bool(seen.all())


def laplacian(topo: Topology) -> np.ndarray:
    """Graph Laplacian La per eq. (55): deg on diag, -1 for edges."""
    return np.diag(topo.degrees) - topo.adj


def mu2(topo: Topology) -> float:
    """Algebraic connectivity: second-smallest eigenvalue of La."""
    eig = np.linalg.eigvalsh(laplacian(topo).astype(np.float64))
    return float(np.sort(eig)[1])


def mixing_matrix(topo: Topology, eps: float) -> np.ndarray:
    """P = I - eps * La; doubly stochastic for undirected G, rows sum to 1.

    Validity: 0 < eps < 1/Delta (paper's condition). We check and raise.
    """
    if not (0.0 < eps < 1.0 / topo.max_degree):
        raise ValueError(
            f"step size eps={eps} must be in (0, 1/Delta) = (0, {1.0 / topo.max_degree:.4f})"
        )
    return np.eye(topo.m) - eps * laplacian(topo)


def spectral_gap_factor(topo: Topology, eps: float, rounds: int) -> float:
    """The T5 contraction factor (1 - eps*mu2(La))^{2E}."""
    return float((1.0 - eps * mu2(topo)) ** (2 * rounds))


def density(topo: Topology) -> float:
    """Edge density 2|E| / (m(m-1)) in [0, 1]; the sparse-path selector input."""
    m = topo.m
    if m < 2:
        return 0.0
    return 2.0 * topo.n_edges / (m * (m - 1))


# ----------------------------------------------------------------------------
# Sparse neighbor-list representation (the O(m*k) consensus layout)
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NeighborList:
    """Padded static neighbor-index layout for the sparse gossip step.

    ``idx[i]`` holds agent i's closed neighborhood (self included) sorted
    ascending, padded out to ``k_max`` with i's *own* index; ``valid`` is
    False exactly on the padding. The gossip kernels gather ``x[idx[i, k]]``
    and weight by an ``(m, k_max)`` edge-weight table whose padding entries
    are exactly 0.0, so padded slots gather the agent's own row and
    contribute exactly nothing (adding ``0.0 * row`` is a floating-point
    no-op). Keeping valid entries ascending makes the sequential fp32
    accumulation order match a full (k_max = m) list evaluated in index
    order — the basis of the dense/sparse bitwise-parity contract
    (DESIGN.md §14).
    """

    name: str
    idx: np.ndarray      # (m, k_max) int32, ascending valid prefix, pad = own row
    valid: np.ndarray    # (m, k_max) bool, False on padding
    degrees: np.ndarray  # (m,) int32 true neighbor counts (self excluded)

    def __post_init__(self):
        idx = np.asarray(self.idx)
        valid = np.asarray(self.valid)
        deg = np.asarray(self.degrees)
        if idx.ndim != 2 or valid.shape != idx.shape:
            raise ValueError("idx/valid must be matching (m, k_max) arrays")
        m = idx.shape[0]
        if deg.shape != (m,):
            raise ValueError(f"degrees must be ({m},), got {deg.shape}")
        rows = np.arange(m)[:, None]
        if not np.all(idx[~valid] == np.broadcast_to(rows, idx.shape)[~valid]):
            raise ValueError("padding entries must gather the agent's own row")
        if np.any(valid[:, 1:] & ~valid[:, :-1]):
            raise ValueError("valid entries must form a per-row prefix")
        d = np.diff(np.where(valid, idx, idx.shape[0] + idx[:, :1]), axis=1)
        if np.any((d <= 0) & valid[:, 1:]):
            raise ValueError("valid neighbor indices must be strictly ascending")
        if not np.all(valid.sum(axis=1) == deg + 1):
            raise ValueError("valid counts must equal degree + 1 (self included)")

    @property
    def m(self) -> int:
        return self.idx.shape[0]

    @property
    def k_max(self) -> int:
        return self.idx.shape[1]

    @property
    def max_degree(self) -> int:
        """Delta := max_i |Omega_i| + 1, as on :class:`Topology`."""
        return int(self.degrees.max()) + 1


def neighbor_list(topo: Topology, k_max: int | None = None) -> NeighborList:
    """Export ``topo``'s adjacency as a padded static :class:`NeighborList`.

    ``k_max`` defaults to the tightest fit (max closed-neighborhood size);
    passing a larger value pads every row further — useful to hold k_max
    static across a topology sweep.
    """
    m = topo.m
    deg = topo.degrees.astype(np.int32)
    need = int(deg.max()) + 1
    if k_max is None:
        k_max = need
    if k_max < need:
        raise ValueError(f"k_max={k_max} < max closed neighborhood {need}")
    idx = np.tile(np.arange(m, dtype=np.int32)[:, None], (1, k_max))
    valid = np.zeros((m, k_max), bool)
    for i in range(m):
        nbrs = np.sort(np.append(np.nonzero(topo.adj[i])[0], i)).astype(np.int32)
        idx[i, : nbrs.size] = nbrs
        valid[i, : nbrs.size] = True
    return NeighborList(f"nl[{topo.name}]", idx, valid, deg)


def knn_ring_neighbors(m: int, k: int) -> NeighborList:
    """Analytic k-NN ring neighbor list — never materialises (m, m) storage.

    The 10k-agent scale path: builds the padded ``(m, k+1)`` layout directly
    (every row is full, so there is no padding) in O(m*k) memory.
    """
    if k % 2 or k < 2 or k >= m:
        raise ValueError(f"knn ring needs even k with 2 <= k < m, got k={k}, m={m}")
    half = k // 2
    offsets = np.r_[np.arange(-half, 0), 0, np.arange(1, half + 1)]
    idx = np.sort((np.arange(m)[:, None] + offsets[None, :]) % m, axis=1)
    return NeighborList(
        f"nl[knn_ring({m},k={k})]",
        idx.astype(np.int32),
        np.ones((m, k + 1), bool),
        np.full(m, k, np.int32),
    )


def mu2_knn_ring(m: int, k: int) -> float:
    """Closed-form algebraic connectivity of the k-NN ring (circulant La).

    The Laplacian eigenvalues are ``k - 2 * sum_{s=1..k/2} cos(2*pi*j*s/m)``
    for j = 0..m-1; mu2 is the smallest over j >= 1. O(m*k) — no eigensolve,
    so it works at the 10k scale where ``mu2`` (dense eigvalsh) cannot.
    """
    if k % 2 or k < 2 or k >= m:
        raise ValueError(f"knn ring needs even k with 2 <= k < m, got k={k}, m={m}")
    j = np.arange(1, m, dtype=np.float64)
    s = np.arange(1, k // 2 + 1, dtype=np.float64)
    lam = k - 2.0 * np.cos(2.0 * np.pi * np.outer(j, s) / m).sum(axis=1)
    return float(lam.min())


def neighbor_weights(nl: NeighborList, eps) -> np.ndarray:
    """``(m, k_max)`` gossip weight table: ``(I - eps*La)`` gathered.

    Self slots get ``1 - eps*deg_i``, neighbor slots ``eps``, padding exactly
    ``0.0``. Each operation is one fp32 numpy operation, the same elementwise
    fp32 operations as the dense rebuild ``eye(m) - eps * La``, so the table
    matches it bit-for-bit entry-by-entry in fp32.
    """
    idx = np.asarray(nl.idx)
    valid = np.asarray(nl.valid)
    is_self = (idx == np.arange(nl.m, dtype=idx.dtype)[:, None]) & valid
    deg = np.asarray(nl.degrees, np.float32)[:, None]
    eps32 = np.float32(eps)
    w = np.where(is_self, np.float32(1.0) - eps32 * deg, eps32)
    return np.where(valid, w, np.float32(0.0)).astype(np.float32)


def neighbor_weights_from_matrix(nl: NeighborList, p: np.ndarray) -> np.ndarray:
    """Gather an ``(m, k_max)`` weight table out of a dense mixing matrix.

    Used by the strategy layer so the sparse path's weights are *the same
    float64 entries* as the dense ``mixing_matrix`` cast to fp32 — the
    bitwise dense/sparse parity contract needs identical weights, not just
    close ones. Padding is forced to exactly 0.0.
    """
    p = np.asarray(p)
    if p.shape != (nl.m, nl.m):
        raise ValueError(f"mixing must be ({nl.m}, {nl.m}), got {p.shape}")
    w = p[np.arange(nl.m)[:, None], nl.idx] * nl.valid
    return np.ascontiguousarray(w, dtype=np.float32)


# ----------------------------------------------------------------------------
# Graph families
# ----------------------------------------------------------------------------

def ring(m: int) -> Topology:
    if m < 3:
        raise ValueError("ring needs m >= 3")
    adj = np.zeros((m, m), int)
    for i in range(m):
        adj[i, (i + 1) % m] = adj[(i + 1) % m, i] = 1
    return Topology(f"ring({m})", adj)


def chain(m: int) -> Topology:
    """Adjacent-vehicle chain — the paper's 'Merge' topology (mu2=0.3820 at m=5)."""
    if m < 2:
        raise ValueError("chain needs m >= 2")
    adj = np.zeros((m, m), int)
    for i in range(m - 1):
        adj[i, i + 1] = adj[i + 1, i] = 1
    return Topology(f"chain({m})", adj)


def fully_connected(m: int) -> Topology:
    adj = np.ones((m, m), int) - np.eye(m, dtype=int)
    return Topology(f"full({m})", adj)


def star(m: int) -> Topology:
    adj = np.zeros((m, m), int)
    adj[0, 1:] = adj[1:, 0] = 1
    return Topology(f"star({m})", adj)


def torus2d(rows: int, cols: int) -> Topology:
    """2-D torus (beyond-paper topology)."""
    m = rows * cols
    adj = np.zeros((m, m), int)

    def idx(r, c):
        return (r % rows) * cols + (c % cols)

    for r in range(rows):
        for c in range(cols):
            i = idx(r, c)
            for j in (idx(r + 1, c), idx(r, c + 1)):
                if i != j:
                    adj[i, j] = adj[j, i] = 1
    return Topology(f"torus({rows}x{cols})", adj)


def knn_ring(m: int, k: int) -> Topology:
    """k-NN ring: each agent wired to its k/2 nearest on each side (k even).

    The canonical sparse family — connected for any even 2 <= k < m, constant
    degree k, and its circulant mu2 has the closed form ``mu2_knn_ring``.
    """
    if k % 2 or k < 2 or k >= m:
        raise ValueError(f"knn ring needs even k with 2 <= k < m, got k={k}, m={m}")
    adj = np.zeros((m, m), int)
    for s in range(1, k // 2 + 1):
        for i in range(m):
            j = (i + s) % m
            adj[i, j] = adj[j, i] = 1
    return Topology(f"knn_ring({m},k={k})", adj)


def _draw_connected(family: str, m: int, seed: int, draw, max_retries: int = 1000):
    """Shared bounded reseed-retry for the random families.

    ``draw(seed)`` must return a freshly drawn :class:`Topology`; disconnected
    draws bump the seed and retry (so the successful topology's name records
    the seed that actually produced it). A4 needs a connected graph — after
    ``max_retries`` failures we raise with enough context to fix the density.
    """
    first = seed
    for _attempt in range(max_retries):
        topo = draw(seed)
        if topo.is_connected():
            return topo
        seed += 1
    raise RuntimeError(
        f"{family}: no connected draw for m={m} in {max_retries} reseed "
        f"retries (seeds {first}..{seed - 1}). A4 requires a connected graph "
        f"— increase the edge density (k / p) or the retry budget."
    )


def random_regularish(m: int, k_lo: int, k_hi: int, seed: int = 0) -> Topology:
    """Random graph with each node wired to ~k in [k_lo, k_hi] others.

    Mirrors the paper's 'constructed by 3~4 (or 4~6) random connections from
    each learning agent to others' (Fig. 6). Re-draws until connected
    (bounded; see ``_draw_connected``).
    """

    def draw(s: int) -> Topology:
        rng = np.random.default_rng(s)
        adj = np.zeros((m, m), int)
        for i in range(m):
            k = int(rng.integers(k_lo, k_hi + 1))
            need = max(0, k - int(adj[i].sum()))
            cand = [j for j in range(m) if j != i and adj[i, j] == 0]
            rng.shuffle(cand)
            for j in cand[:need]:
                adj[i, j] = adj[j, i] = 1
        return Topology(f"rand{k_lo}-{k_hi}(m={m},seed={s})", adj)

    return _draw_connected(f"rand{k_lo}-{k_hi}", m, seed, draw)


def watts_strogatz(m: int, k: int, beta: float, seed: int = 0) -> Topology:
    """Small-world graph: k-NN ring with each edge rewired with prob beta.

    beta=0 is the k-NN ring (high clustering, small mu2); beta→1 approaches a
    random graph (mu2 grows at the same degree budget) — the interesting
    middle of the lambda_2 sweep axis. Re-draws until connected (large beta
    can disconnect a rewired node).
    """
    if not (0.0 <= beta <= 1.0):
        raise ValueError(f"rewiring probability beta={beta} must be in [0, 1]")
    base = knn_ring(m, k)  # validates m/k once, outside the retry loop

    def draw(s: int) -> Topology:
        rng = np.random.default_rng(s)
        adj = base.adj.copy()
        for step in range(1, k // 2 + 1):
            for i in range(m):
                j = (i + step) % m
                if adj[i, j] and rng.random() < beta:
                    cand = np.nonzero((adj[i] == 0) & (np.arange(m) != i))[0]
                    if cand.size:
                        t = int(rng.choice(cand))
                        adj[i, j] = adj[j, i] = 0
                        adj[i, t] = adj[t, i] = 1
        return Topology(f"ws({m},k={k},beta={beta:g},seed={s})", adj)

    return _draw_connected(f"ws(k={k},beta={beta:g})", m, seed, draw)


def erdos_renyi(m: int, p: float, seed: int = 0) -> Topology:
    """G(m, p): each pair wired independently with prob p.

    Re-draws until connected (bounded) — below the ln(m)/m connectivity
    threshold the retry budget runs out with a clear error rather than
    silently handing a disconnected graph to the consensus layer.
    """
    if not (0.0 < p <= 1.0):
        raise ValueError(f"edge probability p={p} must be in (0, 1]")

    def draw(s: int) -> Topology:
        rng = np.random.default_rng(s)
        upper = np.triu(rng.random((m, m)) < p, k=1).astype(int)
        return Topology(f"er({m},p={p:g},seed={s})", upper + upper.T)

    return _draw_connected(f"er(p={p:g})", m, seed, draw)


REGISTRY = {
    "ring": ring,
    "chain": chain,
    "full": fully_connected,
    "star": star,
}

# Sparse graph families for the lambda_2 (algebraic-connectivity) sweep axis:
# label -> constructor(m, seed) at fixed m. Ordered roughly by increasing mu2 so
# sweep figures read left-to-right along the connectivity axis.
GRAPH_FAMILIES = {
    "chain": lambda m, seed=0: chain(m),
    "ring": lambda m, seed=0: ring(m),
    "knn4": lambda m, seed=0: knn_ring(m, 4),
    "ws4": lambda m, seed=0: watts_strogatz(m, 4, 0.3, seed),
    "knn8": lambda m, seed=0: knn_ring(m, 8),
    "er25": lambda m, seed=0: erdos_renyi(m, 0.25, seed),
    "full": lambda m, seed=0: fully_connected(m),
}
