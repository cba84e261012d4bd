"""Port parity: agent topologies, neighbour lists and gossip weight tables.

``repro_torch.core.topology`` is the port's own numpy copy of
``repro.core.topology``. Every graph family (at several m and seeds), the
Laplacian, the mixing matrix, the neighbour lists and both weight tables
must come out identical (``array_equal``: rtol 0, the same dtype), mu2 equal,
and the validation errors the same.
"""
import numpy as np
import pytest

from repro.core import topology as J
from repro_torch.core import topology as T

FAMILIES = {
    "ring": lambda M, m, s: M.ring(m),
    "chain": lambda M, m, s: M.chain(m),
    "full": lambda M, m, s: M.fully_connected(m),
    "star": lambda M, m, s: M.star(m),
    "torus": lambda M, m, s: M.torus2d(2, m // 2),
    "knn4": lambda M, m, s: M.knn_ring(m, 4),
    "rand3-4": lambda M, m, s: M.random_regularish(m, 3, 4, s),
    "rand5-6": lambda M, m, s: M.random_regularish(m, 5, 6, s),
    "ws4": lambda M, m, s: M.watts_strogatz(m, 4, 0.3, s),
    "er": lambda M, m, s: M.erdos_renyi(m, 0.3, s),
}


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("m, seed", [(7, 0), (10, 3), (16, 1)])
def test_families_and_tables_are_identical(family, m, seed):
    jt = FAMILIES[family](J, m, seed)
    tt = FAMILIES[family](T, m, seed)
    assert tt.name == jt.name
    _same(tt.adj, jt.adj)
    assert tt.is_connected() == jt.is_connected()
    assert (tt.max_degree, tt.n_edges) == (jt.max_degree, jt.n_edges)
    _same(T.laplacian(tt), J.laplacian(jt))
    assert T.mu2(tt) == J.mu2(jt)
    assert T.density(tt) == J.density(jt)
    eps = 0.9 / tt.max_degree
    _same(T.mixing_matrix(tt, eps), J.mixing_matrix(jt, eps))
    assert T.spectral_gap_factor(tt, eps, 2) == J.spectral_gap_factor(jt, eps, 2)
    for k_max in (None, m):
        tn, jn = T.neighbor_list(tt, k_max), J.neighbor_list(jt, k_max)
        assert tn.name == jn.name and tn.k_max == jn.k_max
        for f in ("idx", "valid", "degrees"):
            _same(getattr(tn, f), getattr(jn, f))
        _same(T.neighbor_weights(tn, eps), J.neighbor_weights(jn, eps))
        p64 = J.mixing_matrix(jt, eps)
        _same(T.neighbor_weights_from_matrix(tn, p64),
              J.neighbor_weights_from_matrix(jn, p64))


@pytest.mark.parametrize("m, k", [(8, 2), (16, 4), (64, 8), (101, 6)])
def test_knn_ring_neighbors_and_mu2_closed_form(m, k):
    tn, jn = T.knn_ring_neighbors(m, k), J.knn_ring_neighbors(m, k)
    assert tn.name == jn.name
    for f in ("idx", "valid", "degrees"):
        _same(getattr(tn, f), getattr(jn, f))
    assert T.mu2_knn_ring(m, k) == J.mu2_knn_ring(m, k)
    # the weight table from eps equals the fp32 rebuild eye(m) - eps * La,
    # gathered, entry for entry
    eps = 0.5 / (k + 1)
    _same(T.neighbor_weights(tn, eps), J.neighbor_weights(jn, eps))
    lap = T.laplacian(T.knn_ring(m, k)).astype(np.float32)
    p32 = np.eye(m, dtype=np.float32) - np.float32(eps) * lap
    _same(T.neighbor_weights(tn, eps), T.neighbor_weights_from_matrix(tn, p32))


def test_registries_name_the_same_families():
    assert list(T.REGISTRY) == list(J.REGISTRY)
    assert list(T.GRAPH_FAMILIES) == list(J.GRAPH_FAMILIES)
    for name in T.GRAPH_FAMILIES:
        _same(T.GRAPH_FAMILIES[name](12, 2).adj, J.GRAPH_FAMILIES[name](12, 2).adj)
    for name in T.REGISTRY:
        _same(T.REGISTRY[name](6).adj, J.REGISTRY[name](6).adj)


def _err(fn):
    try:
        fn()
    except Exception as e:     # noqa: BLE001 - the error itself is compared
        return type(e), str(e)
    return None


BAD = {
    "non-square": lambda M: M.Topology("x", np.zeros((2, 3), int)),
    "asymmetric": lambda M: M.Topology("x", np.array([[0, 1], [0, 0]])),
    "self loop": lambda M: M.Topology("x", np.eye(2, dtype=int)),
    "eps too big": lambda M: M.mixing_matrix(M.ring(5), 0.5),
    "eps zero": lambda M: M.mixing_matrix(M.ring(5), 0.0),
    "ring m": lambda M: M.ring(2),
    "chain m": lambda M: M.chain(1),
    "knn odd": lambda M: M.knn_ring(8, 3),
    "knn big": lambda M: M.knn_ring_neighbors(4, 4),
    "mu2 knn": lambda M: M.mu2_knn_ring(4, 1),
    "ws beta": lambda M: M.watts_strogatz(8, 2, 1.5),
    "er p": lambda M: M.erdos_renyi(8, 0.0),
    "er disconnected": lambda M: M.erdos_renyi(30, 0.001),
    "k_max small": lambda M: M.neighbor_list(M.ring(6), 2),
    "weights shape": lambda M: M.neighbor_weights_from_matrix(
        M.neighbor_list(M.ring(5)), np.eye(4)),
    "nl pad": lambda M: M.NeighborList("x", np.array([[0, 1], [1, 0]]),
                                       np.array([[True, True], [True, False]]),
                                       np.array([1, 0])),
    "nl prefix": lambda M: M.NeighborList("x", np.array([[0, 1]]),
                                          np.array([[False, True]]),
                                          np.array([0])),
    "nl order": lambda M: M.NeighborList("x", np.array([[1, 0], [0, 1]]),
                                         np.ones((2, 2), bool),
                                         np.array([1, 1])),
    "nl degrees": lambda M: M.NeighborList("x", np.array([[0, 1], [0, 1]]),
                                           np.ones((2, 2), bool),
                                           np.array([0, 1])),
}


@pytest.mark.parametrize("case", list(BAD))
def test_the_same_validation_errors(case):
    want = _err(lambda: BAD[case](J))
    assert want is not None
    assert _err(lambda: BAD[case](T)) == want
