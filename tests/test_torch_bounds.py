"""Port parity: the closed-form bounds T1-T5, (14), (7), (27) and (13).

``repro_torch.core.bounds`` is the JAX module's float and numpy math in the
same order, so every function is held **bitwise** (``==`` on the returned
floats) against ``repro.core.bounds`` on the same inputs: a grid of tau,
lambda, nu, omega^2, E, eps and topologies (each topology built by both
packages' own constructors, which give identical adjacencies), the decay
families of T3 (both packages' own decay functions), and the errors each
raises. Then the orderings ``tests/test_bounds.py`` asserts, on the port,
and the committed ``experiments/bench/torch_bounds_theory.csv``
(``benchmarks/torch_bounds_bench.py --quick``) bitwise against the rows of
the JAX bench's ``run(quick=True)``.
"""
import csv
import itertools
import os

import numpy as np
import pytest

from repro.core import bounds as jb
from repro.core import decay as jdecay
from repro.core import topology as jtop
from repro_torch.core import bounds as tb
from repro_torch.core import decay as tdecay
from repro_torch.core import topology as ttop

CONSTS = (
    dict(L=1.0, sigma2=2.0, beta=0.5, eta=0.01, K=100_000, m=7,
         f0_minus_finf=10.0),
    dict(L=1.0, sigma2=2.0, beta=0.5, eta=1e-4, K=300_000, m=7,
         f0_minus_finf=10.0),
    dict(L=3.7, sigma2=0.09, beta=0.0, eta=0.05, K=320, m=64,
         f0_minus_finf=512.0),
)
TAUS = (1, 2, 5, 10, 15)
TOPOS = (("random_regularish", (7, 3, 4, 0)), ("random_regularish", (9, 5, 6, 0)),
         ("ring", (6,)), ("chain", (7,)), ("knn_ring", (64, 4)),
         ("star", (8,)), ("erdos_renyi", (12, 0.4, 1)))
DECAYS = {
    "exp0.9": lambda mod: mod.exponential_decay(0.9),
    "exp0.99": lambda mod: mod.exponential_decay(0.99),
    "linear": lambda mod: mod.linear_decay(10, 0.2),
    "step": lambda mod: mod.step_decay(4, 0.3),
    "none": lambda mod: mod.no_decay(),
}


def _consts(i):
    return jb.SgdConstants(**CONSTS[i]), tb.SgdConstants(**CONSTS[i])


def _same(got, want):
    assert type(got) is type(want), (type(got), type(want))
    assert got == want, (got, want)


def _topos(name, args):
    return getattr(jtop, name)(*args), getattr(ttop, name)(*args)


@pytest.mark.parametrize("ci", range(len(CONSTS)))
def test_tau_bounds_bitwise(ci):
    jc, tc = _consts(ci)
    _same(tb._common_terms(tc), jb._common_terms(jc))
    for tau in TAUS:
        _same(tb.eta_condition(tc, tau), jb.eta_condition(jc, tau))
        _same(tb.max_feasible_eta(tc, tau), jb.max_feasible_eta(jc, tau))
        _same(tb.periodic_bound_t1(tc, tau), jb.periodic_bound_t1(jc, tau))
        taus = np.arange(1, tau + 1)
        _same(tb.variation_bound_t2_empirical(tc, tau, taus),
              jb.variation_bound_t2_empirical(jc, tau, taus))
        for lam in (0.4, 0.7, 0.9, 0.95, 0.98, 1 - 1e-4):
            _same(tb.decay_bound_t4(tc, tau, lam), jb.decay_bound_t4(jc, tau, lam))


@pytest.mark.parametrize("ci", range(len(CONSTS)))
def test_variation_bound_bitwise_over_nu_and_omega2(ci):
    jc, tc = _consts(ci)
    for tau in (5, 10, 15):
        for nu, w2 in itertools.product((1.0, 3.0, (1 + tau) / 2, tau),
                                        (0.0, 2.0, (tau ** 2 - 1) / 12)):
            _same(tb.variation_bound_t2(tc, tau, nu, w2),
                  jb.variation_bound_t2(jc, tau, nu, w2))


@pytest.mark.parametrize("topo", TOPOS, ids=[f"{n}{a}" for n, a in TOPOS])
def test_consensus_bound_and_eq27_bitwise(topo):
    jt, tt = _topos(*topo)
    np.testing.assert_array_equal(tt.adj, jt.adj)
    for ci in range(len(CONSTS)):
        jc, tc = _consts(ci)
        for tau, rounds, frac in itertools.product((1, 10), (1, 2, 4),
                                                   (0.3, 0.9)):
            eps = frac / jt.max_degree
            _same(tb.consensus_bound_t5(tc, tau, tt, eps, rounds),
                  jb.consensus_bound_t5(jc, tau, jt, eps, rounds))
    m = jt.m
    taus = np.minimum(np.arange(m) % 10 + 1, 10)[::-1].copy()
    kw = dict(m=m, taus=taus, tau=10, T=1500, U=500, P=250, c1=1.0, c2=0.1)
    for rounds, (w1, w2) in itertools.product((1, 2), ((1.0, 1.0), (0.3, 0.05))):
        _same(tb.resource_cost_consensus(topo=tt, rounds=rounds, w1=w1, w2=w2,
                                         **kw),
              jb.resource_cost_consensus(topo=jt, rounds=rounds, w1=w1, w2=w2,
                                         **kw))


@pytest.mark.parametrize("family", list(DECAYS))
def test_decay_bound_numeric_bitwise(family):
    """T3 over the port's and the JAX package's own decay functions: their
    weights are the same fp32 numbers for these families (the cosine
    family's may differ by an ulp, tests/test_torch_strategies.py) and both
    add the squares left to right, so Z(j) and psi_3 agree bitwise."""
    jd, td = DECAYS[family](jdecay), DECAYS[family](tdecay)
    for ci in range(len(CONSTS)):
        jc, tc = _consts(ci)
        for tau in (5, 10, 16, 31):
            for taus in (np.arange(1, tau + 1), np.full(7, tau),
                         np.array([tau, tau, 3, 2, 1])):
                assert tdecay.decay_sq_prefix_sum(td, tau) == \
                    jdecay.decay_sq_prefix_sum(jd, tau)
                _same(tb.decay_bound_numeric(tc, tau, taus, td),
                      jb.decay_bound_numeric(jc, tau, taus, jd))


def test_costs_and_utility_bitwise():
    for tau, m, c1, c2 in itertools.product((1, 5, 10), (7, 64), (1.0, 0.0),
                                            (0.0, 0.1, 1.0)):
        taus = np.full(m, tau)
        kw = dict(m=m, taus=taus, tau=tau, T=1500, U=500, P=250, c1=c1, c2=c2)
        _same(tb.resource_cost_periodic(**kw), jb.resource_cost_periodic(**kw))
    for psi1, psi2, psi0, alpha in itertools.product(
            (1.0, 5.0, 0.123), (10.0, 2.5), (100.0, 1e3, 7.7), (1.0, 0.5)):
        _same(tb.utility(psi1=psi1, psi2=psi2, psi0=psi0, alpha=alpha),
              jb.utility(psi1=psi1, psi2=psi2, psi0=psi0, alpha=alpha))


@pytest.mark.parametrize("case", ["nu_low", "nu_high", "lam_1", "lam_0", "psi0",
                                  "taus_len"])
def test_errors_match(case):
    jc, tc = _consts(0)
    calls = {
        "nu_low": lambda b, c: b.variation_bound_t2(c, 10, 0.5, 0.0),
        "nu_high": lambda b, c: b.variation_bound_t2(c, 10, 11.0, 0.0),
        "lam_1": lambda b, c: b.decay_bound_t4(c, 10, 1.0),
        "lam_0": lambda b, c: b.decay_bound_t4(c, 10, 0.0),
        "psi0": lambda b, c: b.utility(psi1=1.0, psi2=2.0, psi0=0.0),
        "taus_len": lambda b, c: b.resource_cost_periodic(
            m=7, taus=np.full(6, 3), tau=3, T=1, U=1, P=1, c1=1.0, c2=1.0),
    }
    with pytest.raises(ValueError) as je:
        calls[case](jb, jc)
    with pytest.raises(ValueError) as te:
        calls[case](tb, tc)
    assert str(te.value) == str(je.value)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_committed_bounds_csv_equals_jax_bench_rows(tmp_path, monkeypatch):
    from benchmarks import bounds_bench, common

    monkeypatch.setattr(common, "OUT_DIR", str(tmp_path))
    want = bounds_bench.run(quick=True)
    with open(os.path.join(ROOT, "experiments", "bench",
                           "torch_bounds_theory.csv")) as f:
        got = list(csv.DictReader(f))
    assert [list(r) for r in got] == [list(map(str, r)) for r in want]
    for g, w in zip(got, want):
        assert int(g["tau"]) == w["tau"]
        for k, v in w.items():
            assert float(g[k]) == v, (k, g[k], v)
    assert len(got) == 2


def test_bounds_bench_rows_equal_the_committed_file(tmp_path, monkeypatch):
    from benchmarks import torch_bounds_bench, torch_common

    monkeypatch.setattr(torch_common, "OUT_DIR", str(tmp_path))
    rows = torch_bounds_bench.run(quick=True)
    with open(tmp_path / "torch_bounds_theory.csv") as f:
        fresh = f.read()
    with open(os.path.join(ROOT, "experiments", "bench",
                           "torch_bounds_theory.csv")) as f:
        assert fresh == f.read()
    assert [r["tau"] for r in rows] == [1, 10]


# --- the orderings of tests/test_bounds.py, on the port -------------------------

C = tb.SgdConstants(**CONSTS[0])


def test_t1_increases_with_tau():
    vals = [tb.periodic_bound_t1(C, t) for t in (1, 5, 10, 20)]
    assert all(a < b for a, b in zip(vals, vals[1:]))


def test_t2_increases_with_nu_and_decreases_with_omega2():
    vals = [tb.variation_bound_t2(C, 10, nu, 0.0) for nu in (1, 3, 5, 8, 10)]
    assert all(a < b for a, b in zip(vals, vals[1:]))
    vals = [tb.variation_bound_t2(C, 10, 5.0, w2) for w2 in (0.0, 2.0, 6.0)]
    assert all(a > b for a, b in zip(vals, vals[1:]))
    assert np.isclose(tb.variation_bound_t2(C, 8, 8.0, 0.0),
                      tb.periodic_bound_t1(C, 8), rtol=1e-12)


def test_t3_decay_never_worse_than_t2():
    tau = 10
    taus = np.arange(1, tau + 1)
    base = tb.decay_bound_numeric(C, tau, taus, tdecay.no_decay())
    for lam in (0.99, 0.95, 0.9, 0.7):
        dec = tb.decay_bound_numeric(C, tau, taus, tdecay.exponential_decay(lam))
        assert dec <= base + 1e-12, lam


def test_t4_decreasing_in_lambda_and_near_t2_at_1():
    vals = [tb.decay_bound_t4(C, 10, lam) for lam in (0.98, 0.9, 0.7, 0.4)]
    assert all(a > b for a, b in zip(vals, vals[1:]))
    base = tb._common_terms(C)
    t2 = tb.variation_bound_t2(C, 10, 5.5, 99 / 12)
    assert np.isclose(tb.decay_bound_t4(C, 10, 1 - 1e-4) - base, t2 - base,
                      rtol=2e-2)


def test_t5_below_t1_and_falls_with_rounds_and_mu2():
    topo = ttop.random_regularish(7, 3, 4, seed=0)
    eps = 0.9 / topo.max_degree
    prev = tb.periodic_bound_t1(C, 10)
    for rounds in (1, 2, 4):
        t5 = tb.consensus_bound_t5(C, 10, topo, eps, rounds)
        assert t5 < prev
        prev = t5
    sparse = ttop.random_regularish(9, 3, 4, seed=0)
    dense = ttop.random_regularish(9, 5, 6, seed=0)
    eps = 0.9 / max(sparse.max_degree, dense.max_degree)
    assert (tb.consensus_bound_t5(C, 10, dense, eps, 1)
            < tb.consensus_bound_t5(C, 10, sparse, eps, 1))


def test_eta_condition_at_max_eta_and_table2_costs():
    eta = tb.max_feasible_eta(C, 10)
    ok = tb.SgdConstants(**{**CONSTS[0], "eta": eta * 0.999})
    bad = tb.SgdConstants(**{**CONSTS[0], "eta": eta * 1.01})
    assert tb.eta_condition(ok, 10) <= 0 < tb.eta_condition(bad, 10)
    taus = np.full(7, 10)
    kw = dict(m=7, taus=taus, tau=10, T=1500, U=500, P=250)
    assert np.isclose(tb.resource_cost_periodic(c1=1.0, c2=0.0, **kw), 2100)
    assert np.isclose(tb.resource_cost_periodic(c1=0.0, c2=1.0, **kw), 21000)
    topo = ttop.chain(7)
    full = tb.resource_cost_consensus(c1=1.0, c2=1.0, topo=topo, rounds=1,
                                      w1=1.0, w2=1.0, **kw)
    base = tb.resource_cost_periodic(c1=1.0, c2=1.0, **kw)
    assert np.isclose(full - base, topo.degrees.sum() * 2 * 1500 * 500 / 250)
    assert (tb.utility(psi1=1.0, psi2=10.0, psi0=100.0)
            > tb.utility(psi1=1.0, psi2=10.0, psi0=1000.0))
