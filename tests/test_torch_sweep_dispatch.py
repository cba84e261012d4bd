"""Port parity for the sweep slice's parts: the ``(S, m, n)`` dispatch forms,
the results, the spec, the overrides and the per-run tables, against the JAX
package on the same numpy inputs.

* Every flat primitive on ``(S, m, n)`` buffers against JAX's jnp dispatch,
  in fp32, bf16 and fp16, with JAX's coefficient forms (scalar, shared
  ``(m,)``, per-run ``(S,)`` / ``(S, m)``, shared / per-run mixing and edge
  weights): within one ulp of the output's dtype at its largest magnitude,
  as ``tests/test_torch_flat_kernels.py`` holds the ``(m, n)`` forms; and
  bitwise against the port's own ``(m, n)`` call on each run's slice.
* The S == m refusals with JAX's ``ValueError`` text.
* ``t_critical``, ``mean_ci``, ``SweepResult.summary`` / ``rows`` and the
  saved JSON / CSV against JAX's on the same metric arrays, exactly.
* The spec's validation errors, the overrides' tables against JAX's
  overrides (fp32 tables bitwise where both take the same fp32 operations).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_strategy as jmake
from repro.core import topology as jtop
from repro.core.decay import exponential_decay as jexp
from repro.kernels import dispatch as jd
from repro.rl import FIGURE_EIGHT as JF8
from repro.rl import FedRLConfig as JConfig
from repro import sweep as jsweep
from repro.sweep import overrides as jov
from repro_torch.core import make_strategy as tmake
from repro_torch.core import topology as ttop
from repro_torch.core.decay import exponential_decay as texp
from repro_torch.core.strategies import stack_runs
from repro_torch.core.variation import mask_from_taus
from repro_torch.kernels import dispatch as td
from repro_torch.rl import FIGURE_EIGHT as TF8
from repro_torch.rl import FedRLConfig as TConfig
from repro_torch import sweep as tsweep
from repro_torch.sweep import overrides as tov

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
S, M, N = 3, 5, 37


def _arr(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype_name):
    got, want = _np(got), _np(want)
    eps = float(jnp.finfo(DTYPES[dtype_name][0]).eps)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=eps * max(float(np.abs(want).max()), 1e-30))


def _coefs():
    return {"scalar": np.float32(0.37), "shared": _arr(M, 2),
            "per_run": _arr(S, 3), "per_row": _arr((S, M), 4)}


def _per_run_coef(form, c, s):
    return c[s] if form in ("per_run", "per_row") else c


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("form", ["scalar", "shared", "per_run", "per_row"])
def test_decay_accum_sweep_forms_match_jax(dtype, form):
    jdt, tdt = DTYPES[dtype]
    acc, g = _arr((S, M, N), 0), _arr((S, M, N), 1)
    c = _coefs()[form]
    want = jd.decay_accum(jnp.asarray(acc).astype(jdt),
                          jnp.asarray(g).astype(jdt), c, backend="jnp")
    ta, tg = torch.tensor(acc).to(tdt), torch.tensor(g).to(tdt)
    got = td.decay_accum(ta, tg, c if form == "scalar" else torch.tensor(c))
    assert got.dtype == tdt and tuple(got.shape) == (S, M, N)
    _close(got, want, dtype)
    for s in range(S):
        cs = _per_run_coef(form, c, s)
        one = td.decay_accum(ta[s], tg[s], torch.tensor(cs)
                             if np.ndim(cs) else float(cs))
        assert torch.equal(got[s], one)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("form", ["shared", "per_row"])
def test_scale_rows_sweep_forms_match_jax(dtype, form):
    jdt, tdt = DTYPES[dtype]
    g = _arr((S, M, N), 1)
    w = _coefs()[form]
    want = jd.scale_rows(jnp.asarray(g).astype(jdt), w, backend="jnp")
    tg = torch.tensor(g).to(tdt)
    got = td.scale_rows(tg, torch.tensor(w))
    _close(got, want, dtype)
    for s in range(S):
        assert torch.equal(got[s], td.scale_rows(
            tg[s], torch.tensor(_per_run_coef(form, w, s))))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_row_mean_sweep_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    g = _arr((S, M, N), 5)
    want = jd.row_mean(jnp.asarray(g).astype(jdt), backend="jnp")
    got = td.row_mean(torch.tensor(g).to(tdt))
    assert tuple(got.shape) == (S, N) and got.dtype == tdt
    _close(got, want, dtype)
    for s in range(S):
        assert torch.equal(got[s], td.row_mean(torch.tensor(g[s]).to(tdt)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("per_run", [False, True])
def test_consensus_mix_sweep_matches_jax(dtype, per_run):
    jdt, tdt = DTYPES[dtype]
    g = _arr((S, M, N), 6)
    p = np.asarray(jtop.mixing_matrix(jtop.ring(M), 0.25), np.float32)
    mix = p[None] * (0.5 + np.arange(S, dtype=np.float32))[:, None, None] \
        if per_run else p
    want = jd.consensus_mix(jnp.asarray(g).astype(jdt), mix, backend="jnp")
    tg = torch.tensor(g).to(tdt)
    got = td.consensus_mix(tg, torch.tensor(mix))
    _close(got, want, dtype)
    for s in range(S):
        assert torch.equal(got[s], td.consensus_mix(
            tg[s], torch.tensor(mix[s] if per_run else mix)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("per_run", [False, True])
def test_consensus_gather_sweep_matches_jax(dtype, per_run):
    jdt, tdt = DTYPES[dtype]
    g = _arr((S, M, N), 7)
    nl = jtop.neighbor_list(jtop.ring(M))
    w0 = np.asarray(jtop.neighbor_weights(nl, 0.25), np.float32)
    w = w0[None] * (0.5 + np.arange(S, dtype=np.float32))[:, None, None] \
        if per_run else w0
    with jax.disable_jit():
        want = jd.consensus_gather(jnp.asarray(g).astype(jdt), nl.idx, w,
                                   backend="jnp")
    tg = torch.tensor(g).to(tdt)
    got = td.consensus_gather(tg, nl.idx, w)
    np.testing.assert_array_equal(_np(got), _np(want))
    for s in range(S):
        assert torch.equal(got[s], td.consensus_gather(
            tg[s], nl.idx, w[s] if per_run else w))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_topk_scatter_sweep_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    x = _arr((S, M, N), 8)
    th = np.sort(np.abs(x), axis=-1)[..., -5].astype(np.float32)
    ws, wr = jd.topk_scatter(jnp.asarray(x).astype(jdt), th, backend="jnp")
    tx = torch.tensor(x).to(tdt)
    gs, gr = td.topk_scatter(tx, torch.tensor(th))
    assert tuple(gs.shape) == (S, N) and tuple(gr.shape) == (S, M, N)
    _close(gs, ws, dtype)
    np.testing.assert_array_equal(_np(gr), _np(wr))
    for s in range(S):
        os_, or_ = td.topk_scatter(tx[s], torch.tensor(th[s]))
        assert torch.equal(gs[s], os_) and torch.equal(gr[s], or_)


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
@pytest.mark.parametrize("form", ["scalar", "shared", "per_run", "per_row"])
@pytest.mark.parametrize("per_run_lr", [False, True])
def test_flat_opt_update_sweep_matches_jax_per_run(kind, form, per_run_lr):
    """JAX's flat_opt_update has no (S, m, n) form (its sweep vmaps whole
    runs), so each run's slice of the port's batched call is held against
    JAX's (m, n) call at that run's coefficient and rate."""
    p, g = _arr((S, M, N), 9), _arr((S, M, N), 10)
    mu, nu = _arr((S, M, N), 11, 0.1), np.abs(_arr((S, M, N), 12, 0.1))
    c = _coefs()[form]
    lrs = np.asarray([5e-3, 2e-3, 1e-2], np.float32)
    state = {"sgd": {}, "momentum": {"mu": torch.tensor(mu)},
             "adam": {"mu": torch.tensor(mu), "nu": torch.tensor(nu), "t": 2}}
    got_p, got_s = td.flat_opt_update(
        torch.tensor(p), torch.tensor(g),
        c if form == "scalar" else torch.tensor(c), state[kind], kind=kind,
        lr=torch.tensor(lrs) if per_run_lr else 5e-3)
    for s in range(S):
        jstate = {"sgd": {}, "momentum": {"mu": jnp.asarray(mu[s])},
                  "adam": {"mu": jnp.asarray(mu[s]), "nu": jnp.asarray(nu[s]),
                           "t": jnp.asarray(2, jnp.int32)}}[kind]
        want_p, want_s = jd.flat_opt_update(
            jnp.asarray(p[s]), jnp.asarray(g[s]),
            jnp.asarray(_per_run_coef(form, c, s)), jstate, kind=kind,
            lr=jnp.float32(lrs[s] if per_run_lr else 5e-3), backend="jnp")
        _close(got_p[s], want_p, "float32")
        for k in ("mu", "nu"):
            if k in want_s:
                _close(got_s[k][s], want_s[k], "float32")


def _raises_both(match, jfn, tfn):
    with pytest.raises(ValueError, match=match):
        jfn()
    with pytest.raises(ValueError, match=match):
        tfn()


def test_s_equal_m_guards_raise_jax_text():
    k = 4
    x = _arr((k, k, 9), 0)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    _raises_both(
        r"decay_accum: 1-D d of length 4 is ambiguous on a sweep path with "
        r"S == m == 4; pass \(S, m\) coefficients \(tile the shared/per-run "
        r"vector\) or a scalar",
        lambda: jd.decay_accum(jx, jx, jnp.ones(k), backend="jnp"),
        lambda: td.decay_accum(tx, tx, torch.ones(k)))
    _raises_both(
        r"scale_rows: 1-D w of length 4 is ambiguous on a sweep path with "
        r"S == m == 4; pass \(S, m\) weights",
        lambda: jd.scale_rows(jx, jnp.ones(k), backend="jnp"),
        lambda: td.scale_rows(tx, torch.ones(k)))
    with pytest.raises(ValueError, match="ambiguous"):
        td.flat_opt_update(tx, tx, torch.ones(k), {}, kind="sgd", lr=0.1)
    _raises_both(
        r"topk_scatter: thresh must be \(4, 4\) on the sweep path, got \(4,\)",
        lambda: jd.topk_scatter(jx, jnp.ones(k), backend="jnp"),
        lambda: td.topk_scatter(tx, torch.ones(k)))
    # the explicit forms still work
    assert td.decay_accum(tx, tx, torch.ones(k, k)).shape == tx.shape
    assert td.decay_accum(tx, tx, 0.5).shape == tx.shape


# --- results and spec ----------------------------------------------------------------

def test_t_table_and_mean_ci_match_jax():
    from repro.sweep import results as jres
    from repro_torch.sweep import results as tres

    assert tres._T_TABLE == jres._T_TABLE and tres._Z == jres._Z
    for conf in (0.90, 0.95, 0.99):
        for df in (1, 2, 3, 7, 30, 31, 100):
            assert tres.t_critical(df, conf) == jres.t_critical(df, conf)
    for bad in ((3, 0.5), (0, 0.95)):
        _raises_both("confidence|df", lambda: jres.t_critical(*bad),
                     lambda: tres.t_critical(*bad))
    x = _arr((4, 3, 5), 1)
    for axis in (0, 1):
        for a, b in zip(tres.mean_ci(x, axis), jres.mean_ci(x, axis)):
            np.testing.assert_array_equal(a, b)


def _metrics():
    rng = np.random.default_rng(3)
    return {"base": {"nas": rng.standard_normal((2, 3, 4)).astype(np.float32),
                     "loss": rng.standard_normal((2, 3, 4)).astype(np.float32)},
            "tau=3": {"nas": rng.standard_normal((2, 3, 4)).astype(np.float32)}}


def test_sweep_result_schema_matches_jax(tmp_path):
    kw = dict(name="arts", axes={"taus": [[3.0, 2.0, 1.0], [3.0, 3.0, 3.0]]},
              seeds=[0, 1, 2], metrics=_metrics(), wall_s={"base": 1.5},
              compile_s={"base": 0.5}, mode="vmapped", meta={"note": "x"})
    jr = jsweep.SweepResult(**kw)
    tr = tsweep.SweepResult(**kw)
    assert tr.summary() == jr.summary()
    assert tr.rows(0.9) == jr.rows(0.9)
    for a, b in zip(tr.seed_mean_ci("base", "nas"),
                    jr.seed_mean_ci("base", "nas")):
        np.testing.assert_array_equal(a, b)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jj, jc = jr.save(str(jdir))
    tj, tc = tr.save(str(tdir))
    assert tj.endswith("torch_arts.v1.json") and tc.endswith("torch_arts.v1.csv")
    assert json.loads(open(tj).read()) == json.loads(open(jj).read())
    assert open(tc).read() == open(jc).read()
    # the next save takes the next version; a given version is never
    # overwritten
    assert tr.save(str(tdir))[0].endswith("torch_arts.v2.json")
    with pytest.raises(FileExistsError):
        tr.save(str(tdir), version=1)
    # a name that has the prefix keeps it once
    assert dataclasses.replace(tr, name="torch_x").file_name == "torch_x"


def test_spec_validation_matches_jax():
    for mod in (jsweep, tsweep):
        with pytest.raises(ValueError, match="seed"):
            mod.SweepSpec(name="x", base=None, seeds=())
        with pytest.raises(ValueError, match="needs >= 1 value"):
            mod.SweepAxis("lam", ())
        with pytest.raises(ValueError, match="share one shape"):
            mod.SweepAxis("taus", ((1.0, 2.0), 3.0))
        with pytest.raises(ValueError, match="scalars or non-empty 1-D"):
            mod.SweepAxis("x", (np.zeros((2, 2)),))
        with pytest.raises(ValueError, match="duplicate"):
            mod.SweepSpec(name="x", base=None, seeds=(0,),
                          vmapped=(mod.SweepAxis("a", (1.0,)),
                                   mod.SweepAxis("a", (2.0,))))
        with pytest.raises(ValueError, match="static axis"):
            mod.StaticAxis("s", ())
    ja = jsweep.SweepAxis("taus", ((3, 2, 1), (3, 3, 3)))
    ta = tsweep.SweepAxis("taus", ((3, 2, 1), (3, 3, 3)))
    assert ta.values == ja.values and ta.point_len == ja.point_len == 3
    spec = tsweep.SweepSpec(name="x", base=None, seeds=(0, 1),
                            vmapped=(ta, tsweep.SweepAxis("eta", (1e-3,))))
    assert spec.grid_shape == (2, 1, 2) and spec.n_runs == 4


def test_static_points_match_jax():
    pts = lambda mod: (mod.StaticAxis("a", (("x", lambda c: c + 1),
                                            ("y", lambda c: c * 2))),
                       mod.StaticAxis("b", (("", lambda c: c - 3),)))
    jspec = jsweep.SweepSpec(name="s", base=5, seeds=(0,), static=pts(jsweep))
    tspec = tsweep.SweepSpec(name="s", base=5, seeds=(0,), static=pts(tsweep))
    got = [(lab, fn(5)) for lab, fn in tsweep.static_points(tspec)]
    assert got == [(lab, fn(5)) for lab, fn in jsweep.static_points(jspec)]
    dup = tsweep.SweepSpec(name="s", base=5, seeds=(0,), static=(
        tsweep.StaticAxis("a", (("x", lambda c: c), ("x", lambda c: c))),))
    with pytest.raises(ValueError, match="duplicate static-point label"):
        list(tsweep.static_points(dup))


# --- overrides and per-run tables ------------------------------------------------------

def _cfgs(kind, **kw):
    common = dict(n_epochs=1, epoch_len=4, minibatch=2, eta=5e-3)
    jkw, tkw = dict(tau=4, m=7), dict(tau=4, m=7)
    if kind == "decay":
        jkw["decay"], tkw["decay"] = jexp(0.95), texp(0.95)
    if kind == "consensus":
        jkw["topo"] = jtop.random_regularish(7, 3, 4, 0)
        tkw["topo"] = ttop.random_regularish(7, 3, 4, 0)
        jkw["eps"] = tkw["eps"] = 0.9 / tkw["topo"].max_degree
        jkw.update(kw)
        tkw.update(kw)
    return (JConfig(env=JF8, strategy=jmake(kind, backend="jnp", **jkw),
                    **common),
            TConfig(env=TF8, strategy=tmake(kind, **tkw), **common))


def test_override_tables_match_jax():
    jc, tc = _cfgs("decay")
    for lam in (np.float32(0.92), np.linspace(0.9, 0.99, 7, dtype=np.float32)):
        jw = np.asarray(jov.override_lam(jc, jnp.asarray(lam)).strategy
                        .decay_weights)
        tw = tov.override_lam(tc, lam).strategy.decay_weights
        np.testing.assert_allclose(tw, jw, rtol=2e-7, atol=0)
    np.testing.assert_array_equal(
        tov.override_lam(tc, np.float32(0.95)).strategy.decay_weights,
        tc.strategy.decay_weights)          # the static builder's table
    assert tov.override_eta(tc, np.float32(3e-3)).eta == float(np.float32(3e-3))
    taus = np.asarray([4, 4, 3, 3, 2, 1, 1], np.float32)
    jm = np.asarray(jov.override_taus(jc, jnp.asarray(taus)).strategy.mask)
    np.testing.assert_array_equal(
        tov.override_taus(tc, taus).strategy.mask, jm)
    for sparse in (False, True):
        jc, tc = _cfgs("consensus", sparse=sparse)
        eps = np.float32(0.2)
        js = jov.override_eps(jc, jnp.asarray(eps)).strategy
        ts = tov.override_eps(tc, eps).strategy
        names = ("nl_w",) if sparse else ("p", "p_e", "p_masked",
                                          "p_e_masked")
        for name in names:
            np.testing.assert_array_equal(getattr(ts, name),
                                          np.asarray(getattr(js, name)), name)
        # the taus axis after eps refolds the masked tables as JAX does
        js2 = jov.override_taus(dataclasses.replace(jc, strategy=js),
                                jnp.asarray(taus)).strategy
        ts2 = tov.override_taus(dataclasses.replace(tc, strategy=ts),
                                taus).strategy
        for name in ("mask",) + (() if sparse else ("p_masked",
                                                    "p_e_masked")):
            np.testing.assert_array_equal(getattr(ts2, name),
                                          np.asarray(getattr(js2, name)), name)


def test_override_errors_match_jax():
    jc, tc = _cfgs("periodic")
    for fn in ("override_lam", "override_eps"):
        with pytest.raises(TypeError, match="axis needs a"):
            getattr(jov, fn)(jc, 0.5)
        with pytest.raises(TypeError, match="axis needs a"):
            getattr(tov, fn)(tc, 0.5)
    _raises_both(r"'taus' axis points must be \(7,\) vectors",
                 lambda: jov.override_taus(jc, jnp.ones(3)),
                 lambda: tov.override_taus(tc, np.ones(3)))
    _raises_both("A2.3", lambda: jov.override_taus(jc, np.full(7, 2.0)),
                 lambda: tov.override_taus(tc, np.full(7, 2.0)))
    jd_, td_ = _cfgs("decay")
    _raises_both(r"'lam' axis vector points must be \(7,\)",
                 lambda: jov.override_lam(jd_, jnp.ones(3)),
                 lambda: tov.override_lam(td_, np.ones(3)))
    _raises_both("'hetero_scale' axis points must be scalars",
                 lambda: jov.override_hetero_scale(jc, jnp.ones(3)),
                 lambda: tov.override_hetero_scale(tc, np.ones(3)))
    for fn, point in (("override_delay", np.ones(2)), ("override_k", 3.0)):
        with pytest.raises(TypeError, match="axis needs an AsyncStrategy"):
            getattr(jov, fn)(jc, jnp.asarray(point))
        with pytest.raises(TypeError, match="axis needs an AsyncStrategy"):
            tov.OVERRIDES[fn[len("override_"):]](tc, point)
    with pytest.raises(KeyError, match="no override registered"):
        tov.apply_overrides(tc, ["nope"], [1.0])
    assert set(tov.OVERRIDES) == set(jov.OVERRIDES)
    tov.register_override("_test_axis", lambda c, v: c)
    assert "_test_axis" in tov.OVERRIDES
    del tov.OVERRIDES["_test_axis"]


def test_stacked_tables_are_each_runs_tables():
    """stack_runs: the run axis of each table is the runs' own tables; runs
    that differ in more than values are refused."""
    _, tc = _cfgs("consensus")
    runs = [tov.override_eps(tc, np.float32(e)).strategy
            for e in (0.1, 0.2, 0.3)]
    st = stack_runs(runs)
    assert st.runs == 3 and st.weight_table().shape == (4, 3, 7)
    for s, r in enumerate(runs):
        np.testing.assert_array_equal(st.p_e_masked[:, s], r.p_e_masked)
        np.testing.assert_array_equal(st.p[s], r.p)
        np.testing.assert_array_equal(st.weight_table()[:, s],
                                      r.weight_table())
    _, td_ = _cfgs("decay")
    with pytest.raises(ValueError, match="differs from run 0"):
        stack_runs([td_.strategy, tc.strategy])
    with pytest.raises(ValueError, match="differs from run 0"):
        stack_runs([tc.strategy, tmake("consensus", tau=4, m=7,
                                       topo=ttop.ring(7), eps=0.2)])


def test_batched_masks_are_the_static_masks():
    scheds = np.asarray([[4, 3, 2, 2, 1], [4, 4, 4, 3, 3]], np.float32)
    got = mask_from_taus(scheds, 4)
    assert got.shape == (2, 5, 4)
    for s in range(2):
        np.testing.assert_array_equal(
            got[s], tmake("periodic", tau=4, taus=scheds[s].astype(int)).mask)
