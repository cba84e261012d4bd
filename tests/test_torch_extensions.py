"""Port parity: the beyond-paper strategies (hierarchical, quantised sync,
elastic averaging) against ``repro.core.extensions``.

Each ``server_average`` override is held against the JAX one on the same
trees: the hierarchical cluster mean (``consensus_mix`` with the fp32
cluster-mean matrix) and global mean (``row_mean``) within rtol 1e-6; the
quantiser's int8 codes exactly (its inputs away from the .5 rounding ties,
where an ulp of ``x / scale`` could flip a code), its averaged parameters
and residuals within rtol 1e-6; the elastic pull and anchor within rtol
1e-6. Then the cases of ``tests/test_extensions.py``, on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import extensions as jext
from repro_torch.core import extensions as text

CLUSTERS = ((0, 1, 2), (3, 4, 5))
SHAPES = {"b": (5,), "w": (4, 3)}


def _trees(m=6, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    arr = {k: (scale * rng.standard_normal((m,) + s)).astype(np.float32)
           for k, s in SHAPES.items()}
    return ({k: jnp.asarray(v) for k, v in arr.items()},
            {k: torch.from_numpy(v.copy()) for k, v in arr.items()})


def _close(got, want, rtol=1e-6, atol=1e-7):
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(np.shape(want[k]))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=rtol, atol=atol)


# --- hierarchical ----------------------------------------------------------------

@pytest.mark.parametrize("global_every", [1, 2, 3])
@pytest.mark.parametrize("period", [0, 1, 2, 5])
def test_hierarchical_server_average_matches_jax(global_every, period):
    js = jext.HierarchicalStrategy(tau=4, clusters=CLUSTERS,
                                   global_every=global_every)
    ts = text.HierarchicalStrategy(tau=4, clusters=CLUSTERS,
                                   global_every=global_every)
    jp, tp = _trees(seed=period)
    got = ts.server_average(tp, period_idx=period)
    _close(got, js.server_average(jp, period_idx=jnp.asarray(period)))
    _close(ts.server_average(tp), js.server_average(jp))
    assert ts.is_global(period) == ((period + 1) % global_every == 0)
    np.testing.assert_array_equal(ts.cluster_mean_matrix(), np.asarray(
        js._cluster_mean_matrix(), np.float32))


def test_hierarchical_local_then_global():
    s = text.HierarchicalStrategy(tau=4, clusters=CLUSTERS, global_every=2)
    _, p = _trees()
    w = s.server_average(p, period_idx=0)["w"].numpy()
    np.testing.assert_allclose(w[0], w[1], atol=1e-6)
    np.testing.assert_allclose(w[3], w[5], atol=1e-6)
    assert not np.allclose(w[0], w[3])
    np.testing.assert_allclose(w[0], p["w"].numpy()[:3].mean(0), atol=1e-6)
    wg = s.server_average(p, period_idx=torch.tensor(1))["w"].numpy()
    np.testing.assert_allclose(wg[0], wg[5], atol=1e-6)
    np.testing.assert_allclose(wg[0], p["w"].numpy().mean(0), atol=1e-6)


def test_hierarchical_uneven_clusters_and_variation():
    clusters = ((0, 4), (1, 2, 3, 5, 6))
    taus = np.array([3, 3, 2, 2, 1, 1, 1])
    js = jext.HierarchicalStrategy(tau=3, clusters=clusters, taus=taus)
    ts = text.HierarchicalStrategy(tau=3, clusters=clusters, taus=taus)
    np.testing.assert_array_equal(ts.mask, js.mask)
    jp, tp = _trees(m=7, seed=4)
    _close(ts.server_average(tp, period_idx=0),
           js.server_average(jp, period_idx=jnp.asarray(0)))


def test_hierarchical_requires_partition_and_bills_amortised_uploads():
    for mod in (jext, text):
        with pytest.raises(ValueError, match="partition"):
            mod.HierarchicalStrategy(tau=2, clusters=((0, 1), (1, 2)))
    ev = text.HierarchicalStrategy(tau=4, clusters=CLUSTERS,
                                   global_every=3).comm_events_per_period()
    assert ev == jext.HierarchicalStrategy(
        tau=4, clusters=CLUSTERS, global_every=3).comm_events_per_period()
    assert ev["c1"] == 2 and ev["w1"] == 4 and ev["w2"] == 4


# --- quantised sync --------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantizer_codes_equal_jax(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((6, 40)) * rng.uniform(0.1, 10, (6, 1))).astype(
        np.float32)
    jq, jscale = jax.vmap(jext._quantize_int8)(jnp.asarray(x))
    tq, tscale = text.quantize_int8(torch.from_numpy(x))
    ratio = x / np.asarray(jscale)[:, None]
    assert np.min(np.abs(np.abs(ratio - np.trunc(ratio)) - 0.5)) > 1e-4
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))


def test_quantizer_rounds_half_to_even():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]])
    q, scale = text.quantize_int8(x)
    assert float(scale[0]) == np.float32(1.0) + np.float32(1e-12)
    assert q.tolist() == [[127, 0, 2, 2, 0, -2]]


@pytest.mark.parametrize("seed", [0, 1])
def test_quantized_server_average_matches_jax(seed):
    js = jext.QuantizedSyncStrategy(tau=2, m=6)
    ts = text.QuantizedSyncStrategy(tau=2, m=6)
    jp, tp = _trees(seed=seed)
    ja, ta = _trees(m=1, seed=seed + 10, scale=0.1)
    ja = {k: v[0] for k, v in ja.items()}
    ta = {k: v[0] for k, v in ta.items()}
    je, te = _trees(seed=seed + 20, scale=1e-3)
    jnew, jerr = js.server_average(jp, anchor=ja, errors=je)
    tnew, terr = ts.server_average(tp, anchor=ta, errors=te)
    _close(tnew, jnew)
    _close(terr, jerr, atol=1e-6)
    # a second round on the residuals
    _close(ts.server_average(tnew, anchor=ta, errors=terr)[0],
           js.server_average(jnew, anchor=ja, errors=jerr)[0])
    _close(ts.server_average(tp), js.server_average(jp))


def test_quantized_sync_with_error_feedback_converges_to_mean():
    s = text.QuantizedSyncStrategy(tau=2, m=4)
    _, p = _trees(m=4, seed=1)
    anchor = {k: torch.zeros(v.shape[1:]) for k, v in p.items()}
    errors = {k: torch.zeros_like(v) for k, v in p.items()}
    new_p, new_e = s.server_average(p, anchor=anchor, errors=errors)
    mean = p["w"].numpy().mean(0)
    scale = np.abs(p["w"].numpy()).max() / 127.0
    assert np.max(np.abs(new_p["w"].numpy()[0] - mean)) <= scale * 1.01
    assert np.all(np.abs(new_e["w"].numpy()) <= scale * 0.51)
    assert new_e["w"].dtype == torch.float32


def test_quantized_validation_and_byte_factor():
    assert text.QuantizedSyncStrategy(tau=2, m=4, bits=8) \
        .comm_events_per_period()["c1_bytes_factor"] == 0.25
    with pytest.raises(ValueError, match="need taus or m"):
        text.QuantizedSyncStrategy(tau=2)
    with pytest.raises(ValueError):
        text.ElasticAveragingStrategy(tau=2, taus=np.array([1, 3]))


# --- elastic averaging -----------------------------------------------------------

@pytest.mark.parametrize("alpha", [0.5, 0.1, 0.9])
def test_elastic_server_average_matches_jax(alpha):
    js = jext.ElasticAveragingStrategy(tau=2, m=6, alpha=alpha)
    ts = text.ElasticAveragingStrategy(tau=2, m=6, alpha=alpha)
    jp, tp = _trees(seed=5)
    ja, ta = _trees(m=1, seed=6)
    ja = {k: v[0] for k, v in ja.items()}
    ta = {k: v[0] for k, v in ta.items()}
    jnew, janc = js.server_average(jp, anchor=ja)
    tnew, tanc = ts.server_average(tp, anchor=ta)
    _close(tnew, jnew)
    _close(tanc, janc)
    _close(ts.server_average(tp), js.server_average(jp))


def test_elastic_averaging_contracts_toward_anchor():
    s = text.ElasticAveragingStrategy(tau=2, m=4, alpha=0.5)
    _, p = _trees(m=4, seed=2)
    anchor = {k: torch.zeros(v.shape[1:]) for k, v in p.items()}
    new_p, new_anchor = s.server_average(p, anchor=anchor)
    np.testing.assert_allclose(new_p["w"].numpy(), 0.5 * p["w"].numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(new_anchor["w"].numpy(),
                               0.5 * p["w"].numpy().mean(0), atol=1e-6)


def test_elastic_repeated_rounds_reach_consensus():
    s = text.ElasticAveragingStrategy(tau=2, m=4, alpha=0.5)
    _, p = _trees(m=4, seed=3)
    anchor = {k: torch.zeros(v.shape[1:]) for k, v in p.items()}
    for _ in range(40):
        p, anchor = s.server_average(p, anchor=anchor)
    spread = float((p["w"] - p["w"].mean(0, keepdim=True)).abs().max())
    assert spread < 1e-4
