"""cna_tpu_torch's statistics ops against cna_tpu's (and scipy/numpy):
moments and medians, the Gram SVD, the F-test, the FDR machinery and the
permutations."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.special as ss
import scipy.stats as st
import torch

from cna_tpu.ops import fdr as tpu_fdr
from cna_tpu.ops import ftest as tpu_ftest
from cna_tpu.ops import linalg as tpu_linalg
from cna_tpu.ops import moments as tpu_moments
from cna_tpu_torch.ops import fdr, ftest, linalg, moments, permutations

from .torch_parity import sign_align, torch_cpu_x64  # noqa: F401

# float64 on both sides, same formulas, different libraries
RTOL = 1e-10


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def mat():
    return np.random.RandomState(0).randn(40, 7) ** 2


def test_moments_state_their_ddof(mat):
    for ddof in (0, 1):
        np.testing.assert_allclose(moments.colstd(_t(mat), ddof=ddof).numpy(),
                                   np.std(mat, axis=0, ddof=ddof), rtol=RTOL)
    np.testing.assert_allclose(
        moments.colstd(_t(mat), ddof=1).numpy(),
        pd.DataFrame(mat).std(axis=0).to_numpy(), rtol=RTOL)
    for axis in (0, 1):
        np.testing.assert_allclose(
            moments.kurtosis(_t(mat), axis=axis).numpy(),
            st.kurtosis(mat, axis=axis), rtol=RTOL)
        np.testing.assert_allclose(
            moments.standardize(_t(mat), ddof=1, axis=axis).numpy(),
            np.asarray(tpu_moments.standardize(jnp.asarray(mat), ddof=1,
                                               axis=axis)), rtol=RTOL)
    np.testing.assert_allclose(
        moments.scale_by_std(_t(mat), ddof=0).numpy(),
        mat / np.std(mat, axis=0), rtol=RTOL)


def test_r2_and_batch_kurtosis(mat):
    other = mat[::-1].copy()
    np.testing.assert_allclose(
        moments.column_r2(_t(mat), _t(other)).numpy(),
        np.asarray(tpu_moments.column_r2(jnp.asarray(mat),
                                         jnp.asarray(other))), rtol=RTOL)
    # zero padding rows beyond n_true, and a zero-variance column -> inf
    pad = np.vstack([mat, np.zeros((5, 7))])
    flat = pad.copy()
    flat[:, 3] = 0.0
    got = moments.column_r2_counted(_t(flat), _t(pad), 40).numpy()
    ref = np.asarray(tpu_moments.column_r2_counted(
        jnp.asarray(flat), jnp.asarray(pad), 40))
    assert np.isinf(got[3]) and np.isinf(ref[3])
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    ids = np.arange(40) % 5
    np.testing.assert_allclose(
        moments.batch_kurtosis(_t(mat), _t(ids), 5).numpy(),
        np.asarray(tpu_moments.batch_kurtosis(jnp.asarray(mat),
                                              jnp.asarray(ids), 5)),
        rtol=RTOL)


def test_median_and_quantile(monkeypatch):
    # torch.median would give 2.0 (the lower middle value)
    assert float(moments.median(torch.tensor([4.0, 1.0, 3.0, 2.0]))) == 2.5
    x = np.random.RandomState(1).randn(1000)
    for q in (0.2, 0.5):
        np.testing.assert_allclose(float(moments.quantile(_t(x), q)),
                                   np.quantile(x, q), rtol=1e-14)
    # the sort-based branch that serves inputs above torch.quantile's limit
    monkeypatch.setattr(moments, "_QUANTILE_MAX_ELEMENTS", 10)
    for xs in (x, x[:999]):
        for q in (0.2, 0.5):
            np.testing.assert_allclose(float(moments.quantile(_t(xs), q)),
                                       np.quantile(xs, q), rtol=1e-14)
    x[5] = np.nan
    assert np.isnan(float(moments.median(_t(x))))


def test_gram_svd_up_to_sign(mat):
    nam = np.random.RandomState(2).randn(12, 60)
    std_a, ua, sa, va = tpu_linalg.standardize_and_gram_svd(jnp.asarray(nam))
    std_b, ub, sb, vb = linalg.standardize_and_gram_svd(_t(nam))
    np.testing.assert_allclose(std_b.numpy(), np.asarray(std_a), rtol=RTOL)
    r = 11  # the centered Gram has rank S-1; its last vector is arbitrary
    np.testing.assert_allclose(sb.numpy()[:r], np.asarray(sa)[:r], rtol=RTOL)
    s = sign_align(np.asarray(ua)[:, :r], ub.numpy()[:, :r])
    np.testing.assert_allclose(ub.numpy()[:, :r] * s, np.asarray(ua)[:, :r],
                               atol=1e-10)
    np.testing.assert_allclose(vb.numpy()[:, :r] * s, np.asarray(va)[:, :r],
                               atol=1e-10)


@pytest.mark.parametrize("ridge,nb", [(0.0, 0), (10.0, 2)])
def test_residual_projector(ridge, nb):
    c = np.random.RandomState(3).randn(15, 4)
    np.testing.assert_allclose(
        linalg.residual_projector(_t(c), ridge=ridge, n_batch_cols=nb).numpy(),
        np.asarray(tpu_linalg.residual_projector(jnp.asarray(c), ridge=ridge,
                                                 n_batch_cols=nb)),
        atol=1e-12)


def test_betainc_matches_scipy():
    rng = np.random.RandomState(4)
    a = rng.uniform(0.05, 300, 4000)
    b = rng.uniform(0.05, 60, 4000)
    x = rng.uniform(0, 1, 4000)
    got = ftest.betainc(_t(a), _t(b), _t(x)).numpy()
    ref = ss.betainc(a, b, x)
    ok = ref > 1e-280  # below, both sides are subnormal round-off
    np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-11, atol=1e-15)
    edge = ftest.betainc(_t([2.0, 2.0]), _t([3.0, 3.0]), _t([0.0, 1.0]))
    assert edge.tolist() == [0.0, 1.0]


def test_f_sf_matches_scipy_and_edge_rules():
    f = np.concatenate([np.linspace(0, 40, 81), [1e3, np.inf]])
    for d1, d2 in [(1, 5), (3, 40), (10, 200), (0.5, 2.5)]:
        got = ftest.f_sf(_t(f), _t(np.full_like(f, d1)),
                         _t(np.full_like(f, d2))).numpy()
        ref = st.f.sf(f, d1, d2)
        np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-300)
    # at f = 1e-12 (x = d2/(d2+d1 f) within 1e-13 of 1) scipy itself is
    # off by ~1e-10 relative; the references are 40-digit mpmath values
    tiny = ftest.f_sf(_t([1e-12, 1e-12]), _t([1.0, 0.5]), _t([5.0, 2.5]))
    np.testing.assert_allclose(
        tiny.numpy(), [0.99999924066859265616, 0.99927857028360469004],
        rtol=1e-14)
    got = ftest.f_sf(_t([-1.0, 2.0, 2.0, 2.0]), _t([3.0, 0.0, 3.0, -1.0]),
                     _t([7.0, 7.0, 0.0, 7.0])).numpy()
    assert got[0] == 1.0  # left of the support
    assert np.isnan(got[1:]).all()  # invalid degrees of freedom
    assert ftest.f_sf(torch.tensor([2.0], dtype=torch.float32), 3.0,
                      7.0).dtype == torch.float32


def test_minp_stats_batch_matches():
    rng = np.random.RandomState(5)
    n = 30
    u, _ = np.linalg.qr(rng.randn(n, 12))
    c = rng.randn(n, 2)
    m = np.asarray(tpu_linalg.residual_projector(jnp.asarray(c)))
    y = rng.randn(n, 50)
    ks = np.array([1, 2, 3, 5, 8])
    ka, pa, ra = tpu_ftest.minp_stats_batch(jnp.asarray(u), jnp.asarray(m),
                                            jnp.asarray(y), jnp.asarray(ks), 2)
    kb, pb, rb = ftest.minp_stats_batch(_t(u), _t(m), _t(y), _t(ks), 2)
    assert np.array_equal(kb.numpy(), np.asarray(ka))
    # two continued-fraction incomplete betas: p agrees to ~1e-10 relative
    np.testing.assert_allclose(pb.numpy(), np.asarray(pa), rtol=1e-9)
    np.testing.assert_allclose(rb.numpy(), np.asarray(ra), rtol=RTOL)


@pytest.fixture(scope="module")
def coefs():
    rng = np.random.RandomState(6)
    z = rng.randn(300) * 0.3
    znull = rng.randn(300, 40) * 0.2
    return z, znull


def test_tail_counts_and_fdrs(coefs):
    z, znull = coefs
    np.testing.assert_array_equal(
        fdr.tail_counts(_t(z), _t(znull)).numpy(),
        np.asarray(tpu_fdr.tail_counts(jnp.asarray(z), jnp.asarray(znull))))
    maxc = np.abs(z).max()
    uniform = np.arange(maxc / 4, maxc, maxc / 400)
    assert fdr._uniform_spacing(uniform) is not None
    uneven = np.sort(np.abs(z))[::3]
    assert fdr._uniform_spacing(uneven) is None
    for thr in (uniform, uneven):  # fast path and general path
        np.testing.assert_allclose(
            fdr.empirical_fdrs(_t(z), _t(znull), thr).numpy(),
            np.asarray(tpu_fdr.empirical_fdrs(jnp.asarray(z),
                                              jnp.asarray(znull), thr)),
            rtol=RTOL)


def test_null_coef_tail_counts_matches_dense():
    rng = np.random.RandomState(7)
    namresid = rng.randn(20, 700)
    ycond = rng.randn(20, 30)
    coef = np.abs(namresid.T @ ycond) / 20
    t0, dt, nb = coef.max() / 4, coef.max() / 400, 300
    dense = fdr._tail_hist_uniform(_t(coef), t0, dt, nb, 1e-8, 1e-5)
    fused = fdr.null_coef_tail_counts(_t(namresid), _t(ycond), 20, t0, dt,
                                      nb, block=256)
    ref = tpu_fdr.null_coef_tail_counts(jnp.asarray(namresid),
                                        jnp.asarray(ycond), 20, t0, dt, nb,
                                        block=256)
    assert np.array_equal(fused.numpy(), dense.numpy())
    assert np.array_equal(fused.numpy(), np.asarray(ref))


def test_fwers_and_numtests(coefs):
    z, znull = coefs
    nmax = (znull ** 2).max(axis=0)
    np.testing.assert_allclose(
        fdr.empirical_fwers(_t(z), _t(nmax)).numpy(),
        np.asarray(tpu_fdr.empirical_fwers(jnp.asarray(z), jnp.asarray(nmax))),
        rtol=RTOL)
    np.testing.assert_allclose(
        fdr.minfwer_loo(_t(nmax)).numpy(),
        np.asarray(tpu_fdr.minfwer_loo(jnp.asarray(nmax))), rtol=RTOL)
    np.testing.assert_allclose(
        float(fdr.numtests(_t(nmax))),
        float(tpu_fdr.numtests(jnp.asarray(nmax))), rtol=RTOL)
    np.testing.assert_allclose(
        fdr.numtests_loo(_t(nmax)).numpy(),
        np.asarray(tpu_fdr.numtests_loo(jnp.asarray(nmax))), rtol=RTOL)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_conditional_permutation_within_batch():
    batches = np.array(["b", "a", "c", "a", "b", "c", "a", "b", "c", "a"])
    y = torch.arange(10, dtype=torch.float64) * 1.5
    out = permutations.conditional_permutation(_gen(0), batches, y, 200)
    assert out.shape == (10, 200)
    out = out.numpy()
    for b in np.unique(batches):
        rows = batches == b
        expect = np.sort(y.numpy()[rows])
        assert (np.sort(out[rows], axis=0) == expect[:, None]).all()
    # within-batch permutations are uniform: every value of batch 'a'
    # lands in every 'a' position (4 values x 4 positions, 200 draws)
    rows_a = np.flatnonzero(batches == "a")
    for pos in rows_a:
        assert set(out[pos]) == set(y.numpy()[rows_a])
    assert len({tuple(c) for c in out.T}) > 100  # columns differ


def test_grouplevel_permutation_within_donor():
    donors = np.repeat(np.arange(6), 2)
    y = torch.as_tensor(np.repeat(np.arange(6.0), 2))
    out = permutations.grouplevel_permutation(_gen(1), donors, y, 300).numpy()
    assert (out[0::2] == out[1::2]).all()  # constant within donor
    assert (np.sort(out[0::2], axis=0) == np.arange(6.0)[:, None]).all()
    # each donor's value moves to every donor over the draws
    assert all(len(set(out[2 * g])) == 6 for g in range(6))
    with pytest.raises(ValueError, match="constant within each donor"):
        permutations.grouplevel_permutation(
            _gen(2), donors, torch.arange(12, dtype=torch.float64), 5)
