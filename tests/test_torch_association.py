"""The whole slice, cna_tpu_torch against cna_tpu on the CPU in float64:
PCA -> neighbors -> association, plus the NAM entry points.

Both packages get the same numpy data (20 samples x 100 cells x 30 genes,
a planted case signal) and the same permuted phenotypes (``null_y=``):
the two random streams cannot agree, so exact comparison goes through
the injected null matrix.  The kNN runs on the PCA scores rounded to
dyadic values (``torch_parity.dyadic``), which makes the distance
expansion exact in both packages.
"""

import numpy as np
import pandas as pd
import pytest

import cna_tpu
import cna_tpu_torch as ct
from cna_tpu.tools._nam import nam_arrays as tpu_nam_arrays
from cna_tpu_torch.tools._nam import nam_arrays

from .torch_parity import dyadic, sign_align, torch_cpu_x64  # noqa: F401

# float64 end to end: NAM, coefficients, FDR curve and F-test outputs at
# rtol 1e-8 (different BLAS / reduction orders over a few diffusion
# steps, a ridge sweep and an eigendecomposition)
RTOL = 1e-8
N_SAMPLES, CELLS, GENES, NNULL = 20, 100, 30, 300
SAMPLES = [f"s{i:02d}" for i in range(N_SAMPLES)]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(1)
    case = np.arange(N_SAMPLES) >= N_SAMPLES // 2
    x = np.concatenate([
        rng.randn(CELLS, GENES) + 0.6 * c * (np.arange(GENES) < 5)
        for c in case])
    obs = pd.DataFrame({"sample": np.repeat(SAMPLES, CELLS)},
                       index=[f"c{i}" for i in range(len(x))])
    y = pd.Series(case + 0.3 * rng.randn(N_SAMPLES), index=SAMPLES)
    donor_y = pd.Series(np.repeat(rng.randn(N_SAMPLES // 2), 2),
                        index=SAMPLES)
    return dict(
        x=x, obs=obs, y=y, donor_y=donor_y,
        batches=pd.Series(np.tile(np.arange(4), 5), index=SAMPLES),
        covs=pd.DataFrame({"age": rng.randn(N_SAMPLES)}, index=SAMPLES),
        donorids=pd.Series(np.repeat(np.arange(N_SAMPLES // 2), 2),
                           index=SAMPLES))


def _graph(pkg, inputs):
    d = pkg.CellData(X=inputs["x"].copy(), obs=inputs["obs"].copy())
    pkg.pp.pca(d, n_comps=20)
    d.obsm["X_dyadic"] = dyadic(d.obsm["X_pca"])
    pkg.pp.neighbors(d, n_neighbors=10, use_rep="X_dyadic")
    return d


@pytest.fixture(scope="module")
def graphs(inputs):
    return _graph(cna_tpu, inputs), _graph(ct, inputs)


def _null(y, rng, groups=None):
    """Permuted standardized phenotypes, (n, NNULL): within groups of
    ``groups`` if given (donor-level), else across all samples."""
    ys = ((y - y.mean()) / y.std(ddof=0)).to_numpy()
    cols = []
    for _ in range(NNULL):
        if groups is None:
            cols.append(ys[rng.permutation(len(ys))])
        else:
            uniq = np.unique(groups)
            perm = dict(zip(uniq, rng.permutation(uniq)))
            first = {g: ys[np.flatnonzero(groups == g)[0]] for g in uniq}
            cols.append(np.array([first[perm[g]] for g in groups]))
    return np.stack(cols, axis=1)


CONFIGS = {
    "batches_covs": dict(batches="batches", covs="covs"),
    "donorids": dict(donorids="donorids"),
    "no_local_test": dict(local_test=False),
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_association_matches(graphs, inputs, config):
    kw = {k: (inputs[v] if isinstance(v, str) else v)
          for k, v in CONFIGS[config].items()}
    y = inputs["donor_y"] if "donorids" in kw else inputs["y"]
    groups = kw["donorids"].to_numpy() if "donorids" in kw else None
    null_y = _null(y, np.random.RandomState(11), groups)

    out = []
    for d in graphs:
        pkg = cna_tpu if d is graphs[0] else ct
        res = pkg.tl.association(d, y, "sample", Nnull=NNULL, null_y=null_y,
                                 return_full=True, **kw)
        out.append((res, d.obs.copy()))
    (ra, oa), (rb, ob) = out

    assert rb.p == ra.p and rb.k == ra.k
    assert np.array_equal(rb.kept, ra.kept)
    np.testing.assert_allclose(rb.ncorrs, ra.ncorrs, rtol=RTOL)
    np.testing.assert_allclose(rb.r2, ra.r2, rtol=RTOL)
    # two continued-fraction incomplete betas agree to ~1e-10 relative
    np.testing.assert_allclose(rb.nullminps, ra.nullminps, rtol=1e-9)
    # beta carries the arbitrary sign of each PC; align on U
    s = sign_align(ra.namresid_sampleXpc.to_numpy()[:, :ra.k],
                   rb.namresid_sampleXpc.to_numpy()[:, :rb.k])
    np.testing.assert_allclose(rb.beta * s, ra.beta, rtol=RTOL)
    np.testing.assert_allclose(rb.yresid_hat, ra.yresid_hat, rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(rb.nam.to_numpy(), ra.nam.to_numpy(),
                               rtol=RTOL)
    np.testing.assert_allclose(ob["coef"], oa["coef"], rtol=RTOL)
    if kw.get("local_test", True):
        assert np.array_equal(rb.fdrs.num_detected, ra.fdrs.num_detected)
        np.testing.assert_allclose(rb.fdrs.threshold, ra.fdrs.threshold,
                                   rtol=RTOL)
        np.testing.assert_allclose(rb.fdrs.fdr, ra.fdrs.fdr, rtol=RTOL)
        np.testing.assert_allclose(ob["coef_fdr"], oa["coef_fdr"], rtol=RTOL)
        assert (rb.fdr_5p_t is None) == (ra.fdr_5p_t is None)
    else:
        assert rb.fdrs is None and ra.fdrs is None


def test_nam_steps_and_keep_match(graphs, inputs):
    a, b = graphs
    for kw in (dict(), dict(batches=inputs["batches"]), dict(nsteps=2)):
        na, ka = tpu_nam_arrays(a, "sample", **kw)
        nb, kb = nam_arrays(b, "sample", **kw)
        assert nb.nsteps == na.nsteps
        assert np.array_equal(kb, ka)
        np.testing.assert_allclose(nb.nam.numpy(), np.asarray(na.nam),
                                   rtol=RTOL)
    dfa, _ = cna_tpu.tl.nam(a, "sample")
    dfb, _ = ct.tl.nam(b, "sample")
    pd.testing.assert_frame_equal(dfb, dfa, rtol=RTOL)


def test_svd_nam_and_diffuse_match(graphs):
    a, b = graphs
    dfa, _ = cna_tpu.tl.nam(a, "sample")
    ua, sa, va = cna_tpu.tl.svd_nam(dfa)
    ub, sb, vb = ct.tl.svd_nam(dfa)
    r = 10
    np.testing.assert_allclose(sb.to_numpy()[:r], sa.to_numpy()[:r],
                               rtol=RTOL)
    s = sign_align(ua.to_numpy()[:, :r], ub.to_numpy()[:, :r])
    np.testing.assert_allclose(ub.to_numpy()[:, :r] * s,
                               ua.to_numpy()[:, :r], atol=1e-9)
    assert list(vb.index) == list(va.index)

    s0 = pd.DataFrame(np.random.RandomState(3).rand(a.n_obs, 3),
                      index=a.obs.index)
    out_a = cna_tpu.tl.diffuse(a, s0, 3)
    out_b = ct.tl.diffuse(b, s0, 3)
    assert isinstance(out_b, pd.DataFrame)
    np.testing.assert_allclose(out_b.to_numpy(), out_a.to_numpy(), rtol=RTOL)
    steps = list(ct.tl.diffuse_stepwise(b, s0.to_numpy(), maxnsteps=2))
    np.testing.assert_allclose(steps[-1].numpy(),
                               np.asarray(list(cna_tpu.tl.diffuse_stepwise(
                                   a, s0.to_numpy(), maxnsteps=2))[-1]),
                               rtol=RTOL)


def test_association_seeded_permutations(graphs, inputs):
    """Without null_y the port draws its own permutations from a seeded
    torch.Generator: the same seed gives the same result, and the p-value
    matches cna_tpu's to within permutation noise."""
    a, b = graphs
    pa = cna_tpu.tl.association(a, inputs["y"], "sample", Nnull=NNULL, seed=0)
    pb1 = ct.tl.association(b, inputs["y"], "sample", Nnull=NNULL, seed=0)
    pb2 = ct.tl.association(b, inputs["y"], "sample", Nnull=NNULL, seed=0)
    assert pb1 == pb2
    assert abs(pb1 - pa) < 0.05 + 5 / NNULL


def test_compute_nam_and_reindex_matches(graphs, inputs):
    from cna_tpu.tools._association import check_inputs as tpu_check
    from cna_tpu.tools._association import \
        compute_nam_and_reindex as tpu_reindex
    from cna_tpu_torch.tools._association import (check_inputs,
                                                  compute_nam_and_reindex)

    y = inputs["y"].copy()
    y.iloc[3] = np.nan  # a filtered sample
    out = []
    for d, chk, fn in ((graphs[0], tpu_check, tpu_reindex),
                       (graphs[1], check_inputs, compute_nam_and_reindex)):
        batches, keep = chk(d, y, "sample", inputs["batches"], None, None,
                            False)
        out.append(fn(d, y, "sample", batches, None, None, keep, None,
                      False))
    (nam_a, kept_a, *rest_a), (nam_b, kept_b, *rest_b) = out
    assert np.array_equal(kept_b, kept_a)
    assert list(nam_b.index) == list(nam_a.index)
    pd.testing.assert_frame_equal(nam_b, nam_a, rtol=RTOL)
    for a, b in zip(rest_a, rest_b):
        assert (a is None and b is None) or a.equals(b)


def _numbers(text):
    import re

    words = re.sub(r"[-+]?(\d+\.?\d*(e[-+]?\d+)?|nan|inf)", "#", text)
    nums = [float(m.group(0)) for m in re.finditer(
        r"[-+]?(\d+\.?\d*(e[-+]?\d+)?|nan|inf)", text)]
    return words, np.array(nums)


def test_progress_output_matches(graphs, inputs, capsys):
    """The diffusion and ridge-sweep trails print the same lines."""
    texts = []
    for d, pkg in zip(graphs, (cna_tpu, ct)):
        pkg.tl.nam(d, "sample", batches=inputs["batches"], show_progress=True)
        pkg.tools._nam._resid_nam(
            pkg.tl.nam(d, "sample")[0], None, inputs["batches"],
            show_progress=True)
        texts.append(capsys.readouterr().out)
    (wa, na), (wb, nb) = map(_numbers, texts)
    assert wb == wa and "median kurtosis" in wa
    np.testing.assert_allclose(nb, na, rtol=RTOL)


def _ids_case(name):
    """(obs sample column, y, batches, covs, donorids, allow_low) of one
    ``check_inputs`` case: 12 samples of 5 cells each unless the case says
    otherwise."""
    ids = np.arange(12)
    y = pd.Series(np.linspace(0.0, 1.0, 12), index=ids)
    col = pd.Series(np.repeat(ids, 5))
    batches = covs = donorids = None
    allow = False
    if name == "float_ids":
        col, y.index = col.astype(float) + 0.5, ids + 0.5
    elif name == "str_ids":
        col, y.index = col.map("s{:02d}".format), [f"s{i:02d}" for i in ids]
    elif name == "categorical_unused":
        # unused categories count for nothing, as in set() of the column
        col = pd.Series(pd.Categorical(
            col.map("s{:02d}".format),
            categories=["zz"] + [f"s{i:02d}" for i in ids] + ["zy"]))
        y.index = [f"s{i:02d}" for i in ids]
    elif name == "y_extra_sample":
        y = pd.concat([y, pd.Series([0.5], index=[99])])  # the WARNING
    elif name == "cell_sample_missing_from_y":
        y = y.iloc[1:]
    elif name == "nan_sample_id":
        col = col.astype(float)
        col.iloc[7] = np.nan
    elif name == "nan_sample_id_str":
        col = col.map("s{:02d}".format)
        col.iloc[7] = np.nan
        y.index = [f"s{i:02d}" for i in ids]
    elif name == "nan_y":
        y.iloc[[2, 5]] = np.nan
    elif name == "nan_covariate_row":
        covs = pd.DataFrame({"age": np.arange(12.0), "sex": np.ones(12)},
                            index=ids)
        covs.iloc[4, 1] = np.nan
    elif name in ("low_sample_size", "low_sample_size_allowed"):
        y.iloc[:4] = np.nan
        allow = name.endswith("allowed")
    elif name == "batches_with_donorids":
        batches = pd.Series(ids % 3, index=ids)
        donorids = pd.Series(ids // 2, index=ids)
    elif name == "covs_with_donorids":
        covs = pd.DataFrame({"age": np.arange(12.0)}, index=ids)
        donorids = pd.Series(ids // 2, index=ids)
    elif name == "y_not_a_series":
        y = y.to_numpy()
    return col, y, batches, covs, donorids, allow


CHECK_CASES = {  # case -> what both packages must do with it
    "int_ids": None, "float_ids": None, "str_ids": None,
    "categorical_unused": None, "y_extra_sample": "WARNING",
    "cell_sample_missing_from_y": ValueError,
    "nan_sample_id": ValueError, "nan_sample_id_str": ValueError,
    "nan_y": None, "nan_covariate_row": None,
    "low_sample_size": ValueError, "low_sample_size_allowed": None,
    "batches_with_donorids": ValueError, "covs_with_donorids": "WARNING",
    "y_not_a_series": TypeError,
}


@pytest.mark.parametrize("case", list(CHECK_CASES))
def test_check_inputs_matches(case, capsys):
    """``check_inputs`` hashes the sample column once; it prints, raises and
    returns what ``cna_tpu``'s set-based version does, bit for bit."""
    from types import SimpleNamespace

    from cna_tpu.tools._association import check_inputs as tpu_check
    from cna_tpu_torch.tools._association import check_inputs

    out = []
    for chk in (tpu_check, check_inputs):
        col, y, batches, covs, donorids, allow = _ids_case(case)
        data = SimpleNamespace(obs=pd.DataFrame({"sample": col}))
        try:
            got = chk(data, y, "sample", batches, covs, donorids, allow)
        except (TypeError, ValueError) as e:
            got = (type(e), str(e))
        out.append((got, capsys.readouterr().out))
    (want, printed_want), (got, printed) = out
    assert printed == printed_want
    expect = CHECK_CASES[case]
    assert ("WARNING" in printed) == (expect == "WARNING")
    if isinstance(expect, type):
        assert want[0] is expect and got == want
        return
    for a, b in zip(got, want):
        assert a.equals(b) and a.dtype == b.dtype
        assert a.index.equals(b.index)
    if case == "nan_covariate_row":
        assert not got[1].iloc[4] and got[1].sum() == 11


def _searchsorted_write_back(kept, ncorrs, thresholds, fdr):
    """The write-back's columns as the port first computed them: a NaN
    column filled through ``.loc[kept]`` and a binary search per cell."""
    obs = pd.DataFrame(index=pd.RangeIndex(len(kept)).astype(str))
    obs["coef"] = np.nan
    obs.loc[kept, "coef"] = ncorrs
    coefs = obs["coef"].to_numpy(dtype=float)
    pos = np.searchsorted(thresholds, np.nan_to_num(np.abs(coefs), nan=-1.0),
                          side="right")
    prefix_min = np.minimum.accumulate(fdr)
    fdr_col = np.where(pos > 0, prefix_min[np.maximum(pos - 1, 0)], 1.0)
    return coefs, np.where(np.isnan(coefs), 1.0, fdr_col)


@pytest.mark.parametrize("grid", ["arange", "arange_f32_fdr", "geometric",
                                  "repeated"])
def test_write_back_bins_are_exact(grid):
    """``coef`` and ``coef_fdr`` equal the NaN-fill and searchsorted
    formula bit for bit on coefficients placed on the thresholds, one ulp
    either side, below the first, above the last, negative, and on
    non-kept cells; on a grid that is not uniform the correction loop
    keeps them exact."""
    from types import SimpleNamespace

    from cna_tpu_torch.tools._association import _write_back
    from cna_tpu_torch.utils import profiling

    rng = np.random.RandomState(5)
    maxcorr = 0.7371
    if grid.startswith("arange"):  # the entry point's grid
        th = np.arange(maxcorr / 4, maxcorr, maxcorr / 400)
    elif grid == "geometric":
        th = np.geomspace(1e-3, maxcorr, 300)
    else:  # ascending with ties
        th = np.sort(np.round(rng.uniform(0.1, maxcorr, 300), 2))
    on = th[rng.permutation(len(th))]
    c = np.concatenate([on, np.nextafter(on, np.inf), np.nextafter(on, 0),
                        [0.0, th[0] / 2, th[-1] * 2, maxcorr, 5.0],
                        rng.uniform(-1, 1, 2000)])
    c = np.concatenate([c, -c])
    kept = np.ones(len(c) + 40, bool)
    kept[rng.choice(len(kept), 40, replace=False)] = False
    fdr = rng.uniform(0, 1, len(th))
    if grid == "arange_f32_fdr":  # a float32 card's FDR curve
        fdr, c = fdr.astype(np.float32), c.astype(np.float32)
    data = SimpleNamespace(obs=pd.DataFrame(
        index=pd.RangeIndex(len(kept)).astype(str)))
    res = SimpleNamespace(ncorrs=c, fdrs=pd.DataFrame(
        {"threshold": th, "fdr": fdr}))
    prof = profiling.enable_profiling()
    try:
        with prof.phase("writeback"):
            _write_back(data, res, kept, "coef")
    finally:
        profiling.disable_profiling()
    coef, coef_fdr = _searchsorted_write_back(kept, c, th, fdr)
    assert data.obs["coef"].dtype == np.float64
    assert np.array_equal(data.obs["coef"].to_numpy(), coef, equal_nan=True)
    got = data.obs["coef_fdr"].to_numpy()
    assert got.dtype == coef_fdr.dtype and np.array_equal(got, coef_fdr)
    assert (got[~kept] == 1.0).all()
    # the arithmetic guess misses some cells that lie exactly on a
    # threshold (in float32 none does); the exact check moved them
    fixups = prof.phases[0]["fdr_bin_fixups"]
    assert fixups > 0 if c.dtype == np.float64 else fixups >= 0
