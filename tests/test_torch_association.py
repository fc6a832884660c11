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
