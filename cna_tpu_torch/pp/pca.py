"""PCA on the device, for a dense ``X``.

Centered (not scaled) principal components via an eigendecomposition of
the gene-gene covariance: the Gram trick on the small axis, since
n_genes << n_cells in the target workloads.  The two FLOP-heavy stages
(the ``X^T X`` covariance and the score projection) are matmuls on the
device; the (G, G) eigendecomposition runs on the host in numpy, as in
the TPU package (``pp/pca.py:41-52``).

At ``n * g >= 16M`` elements ``X`` goes to the device in row chunks
(``_pca_dense_streamed``, the TPU package's ``pp/pca.py:123-159``); a
scipy sparse ``X`` is streamed in densified row chunks and never
materialized densely (``_pca_sparse``, ``pp/pca.py:69-120`` there).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import global_profiler
from ..utils.transfer import as_tensor, fetch

_PCA_DEV_KEY = "_cna_tpu_torch_pca_dev"
_STREAM_MIN_ELEMS = 16_000_000


def _cov_core(x):
    # float64 whatever x's dtype: a float32 product over 10^5 rows moves
    # the covariance by ~1e-6 of itself, which rotates the eigenvectors
    # of the near-equal noise eigenvalues by ~1e-4
    x = x.to(torch.float64)
    xc = x - x.mean(dim=0, keepdim=True)
    return (xc.T @ xc) / (x.shape[0] - 1)


def _project(x, evecs):
    xc = x - x.mean(dim=0, keepdim=True)
    return xc @ evecs


def _pca_device(x, n_comps):
    """Covariance on device, eigh on host, projection on device.

    Returns (scores_dev (N, n_comps), evals (n_comps,) np, evecs
    (G, n_comps) np, total_var float).
    """
    cov = fetch(_cov_core(x))  # (G, G): tiny pull
    evals, evecs = np.linalg.eigh(cov)
    evals = evals[::-1]
    evecs = evecs[:, ::-1]
    comps = torch.as_tensor(np.ascontiguousarray(evecs[:, :n_comps]),
                            dtype=x.dtype, device=x.device)
    scores_dev = _project(x, comps)
    return scores_dev, evals[:n_comps], evecs[:, :n_comps], float(cov.trace())


_SPARSE_PCA_MAX_GENES = 4096


def _gram_eigh(gram, colsum, n, n_comps):
    """Center the accumulated gram on the host
    (``cov = (X'X - n mu mu') / (n - 1)``) and eigendecompose it in
    float64.  Returns (mean, evals, comps (G, n_comps), total_var)."""
    gram = fetch(gram)
    mean = fetch(colsum) / n
    cov = (gram - n * np.outer(mean, mean)) / (n - 1)
    evals, evecs = np.linalg.eigh(cov)
    evals = evals[::-1]
    evecs = evecs[:, ::-1]
    comps = np.ascontiguousarray(evecs[:, :n_comps])
    return mean, evals[:n_comps], comps, float(cov.trace())


def _pca_sparse(x, n_comps, chunk_rows=65_536):
    """PCA of a scipy sparse X without ever materializing it densely.

    Streams densified row chunks (B x G, B*G bounded) through the same
    two matmul stages as the dense path: accumulate the uncentered gram
    ``X^T X`` and the column sums on the device (float64 accumulators),
    center and eigh the (G, G) covariance on the host, then project the
    chunks.  Exact: matches the dense path to rounding.  Guarded at
    ``G <= _SPARSE_PCA_MAX_GENES``: above that the (G, G) covariance
    stops being small; select genes first (the standard recipe upstream
    of PCA).

    Returns (scores_dev (N, n_comps), evals, evecs, total_var).
    """
    import scipy.sparse as sp

    from .. import config

    n, g = x.shape
    if g > _SPARSE_PCA_MAX_GENES:
        raise ValueError(
            f"sparse PCA with {g} genes needs a (G, G) covariance that is "
            "no longer small; select highly variable genes first to "
            f"reduce to <= {_SPARSE_PCA_MAX_GENES} informative genes "
            "(the standard recipe upstream of PCA)")
    x = sp.csr_matrix(x)
    dev, dtype = config.device(), config.default_float()

    def chunk(lo):
        return torch.as_tensor(x[lo:lo + chunk_rows].toarray()).to(
            device=dev, dtype=dtype)

    gram = torch.zeros((g, g), dtype=torch.float64, device=dev)
    colsum = torch.zeros((g,), dtype=torch.float64, device=dev)
    for lo in range(0, n, chunk_rows):
        blk = chunk(lo)
        gram += blk.T @ blk
        colsum += blk.sum(dim=0)
    mean, evals, comps, total_var = _gram_eigh(gram, colsum, n, n_comps)
    comps_dev = torch.as_tensor(comps, dtype=dtype, device=dev)
    shift = torch.as_tensor(mean @ comps, dtype=dtype, device=dev)
    scores_dev = torch.cat([chunk(lo) @ comps_dev - shift[None, :]
                            for lo in range(0, n, chunk_rows)])
    return scores_dev, evals, comps, total_var


def _pca_dense_streamed(x_host, n_comps, chunk_rows=131_072):
    """Dense PCA with chunked host-to-device copies.

    The same two-stage centered-gram mathematics as the TPU package's:
    accumulate the uncentered gram ``X^T X`` and the column sums over row
    chunks on the device, center on the host
    (``cov = (X'X - n mu mu') / (n - 1)``), eigh the (G, G) covariance on
    the host in float64, then project the chunks.  The chunk copies are
    asynchronous, so the matmuls of chunk i overlap the copy of chunk
    i+1; the chunks stay on the device for the projection.

    Returns (scores_dev (N, n_comps), evals, evecs, total_var).
    """
    from .. import config

    dev, dtype = config.device(), config.default_float()
    n, g = x_host.shape
    chunks = [
        torch.as_tensor(np.ascontiguousarray(x_host[lo:lo + chunk_rows]))
        .to(device=dev, dtype=dtype, non_blocking=True)
        for lo in range(0, n, chunk_rows)
    ]
    gram = torch.zeros((g, g), dtype=torch.float64, device=dev)
    colsum = torch.zeros((g,), dtype=torch.float64, device=dev)
    for blk in chunks:
        # float64 products, as in _cov_core
        blk64 = blk.to(torch.float64)
        gram += blk64.T @ blk64
        colsum += blk64.sum(dim=0)
    mean, evals, comps, total_var = _gram_eigh(gram, colsum, n, n_comps)
    comps_dev = torch.as_tensor(comps, dtype=dtype, device=dev)
    shift = torch.as_tensor(mean @ comps, dtype=dtype, device=dev)
    scores_dev = torch.cat([blk @ comps_dev - shift[None, :]
                            for blk in chunks])
    return scores_dev, evals, comps, total_var


def pca_array(x, n_comps=50):
    """Return (scores (N, n_comps), explained variance, components) as
    tensors on the configured device."""
    x = as_tensor(x)
    n_comps = min(n_comps, x.shape[1], x.shape[0])
    scores_dev, evals, evecs, _ = _pca_device(x, n_comps)
    return (scores_dev,
            torch.as_tensor(evals.copy(), device=x.device),
            torch.as_tensor(evecs.copy(), device=x.device))


def pca(data, n_comps=50, key_added="X_pca"):
    """Compute PCA of ``data.X`` into ``data.obsm[key_added]``.

    Returns the scores (a host numpy array).  Variance diagnostics are
    recorded in ``data.uns['pca']``.  The device tensor of the scores is
    cached in ``data.uns`` so the downstream kNN (``pp.neighbors``) reads
    it without a host round trip (``device_rep``).
    """
    if data.X is None:
        raise ValueError("data.X is required for PCA")
    import scipy.sparse as sp

    n, g = data.X.shape
    n_comps = min(n_comps, g, n)
    prof = global_profiler()
    with prof.phase("pca"):
        with prof.phase("pca_compute", cells=int(n)):
            if sp.issparse(data.X):
                scores_dev, variance, components, total_var = _pca_sparse(
                    data.X, n_comps)
            elif n * g >= _STREAM_MIN_ELEMS:
                scores_dev, variance, components, total_var = \
                    _pca_dense_streamed(np.asarray(data.X), n_comps)
            else:
                x = as_tensor(data.X)
                scores_dev, variance, components, total_var = _pca_device(
                    x, n_comps)
            scores = fetch(scores_dev)
        data.obsm[key_added] = scores
        data.uns[_PCA_DEV_KEY] = (scores, scores_dev,
                                  _rep_fingerprint(scores))
        data.uns["pca"] = {
            "variance": variance,
            "variance_ratio": variance / total_var,
            "components": components,
        }
    return scores


def _rep_fingerprint(arr):
    """Cheap content fingerprint of a host score array: shape, dtype, and
    a strided element sample.  Guards the device-twin cache against
    in-place mutation of ``obsm['X_pca']`` (object identity alone would
    serve a stale device copy)."""
    arr = np.asarray(arr)
    flat = arr.ravel()
    sample = flat[:: max(flat.size // 64, 1)][:64]
    return (arr.shape, str(arr.dtype), sample.tobytes())


def device_rep(data, rep):
    """The device tensor of ``rep`` if it is this ``pca``'s output (same
    object AND unchanged content), else ``rep`` itself."""
    cached = data.uns.get(_PCA_DEV_KEY)
    if cached is None or cached[0] is not rep:
        return rep
    if cached[2] == _rep_fingerprint(rep):
        return cached[1]
    return rep
