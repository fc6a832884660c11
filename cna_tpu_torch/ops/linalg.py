"""Small-matrix linear algebra for the NAM pipeline.

Everything on the sample axis (S = tens to hundreds) is tiny; it stays on
the device next to the big cell-axis tensors.

Covers the reference's:
* Gram-trick SVD of the standardized NAM (``_nam.py:102-115``), via
  ``eigh`` of the symmetric S x S Gram instead of ``np.linalg.svd``.
* Residualizing projector ``M = I - C (C'C + lam L)^-1 C'``
  (``_nam.py:133,146``).
"""

from __future__ import annotations

import torch

from . import moments


def gram_svd(nam_std):
    """Eigen-trick SVD of an S x C column-standardized matrix.

    Mirrors reference ``svd_nam`` (``_nam.py:102-115``) post-standardization:
    ``U, svs, _ = svd(NAM @ NAM.T)``; ``V = NAM.T @ U / sqrt(svs)``.
    ``svs`` are the **squared** singular values of NAM (eigenvalues of the
    Gram matrix), sorted descending.  Eigenvector signs are arbitrary (as
    they are in the reference); all downstream statistics are invariant.

    Returns (U (S,S), svs (S,), V (C,S)).
    """
    gram = nam_std @ nam_std.T
    evals, evecs = torch.linalg.eigh(gram)
    # eigh is ascending -> flip to descending to match svd ordering; the
    # centered Gram is rank-deficient (rank <= S-1) and its null-space
    # eigenvalue can round negative: take |.| as np.linalg.svd does
    svs = torch.abs(evals.flip(0))
    u = evecs.flip(1)
    v = nam_std.T @ u / torch.sqrt(svs)[None, :]
    return u, svs, v


def standardize_and_gram_svd(nam):
    """Center + standardize columns (pandas ddof=1 convention, reference
    ``_nam.py:103-104``), then Gram SVD.  Returns (nam_std, U, svs, V)."""
    nam_std = moments.standardize(nam, ddof=1, axis=0)
    u, svs, v = gram_svd(nam_std)
    return nam_std, u, svs, v


def residual_projector(c, ridge=0.0, n_batch_cols=0):
    """Projector removing the column space of covariates ``c`` (n, r).

    ``M = I - C (C'C + ridge * n * L)^-1 C'`` where ``L`` selects the first
    ``n_batch_cols`` columns (the batch dummies) for ridge penalization:
    reference ``_nam.py:145-146``.  With ridge=0 / no batch columns this is
    the exact OLS annihilator (``_nam.py:133``).
    """
    n, r = c.shape
    eye = torch.eye(n, dtype=c.dtype, device=c.device)
    if r == 0:
        return eye
    gram = c.T @ c
    if n_batch_cols > 0:
        l_diag = torch.cat([
            torch.ones(n_batch_cols, dtype=c.dtype, device=c.device),
            torch.zeros(r - n_batch_cols, dtype=c.dtype, device=c.device)])
        gram = gram + ridge * n * torch.diag(l_diag)
    sol = torch.linalg.solve(gram, c.T)
    return eye - c @ sol
