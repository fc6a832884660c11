"""NAM savepoints: optional checkpoint/resume.

The reference deliberately recomputes the NAM on every ``association``
call (its v0.2.0 release REMOVED caching — reference README.md:22), so
caching is **off by default** to match that semantics.  For 10k-
permutation reruns on atlas-scale data, recomputing diffusion is pure
waste, so an explicit savepoint API is provided: the NAM (and its QC
mask) is stored keyed on a fingerprint of (graph structure+weights,
sample assignment, nsteps, self_weight) — a changed input silently
misses rather than serving a stale matrix.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np


def _graph_fingerprint(conn, sid_codes, nsteps, self_weight) -> str:
    import scipy.sparse as sp

    from ..graph.device import DeviceConnectivities

    h = hashlib.sha256()
    if isinstance(conn, DeviceConnectivities):
        # device graph: hash its cheap on-device content summary instead
        # of materializing/pulling the (N, K) arrays
        for part in conn.content_digest():
            h.update(part)
    elif sp.issparse(conn):
        csr = conn.tocsr()
        h.update(np.ascontiguousarray(csr.indptr))
        h.update(np.ascontiguousarray(csr.indices))
        h.update(np.ascontiguousarray(csr.data))
    else:
        h.update(np.ascontiguousarray(np.asarray(conn)))
    h.update(np.ascontiguousarray(sid_codes))
    h.update(repr((nsteps, self_weight)).encode())
    return h.hexdigest()[:32]


def nam_fingerprint(data, sid_name, nsteps=None, self_weight=1) -> str:
    """Content fingerprint of everything the NAM depends on."""
    from ..tools._nam import get_connectivity

    conn = get_connectivity(data)
    codes = data.obs[sid_name].astype("category").cat.codes.to_numpy()
    return _graph_fingerprint(conn, codes, nsteps, self_weight)


def _index_array(index):
    """Index -> a pickle-free numpy array (numeric kept; else unicode)."""
    arr = np.asarray(index)
    if arr.dtype == object:
        arr = arr.astype(str)
    return arr


def save_nam(path, nam_df, fingerprint: str, keep=None, nsteps=0) -> None:
    """Persist a (pre-QC) NAM DataFrame under its fingerprint.

    Only the diffusion output is stored — the batch-kurtosis QC depends
    on the batches argument and is cheap, so it is recomputed on load.
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez_compressed(
        path,
        fingerprint=np.asarray(fingerprint),
        nam=nam_df.to_numpy(),
        samples=_index_array(nam_df.index),
        cells=_index_array(nam_df.columns),
        keep=np.asarray(keep if keep is not None else []),
        nsteps=np.asarray(nsteps),
    )


def load_nam(path, fingerprint: str):
    """Load a savepoint if it exists AND matches the fingerprint.

    Returns (NAM DataFrame, keep-or-None, nsteps) or None on miss/mismatch.
    """
    import pandas as pd

    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        if str(z["fingerprint"]) != fingerprint:
            return None
        nam = pd.DataFrame(z["nam"], index=pd.Index(z["samples"]),
                           columns=pd.Index(z["cells"]))
        keep = z["keep"] if z["keep"].size else None
        nsteps = int(z["nsteps"])
    return nam, keep, nsteps
