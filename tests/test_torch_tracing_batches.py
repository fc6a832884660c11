"""The spans and counters of the batch path (CPU): ``batch_qc`` (counter
``dropped``) under ``nam`` and ``ridge_sweep`` (counter ``ridges``) under
``residualize``, in the tree of one association; their counts are the
plain reference's; the one-batch path opens neither span (no QC runs and
no ridge is swept there, so there is nothing to count)."""

import warnings

import pytest

import cna_tpu_torch as ct
from cna_tpu_torch.utils import profiling
from plain_reference import cna_batches as ref

from .torch_atlas import batch_atlas, sample_codes
from .torch_parity import torch_cpu_x64  # noqa: F401


def _traced(d, y, **kw):
    prof = profiling.enable_profiling()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ct.tl.association(d, y, "id", return_full=True, **kw)
    finally:
        profiling.disable_profiling()
    return prof.phases


@pytest.mark.parametrize("offset", [0.3, 0.6], ids=["drops", "sweeps"])
def test_batch_spans_sit_in_the_job_tree_and_count_the_reference(offset):
    x, obs, y, batches, covs, nulls = batch_atlas(0, offset=offset)
    d = ct.CellData(X=x, obs=obs)
    ct.pp.pca(d, n_comps=10)
    ct.pp.neighbors(d, n_neighbors=10)
    recs = _traced(d, y, batches=batches, covs=covs, Nnull=nulls.shape[1],
                   null_y=nulls)
    by_id = {r["id"]: r for r in recs}
    (root,) = [r for r in recs if r["parent"] is None]
    (qc,) = [r for r in recs if r["phase"] == "batch_qc"]
    (sweep,) = [r for r in recs if r["phase"] == "ridge_sweep"]
    assert by_id[qc["parent"]]["phase"] == "nam"
    assert by_id[sweep["parent"]]["phase"] == "residualize"
    assert qc["root"] == sweep["root"] == root["id"]
    assert qc["host_seconds"] > 0 and sweep["host_seconds"] > 0

    nam, _ = ref.diffuse(d.obsp["connectivities"], sample_codes(obs, y),
                         len(y))
    want = ref.association(nam, y.to_numpy(), batches.to_numpy(),
                           covs.to_numpy(), nulls)
    assert qc["dropped"] == int((~want["qc_keep"]).sum())
    assert sweep["ridges"] == want["steps"] >= 1
    assert (qc["dropped"] > 0) == (offset == 0.3)
    assert (sweep["ridges"] >= 3) == (offset == 0.6)


def test_one_batch_opens_no_batch_span():
    x, obs, y, _, covs, nulls = batch_atlas(0, offset=0.3)
    d = ct.CellData(X=x, obs=obs)
    ct.pp.pca(d, n_comps=10)
    ct.pp.neighbors(d, n_neighbors=10)
    recs = _traced(d, y, covs=covs, Nnull=nulls.shape[1], null_y=nulls)
    names = {r["phase"] for r in recs}
    assert {"nam", "residualize"} <= names
    assert not names & {"batch_qc", "ridge_sweep"}
    assert not any("dropped" in r or "ridges" in r for r in recs)
