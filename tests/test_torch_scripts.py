"""The port's measurement scripts (``scripts/*_torch.py``) on the CPU at a
few thousand cells: each writes well-formed JSON, and the numbers that
do not depend on timing are held to the TPU package's functions."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from .torch_parity import torch_cpu_x64  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"


def _run(script, *args, **env):
    return subprocess.run(
        [sys.executable, str(SCRIPTS / script), *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, **env))


def _record(res, out):
    assert res.returncode == 0, res.stderr[-2000:]
    rec = json.loads(out.read_text())
    assert json.loads(res.stdout.strip().splitlines()[-1]) == rec
    return rec


def test_recall_curve_torch_cpu(tmp_path):
    from cna_tpu.pp.ivf_fine import _bucket16

    out = tmp_path / "recall.json"
    rec = _record(_run("recall_curve_torch.py", "--cpu", "--out", str(out),
                       CNA_CELLS="6000"), out)
    assert (rec["cells"], rec["k"]) == (6000, 15)
    assert rec["device"] == "cpu" and rec["timer"] == "host clock"
    u_star = rec["production"]["u"]
    assert 0 < rec["production"]["verify_recall"] <= 1
    # the grid around the production point, as the TPU script draws it
    grid = sorted({_bucket16(max(16, int(u_star * f)))
                   for f in (0.5, 0.75, 1.0, 1.5, 2.0)})
    pts = rec["curve"]
    assert [p["u"] for p in pts] == grid
    for p in pts:
        assert p["coverage"] == pytest.approx(p["u"] * 128 / 6000)
        assert 0 < p["recall"] <= 1
        assert p["total_s"] > 0 and 0 < p["search_s"] <= p["total_s"]
        assert p["launches"] == {}  # the plain scorer on the CPU
    # more probes never lose recall on one index and one truth sample
    recalls = [p["recall"] for p in pts]
    assert recalls == sorted(recalls)
    assert rec["index_build_s"] > 0 and rec["truth_s"] > 0


def test_halo_scaling_torch_cpu_equals_tpu_package(tmp_path):
    """Ghost fractions, bytes, rounds and padded areas of the script's
    plans equal those of the TPU package's partition and plan on the same
    graph and the same clusters; a second run loads the cached graph and
    gives the same plans."""
    import cna_tpu.graph.partition as tpu_partition
    from cna_tpu.graph.reorder import \
        permute_graph_unsorted as tpu_permute
    from cna_tpu.parallel.halo import build_halo_plan_csr as tpu_plan

    import scipy.sparse as sp

    from cna_tpu_torch.graph.partition import (embedding_clusters,
                                               partition_clusters)

    env = {"CNA_BENCH_CELLS": "4000", "CNA_BENCH_SAMPLES": "20"}
    cache = tmp_path / "graph.npz"
    outs = [tmp_path / "halo1.json", tmp_path / "halo2.json"]
    recs = [_record(_run("halo_scaling_torch.py", "--cpu", "--cache",
                         str(cache), "--out", str(o), **env), o)
            for o in outs]
    assert [r["graph"]["how"] for r in recs] == ["built", "loaded"]
    z = np.load(cache)
    conn = sp.csr_matrix((z["data"], z["indices"], z["indptr"]),
                         shape=tuple(z["shape"]))
    assert recs[0]["workload"]["cells"] == conn.shape[0] == 4000
    cid = embedding_clusters(z["x_pca"], partition_clusters(4000, 32))
    keys = ("ghost_fraction", "ghost_bytes_per_step",
            "padded_bytes_per_step", "allgather_bytes_per_step",
            "exchange_rounds", "local_padded_area")
    for rec in recs:
        assert [r["n_shards"] for r in rec["scaling"]] == [2, 4, 8, 16, 32]
        for row in rec["scaling"]:
            d = row["n_shards"]
            order = tpu_partition.partition_ordering(conn, z["x_pca"], d,
                                                     cid=cid)
            plan = tpu_plan(tpu_permute(conn, order), d)
            stats = plan.exchange_stats(20, 4)
            want = dict(zip(keys, (
                stats["ghost_fraction"], stats["ghost_bytes"],
                stats["padded_bytes"], stats["allgather_bytes"],
                stats["rounds"], plan.padded_area())))
            assert {k: row[k] for k in keys} == pytest.approx(want), d
            assert ("measured_step_s" in row) == (d <= 8)
            assert row.get("measured_step_s", 1.0) > 0


def test_umap_profile_torch_cpu(tmp_path):
    import shutil

    out = tmp_path / "umap.json"
    res = _run("umap_profile_torch.py", "--cpu", "--out", str(out),
               CNA_UMAP_CELLS="3000", CNA_UMAP_EPOCHS="4")
    rec = _record(res, out)
    assert rec["cells"] == 3000 and rec["edges"] > 3000
    assert rec["init"] == "spectral" and rec["auto_init"] == "spectral"
    assert rec["default_epochs"] == 500 and rec["probe_epochs"] == 4
    assert sum(n for _, n in rec["period_groups"]) == rec["edges"]
    for key in ("graph_build_s", "edge_prep_s", "spectral_init_s",
                "probe_warm_s", "probe_warm_4x_s"):
        assert rec[key] > 0, key
    host = rec["host_baseline"]
    if shutil.which("g++") is None:
        assert host is None and "g++ not found" in res.stderr
    else:
        assert host["epochs"] == 3 and host["seconds"] >= 0


@pytest.mark.parametrize("script,env", [
    ("recall_curve_torch.py", {"CNA_CELLS": "2000"}),
    ("umap_profile_torch.py", {"CNA_UMAP_CELLS": "2000"}),
    ("halo_scaling_torch.py", {"CNA_BENCH_CELLS": "2000"}),
])
def test_scripts_without_cpu_need_the_card(script, env):
    """Without ``--cpu`` a script computes on the card and stops where
    there is none; it does not carry on on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the script runs on it")
    res = _run(script, **env)
    assert res.returncode != 0
    assert "set_device('cpu')" in res.stderr
    assert res.stdout.strip() == ""
