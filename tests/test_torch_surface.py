"""cna_tpu_torch's package boundary: what it imports, its namespace, its
device policy and the paths that are not ported yet."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import cna_tpu_torch as ct
from cna_tpu_torch import config
from cna_tpu_torch.ops import _build

from .torch_parity import torch_cpu_x64  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "cna_tpu_torch"


def test_import_pulls_in_neither_jax_nor_cna_tpu():
    """Nor, at import, the packages that only some paths need: h5py (the
    h5ad files), matplotlib (``pl``) and scipy.optimize (``pp.umap``)."""
    code = ("import sys, cna_tpu_torch, cna_tpu_torch.ops.knn, "
            "cna_tpu_torch.ops.ivf, cna_tpu_torch.pp.ivf_fine, "
            "cna_tpu_torch.graph.device, cna_tpu_torch.graph.blocks, "
            "cna_tpu_torch.ops.spmm_banded, cna_tpu_torch.tools._stats, "
            "cna_tpu_torch.utils.checkpoint, "
            "cna_tpu_torch.utils.multisample, cna_tpu_torch.utils.checks, "
            "cna_tpu_torch.data.io_h5ad, cna_tpu_torch.pp.hvg, "
            "cna_tpu_torch.pp.umap, cna_tpu_torch.plotting._umap, "
            "cna_tpu_torch.plotting._strat; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'cna_tpu', 'h5py', 'matplotlib') "
            "or m.startswith('scipy.optimize')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_name_neither_jax_nor_cna_tpu():
    files = [*PKG.rglob("*.py"), *PKG.rglob("*.cu"), ROOT / "chip_smoke.py"]
    assert len(files) > 20
    pattern = re.compile(r"\bjax\b|cna_tpu\.", re.IGNORECASE)
    hits = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
            for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert not hits, "\n".join(hits)


def test_namespace_mirrors_the_tpu_package():
    for name in ("association", "nam", "svd_nam", "diffuse",
                 "diffuse_stepwise", "CellData", "read_h5ad", "tl", "pl",
                 "ut", "config"):
        assert hasattr(ct, name), name
    for name in ("association", "nam", "svd_nam", "diffuse",
                 "diffuse_stepwise", "set_graph_format"):
        assert callable(getattr(ct.tl, name)), name
    for name in ("select_hvg", "pca", "pca_array", "knn_search", "ivf_knn",
                 "neighbors", "fuzzy_connectivities", "umap"):
        assert callable(getattr(ct.pp, name)), name
    for name in ("umap_ncorr", "umap_overlay", "violinplot"):
        assert callable(getattr(ct.pl, name)), name
    for name in ("read_h5ad", "write_h5ad", "synthetic_dataset"):
        assert callable(getattr(ct.data, name)), name
    assert callable(ct.CellData.write) and ct.read_h5ad is ct.data.read_h5ad
    for name in ("precision", "current_precision", "spmm_dtype",
                 "enable_debug_nans", "enable_compilation_cache",
                 "warmup_transfers_async"):
        assert callable(getattr(config, name)), name
    assert config.Precision(x64=True).float == torch.float64
    assert callable(ct.ut.checks.checkify_float_checks)
    for name in ("graph_from_numpy", "sorted_ext_graph_from_numpy",
                 "fine_index_from_numpy", "banded_graph_from_numpy",
                 "block_graph_from_numpy", "hybrid_graph_from_numpy",
                 "obs_to_sample"):
        assert callable(getattr(ct.ut, name)), name
    for name in ("conditional_permutation", "grouplevel_permutation",
                 "tail_counts", "empirical_fdrs"):
        assert callable(getattr(ct.tl._stats, name)), name
    assert ct.association is ct.tl.association


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid")
    try:
        config.set_device(None)
        with pytest.raises(RuntimeError, match="set_device\\('cpu'\\)"):
            config.device()
        d = ct.CellData(X=np.random.RandomState(0).randn(30, 4))
        with pytest.raises(RuntimeError, match="CUDA"):
            ct.pp.pca(d, n_comps=2)
    finally:
        config.set_device("cpu")
    assert config.device() == torch.device("cpu")


def test_precision_policy_and_tf32_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert config.default_float() == torch.float64
    try:
        config.enable_x64(False)
        assert config.default_float() == torch.float32
        assert ct.ut.transfer.as_tensor(np.zeros(2)).dtype == torch.float32
        assert ct.ut.transfer.as_tensor(np.zeros(2, np.int64)).dtype \
            == torch.float32
    finally:
        config.enable_x64(True)
    assert ct.ut.transfer.as_tensor(np.zeros(2)).dtype == torch.float64
    assert ct.ut.transfer.as_tensor(np.zeros(2, np.float32)).dtype \
        == torch.float32


def test_runtime_checks_switch():
    from cna_tpu_torch.utils import checks

    with pytest.raises(FloatingPointError, match="'ncorrs'"):
        checks.assert_finite(p=0.5, ncorrs=np.array([0.1, np.nan]))
    try:
        config.enable_runtime_checks(False)
        checks.assert_finite(ncorrs=np.array([np.inf]))
    finally:
        config.enable_runtime_checks(True)
    assert checks.runtime_checks_enabled()


def test_profiler_phases_and_trace(tmp_path):
    from cna_tpu_torch.utils import profiling

    prof = profiling.PhaseProfiler(enabled=True, trace_dir=str(tmp_path))
    with prof.trace():
        with prof.phase("job"):
            with prof.phase("matmul", cells=100):
                torch.randn(64, 64) @ torch.randn(64, 64)
                prof.count("host_reads", 2)
    inner, outer = prof.phases
    assert inner["phase"] == "matmul" and inner["cells"] == 100
    assert inner["host_reads"] == 2 and "host_reads" not in outer
    assert outer["phase"] == "job" and outer["parent"] is None
    assert inner["parent"] == outer["id"] != inner["id"]
    assert inner["root"] == outer["root"] == outer["id"]
    assert 0 < inner["host_seconds"] <= outer["host_seconds"]
    assert inner["seconds"] > 0 and outer["seconds"] > 0
    assert not any(key.endswith("_per_s") for key in inner)
    assert not hasattr(prof, "report")
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert {"job", "matmul"} <= {e.get("name") for e in events}


def _demo():
    rng = np.random.RandomState(0)
    x = rng.randn(240, 6)
    sids = np.repeat([f"s{i}" for i in range(12)], 20)
    d = ct.CellData(X=x, obs=pd.DataFrame({"sample": sids}))
    ct.pp.pca(d, n_comps=4)
    ct.pp.neighbors(d, n_neighbors=5)
    y = pd.Series(np.arange(12.0), index=[f"s{i}" for i in range(12)])
    return d, y


def test_unported_paths_raise_not_implemented():
    """The several-device paths that once raised NotImplementedError now
    run through the public entry points (``mesh=``, ``devices=``); an
    unknown format is still a ValueError."""
    d, y = _demo()
    with pytest.raises(ValueError, match="unknown graph format"):
        ct.tl.set_graph_format(d, "csr")
    mesh = ct.parallel.make_mesh(["cpu"] * 4, perms=2)
    p_single = ct.tl.association(d, y, "sample", Nnull=50, seed=1)
    assert ct.tl.association(d, y, "sample", Nnull=50, seed=1,
                             mesh=mesh) == p_single
    assert d.uns["_cna_tpu_torch_diffusion_path"] == "halo"
    arrays, keep = ct.tools._nam.nam_arrays(d, "sample", mesh=mesh)
    assert arrays.nam.shape == (12, d.n_obs) and keep.all()
    nam_df, _ = ct.tl.nam(d, "sample", mesh=mesh)
    assert nam_df.shape == (12, d.n_obs)
    idx, dist = ct.pp.ivf_knn(d.obsm["X_pca"], 5, devices=["cpu", "cpu"])
    assert idx.shape == dist.shape == (d.n_obs, 5)


@pytest.mark.parametrize("fmt", ["block", "hybrid", "banded"])
def test_locality_formats_run_end_to_end(fmt):
    d, y = _demo()
    p_default = ct.tl.association(d, y, "sample", Nnull=50, seed=1)
    ct.tl.set_graph_format(d, fmt)
    assert d.uns[ct.tools._nam._FORMAT_KEY] == fmt
    p_fmt = ct.tl.association(d, y, "sample", Nnull=50, seed=1)
    assert p_fmt == p_default  # same graph, same permutations
    graph, order = ct.tools._nam.get_device_graph(d)
    assert type(graph).__name__ == {"block": "BlockGraph",
                                    "hybrid": "HybridGraph",
                                    "banded": "BandedGraph"}[fmt]
    assert sorted(order.perm) == list(range(d.n_obs))


def test_nam_savepoint_and_sparse_pca_work(tmp_path):
    d, y = _demo()
    path = tmp_path / "nam.npz"
    p_plain = ct.tl.association(d, y, "sample", Nnull=50, seed=1)
    p_saved = ct.tl.association(d, y, "sample", Nnull=50, seed=1,
                                nam_savepoint=str(path))
    assert path.exists() and p_saved == p_plain
    assert ct.tl.association(d, y, "sample", Nnull=50, seed=1,
                             nam_savepoint=str(path)) == p_plain
    sparse = ct.CellData(X=sp.random(50, 8, density=0.3, format="csr",
                                     random_state=0))
    scores = ct.pp.pca(sparse, n_comps=3)
    assert scores.shape == (50, 3) and np.isfinite(scores).all()
    assert sp.issparse(sparse.X)


def test_ivf_neighbors_run_end_to_end():
    d, y = _demo()
    p_exact = ct.tl.association(d, y, "sample", Nnull=50, seed=1)
    ct.pp.neighbors(d, n_neighbors=5, method="ivf")
    assert d.uns["neighbors"]["params"]["knn_method_resolved"] == "ivf"
    assert type(d.obsp["connectivities"]).__name__ == "DeviceConnectivities"
    p_ivf = ct.tl.association(d, y, "sample", Nnull=50, seed=1)
    # 240 cells are two fine blocks, both probed: the exact lists
    assert p_ivf == p_exact
    for fmt in ("ell", "bucketed"):  # a device graph serves both formats
        ct.tl.set_graph_format(d, fmt)
        assert ct.tl.association(d, y, "sample", Nnull=50, seed=1) == p_ivf


def test_ell_format_end_to_end():
    d, y = _demo()
    p_bucketed = ct.tl.association(d, y, "sample", Nnull=50, seed=1)
    ct.tl.set_graph_format(d, "ell")
    p_ell = ct.tl.association(d, y, "sample", Nnull=50, seed=1)
    assert p_ell == p_bucketed  # same graph, same permutations


def test_launch_counts_reset():
    _build.count_launch("example")
    assert _build.launch_counts()["example"] >= 1
    ct.ops.reset_launch_counts()
    assert ct.ops.launch_counts() == {}


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No silent fallback: without the CUDA toolkit the build raises."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    for name in _build.KERNELS:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build(name)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert sorted(f.stem for f in _build.CSRC.glob("*.cu")) \
        == sorted(_build.KERNELS)


def test_library_name_follows_the_source_and_its_own_headers(monkeypatch,
                                                             tmp_path):
    """An edited header rebuilds the kernels that include it, directly or
    through another header, and no other."""
    (tmp_path / "a.cu").write_text('#include <cstdint>\n#include "t.cuh"\n')
    (tmp_path / "b.cu").write_text("// includes nothing of csrc\n")
    (tmp_path / "t.cuh").write_text('  #  include "u.cuh"\n')
    (tmp_path / "u.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build._sources("a")] == ["a.cu", "t.cuh",
                                                      "u.cuh"]
    assert [p.name for p in _build._sources("b")] == ["b.cu"]
    before = {name: _build._target(name) for name in "ab"}
    (tmp_path / "u.cuh").write_text("// v2\n")
    assert _build._target("a") != before["a"]
    assert _build._target("b") == before["b"]


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    res = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert res.returncode != 0 and '"ok"' not in res.stdout
