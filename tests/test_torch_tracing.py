"""The spans and counters of ``cna_tpu_torch.utils.profiling``: the tree
of one association, the counters where the work happens, the profiler
switched off, the IVF spans, the benchmark's readers of them (CPU), and
the event timing on the card (``gpu``).

This file imports neither JAX nor cna_tpu; on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -m gpu
"""

import json
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import cna_tpu_torch as ct
from cna_tpu_torch.pp.ivf import ivf_knn
from cna_tpu_torch.tools import _nam
from cna_tpu_torch.utils import profiling

from .torch_parity import need_cuda, torch_cpu_x64  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ASSOC_TREE = {"association": {"check_inputs", "nam", "residualize", "test",
                              "writeback"},
              "nam": {"diffusion"},
              "test": {"observed", "null", "fdr", "collect"}}


@pytest.fixture
def profiler():
    prof = profiling.enable_profiling()
    try:
        yield prof
    finally:
        profiling.disable_profiling()


@pytest.fixture(scope="module")
def dataset():
    d, samplem = ct.data.synthetic_dataset(n_samples=20, cells_per_sample=60,
                                           n_genes=20, seed=3)
    ct.pp.pca(d, n_comps=10)
    ct.pp.neighbors(d, n_neighbors=10)
    return d, samplem["case"].astype(float)


def _children(records):
    kids = {}
    for rec in records:
        kids.setdefault(rec["parent"], []).append(rec)
    return kids


def test_association_spans_form_one_tree(dataset, profiler):
    d, y = dataset
    ct.tl.association(d, y, "id", Nnull=100, seed=1)
    recs = profiler.phases
    (root,) = [r for r in recs if r["parent"] is None]
    assert root["phase"] == "association" and root["root"] == root["id"]
    assert {r["root"] for r in recs} == {root["id"]}
    assert len({r["id"] for r in recs}) == len(recs)
    by_id = {r["id"]: r for r in recs}
    kids = _children(recs)
    for name, want in ASSOC_TREE.items():
        (rec,) = [r for r in recs if r["phase"] == name]
        assert {c["phase"] for c in kids[rec["id"]]} == want, name
    for rec in recs:
        assert rec["seconds"] == rec["host_seconds"] > 0  # no card here
        inner = kids.get(rec["id"], [])
        assert sum(c["host_seconds"] for c in inner) <= rec["host_seconds"]
        if rec["parent"] is not None:
            assert rec["host_seconds"] <= by_id[rec["parent"]]["host_seconds"]
    # the records close inside out: every child before its parent
    order = {r["id"]: i for i, r in enumerate(recs)}
    assert all(order[r["id"]] < order[r["parent"]]
               for r in recs if r["parent"] is not None)


def test_counters_are_the_steps_and_the_host_reads(dataset, profiler,
                                                   monkeypatch):
    """``steps`` is the step count ``_nam`` returns; ``host_reads`` is one
    per tensor handed to ``fetch``, ``fetch_many`` or ``scalar`` (every
    one of which pulls with ``.cpu()`` or ``.item()``)."""
    d, y = dataset
    steps = []
    real_nam = _nam._nam

    def spy_nam(*args, **kwargs):
        arrays = real_nam(*args, **kwargs)
        steps.append(arrays.nsteps)
        return arrays

    pulls = []
    real_cpu, real_item = torch.Tensor.cpu, torch.Tensor.item

    def spy_cpu(self, *args, **kwargs):
        pulls.append("cpu")
        return real_cpu(self, *args, **kwargs)

    def spy_item(self):
        pulls.append("item")
        return real_item(self)

    monkeypatch.setattr(_nam, "_nam", spy_nam)
    monkeypatch.setattr(torch.Tensor, "cpu", spy_cpu)
    monkeypatch.setattr(torch.Tensor, "item", spy_item)
    ct.tl.association(d, y, "id", Nnull=100, seed=2)
    monkeypatch.undo()
    recs = profiler.phases
    (diffusion,) = [r for r in recs if r["phase"] == "diffusion"]
    assert steps == [diffusion["steps"]] and diffusion["steps"] >= 3
    reads = sum(r.get("host_reads", 0) for r in recs)
    assert reads == len(pulls) > 0
    # the reads happen where the work is: the test's pulls in `collect`
    (collect,) = [r for r in recs if r["phase"] == "collect"]
    assert collect["host_reads"] >= 10


def test_writeback_counts_fdr_bin_fixups(dataset, profiler):
    """The write-back's span counts the cells whose arithmetic FDR bin the
    exact check moved (`fdr_bin_fixups`); without the local test there is
    no bin to find and no counter."""
    d, y = dataset
    ct.tl.association(d, y, "id", Nnull=100, seed=1)
    ct.tl.association(d, y, "id", Nnull=100, seed=1, local_test=False)
    first, second = [r for r in profiler.phases if r["phase"] == "writeback"]
    assert 0 <= first["fdr_bin_fixups"] <= d.n_obs
    assert "fdr_bin_fixups" not in second


def test_profiling_off_records_nothing():
    profiling.disable_profiling()
    prof = profiling.global_profiler()
    assert not prof.enabled
    with prof.phase("outer", cells=3):
        with prof.phase("inner"):
            profiling.count("host_reads")
            ct.utils.transfer.fetch(torch.ones(2))
            assert profiling.open_phases() == ("outer", "inner")
    assert prof.phases == []
    assert profiling.open_phases() == ()


def test_retired_session_stays_readable():
    prof = profiling.enable_profiling()
    assert profiling.last_session() is None
    with prof.phase("job"):
        profiling.count("host_reads", 3)
    profiling.disable_profiling()
    assert profiling.last_session() is prof
    assert prof.phases[0]["host_reads"] == 3
    profiling.disable_profiling()  # already off: the session stays
    assert profiling.last_session() is prof
    profiling.enable_profiling()
    assert profiling.last_session() is None
    profiling.disable_profiling()


def test_ivf_spans_have_fixed_names_and_a_u_counter(profiler, capsys):
    """The escalating search of ``tests/test_torch_ivf.py``: each search
    is one span `ivf_search`, its probe count the counter `u`."""
    x = np.random.RandomState(2).randn(3_000, 16).astype(np.float32)
    ivf_knn(x, 10, n_clusters=8, g=64, u0=1, min_recall=0.95, seed=0)
    capsys.readouterr()
    names = [r["phase"] for r in profiler.phases]
    assert not any("(" in name for name in names)
    searches = [r for r in profiler.phases if r["phase"] == "ivf_search"]
    us = [r["u"] for r in searches]
    assert len(us) >= 2 and us == sorted(us) and us[0] < us[-1]
    assert {"ivf_kmeans", "ivf_layout_host"} <= set(names)


@pytest.mark.parametrize("workload", ["bench100k.assoc", "bench100k.graph"])
def test_traced_run_reads_the_new_metrics(workload):
    """A traced CPU run of the cell at the harness tests' small size
    reads each span and counter metric listed for it above 0."""
    sys.path.insert(0, str(ROOT))
    from cnabench import run

    warnings.filterwarnings("ignore")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    small = dict(n_samples=20, cells_per_sample=150, nnull=200)
    result, _, _ = run.run_cell(bench, workload, 2**33 + 5, 0.3, True,
                                device="cpu", config_overrides=small)
    names = [m["name"] for m in bench["per_layer"]
             if m["source"] == "program_span"
             and workload in m.get("workloads", [])]
    assert len(names) >= 4
    for name in names:
        assert result["metrics"][name]["value"] > 0, name
    assert profiling.last_session() is not None


@pytest.mark.gpu
def test_span_seconds_are_the_cards_time(monkeypatch):
    """On the card a span's seconds is its CUDA event interval: the same
    as a host clock ending in a synchronize around the same work (within
    5% and 50 us), although the span itself synchronizes nothing."""
    need_cuda()
    a = torch.randn(2048, 2048, device="cuda")

    def loop():
        x = a
        for _ in range(40):
            x = (x @ a) * (1.0 / 2048)
        return x

    def host_time():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for _ in range(3):
        host_time()  # warm-up
    prof = profiling.PhaseProfiler(enabled=True)
    syncs = []
    hosts = []
    for _ in range(5):
        hosts.append(host_time())
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda *args, **kwargs: syncs.append(1))
        torch.cuda.set_sync_debug_mode("error")
        try:
            with prof.phase("loop"):
                loop()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            monkeypatch.undo()
        torch.cuda.synchronize()
    assert syncs == []
    spans = sorted(r["seconds"] for r in prof.phases)
    host = sorted(hosts)[2]
    span = spans[2]
    assert abs(span - host) <= 0.05 * host + 50e-6, (span, host)
    # the enqueue returned long before the card finished
    assert max(r["host_seconds"] for r in prof.phases) < 0.5 * span


def test_sync_audit_counts_the_host_reads_of_its_jobs():
    """``cnabench.syncs`` runs the cell's own set-up and a window of the
    jobs asked for: on the CPU PyTorch flags no synchronizing call, and
    the counted reads are those of the spans, per job."""
    sys.path.insert(0, str(ROOT))
    from cnabench import kinds, syncs

    warnings.filterwarnings("ignore")
    load = kinds.load
    small = dict(n_samples=20, cells_per_sample=150, nnull=200)
    rec = syncs.audit("bench100k.assoc", 2**33 + 7, jobs=2, device="cpu",
                      config_overrides=small)
    assert kinds.load is load
    assert rec["jobs"] == 2 and rec["correct"]
    assert rec["flagged_per_job"] == 0 and rec["sites"] == {}
    reads = sum(p.get("host_reads", 0)
                for p in profiling.last_session().phases)
    assert rec["host_reads_per_job"] == reads / 2 > 0
