"""The comparison that decides ``correct`` has to fail: the control (the
reference in TF32 standing in for the program) and a run whose timed path
is broken underneath.  CPU at 3,000 cells; the card tests (marked
``gpu``) repeat the control at 20,000 cells on the card.

    python -m pytest cnabench/tests
    python -m pytest -p no:cacheprovider cnabench/tests -m gpu   # on a card
"""

from __future__ import annotations

import importlib
import json
import warnings
from pathlib import Path

import pytest
import torch

from cnabench import control, run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SMALL = dict(n_samples=20, cells_per_sample=150, nnull=200)
ASSOC = [w["name"] for w in BENCH["workloads"] if w["traffic"] == "assoc"]
GRAPH = [w["name"] for w in BENCH["workloads"] if w["traffic"] == "graph"]
EXACT = [w["name"] for w in BENCH["workloads"]
         if run.cell_files(BENCH, w["name"])[1]["knn_judged_rows"] == "all"]


def _run(workload, device="cpu", config=SMALL):
    warnings.filterwarnings("ignore")
    result, rows, _ = run.run_cell(BENCH, workload, 2**33 + 3, 0.3, False,
                                   device=device, config_overrides=config)
    return result, rows


@pytest.mark.parametrize("workload", ASSOC + GRAPH)
def test_control_is_not_correct(workload):
    numbers, ok = control.control_numbers(BENCH, workload, 17, "cpu", SMALL)
    assert not ok, numbers


def _step_unchanged(monkeypatch):
    from cna_tpu_torch.ops import spmm

    monkeypatch.setattr(spmm, "diffusion_step",
                        lambda s, *a, **k: s.clone())


def _half_the_nulls(monkeypatch):
    """The local test's nulls: half of them left out, the FDR counted
    over the rest."""
    from cna_tpu_torch.tools import _association as assoc

    orig = assoc._null_ycond

    def half(m_proj, y_, n_local):
        keep = max(1, n_local // 2)
        out = orig(m_proj, y_, n_local)[:, :keep]
        return torch.cat([out, out[:, : n_local - keep]], dim=1)

    monkeypatch.setattr(assoc, "_null_ycond", half)


def _answer_altered(monkeypatch):
    """One neighbourhood coefficient altered where it is produced."""
    from cna_tpu_torch.tools import _association as assoc

    orig = assoc._assoc_observed

    def altered(*a):
        out = list(orig(*a))
        ncorrs = out[7].clone()
        ncorrs[0] = ncorrs[0] + 0.01 * ncorrs.abs().max()
        out[7] = ncorrs
        return tuple(out)

    monkeypatch.setattr(assoc, "_assoc_observed", altered)


def _neighbour_altered(monkeypatch):
    """One kNN id altered where the search produces it."""
    neighbors = importlib.import_module("cna_tpu_torch.pp.neighbors")
    orig = neighbors.knn_device

    def altered(rep, k, method):
        idx, d = orig(rep, k, method)
        idx = idx.clone()
        idx[0, 1] = idx[1, 1] if idx[1, 1] != 0 else idx[2, 1]
        return idx, d

    monkeypatch.setattr(neighbors, "knn_device", altered)


def _nearest_dropped(monkeypatch):
    """The last row's nearest neighbour left out and its list filled from
    the next nearest, each with its true distance: a search that misses a
    candidate in its last tile and agrees with its own distances, which
    only a check of that row's list can see."""
    neighbors = importlib.import_module("cna_tpu_torch.pp.neighbors")
    orig = neighbors.knn_device

    def dropped(rep, k, method):
        idx, d = orig(rep, k, method)
        x = rep.to(torch.float64)
        dist = torch.sqrt(((x - x[-1]) ** 2).sum(dim=1))
        vals, ids = torch.topk(dist, k + 1, largest=False)
        keep = torch.tensor([0] + list(range(2, k + 1)))
        idx, d = idx.clone(), d.clone()
        idx[-1] = ids[keep].to(idx.dtype)
        d[-1] = vals[keep].to(d.dtype)
        return idx, d

    monkeypatch.setattr(neighbors, "knn_device", dropped)


@pytest.mark.parametrize("fault", [_step_unchanged, _half_the_nulls,
                                   _answer_altered],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("workload", ASSOC)
def test_broken_association_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result, rows = _run(workload)
    assert not result["correct"], rows


@pytest.mark.parametrize("workload", GRAPH)
def test_broken_graph_build_is_not_correct(workload, monkeypatch):
    _neighbour_altered(monkeypatch)
    result, rows = _run(workload)
    assert not result["correct"], rows


@pytest.mark.parametrize("workload", EXACT)
def test_missed_neighbour_is_not_correct(workload, monkeypatch):
    """An exact search's every list is judged, so one missed neighbour in
    the last row fails the run whatever the seed."""
    _nearest_dropped(monkeypatch)
    result, rows = _run(workload)
    assert not result["correct"], rows
    assert not dict((r[0], r[4]) for r in rows)["knn_gap"], rows


CARD = dict(n_samples=40, cells_per_sample=500, nnull=500)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ASSOC + GRAPH)
def test_card_run_is_correct_and_control_is_not(workload, card):
    result, rows = _run(workload, device=card, config=CARD)
    assert result["correct"], rows
    numbers, ok = control.control_numbers(BENCH, workload, 23, card, CARD)
    assert not ok, numbers
