"""The cell ``tb500k.assoc`` at a tiny size of ``tb_500k`` on the CPU: the
kind runs, its three metric readers read, and a run whose batch path is
broken underneath reads ``correct`` false (the sweep skipped to ridge 0,
the QC skipped, the covariates dropped).  The program runs in float64
here, so the comparison is the reference's own arithmetic twice and the
cell's limits (set at full size in float32) hold a sound run easily.

    python -m pytest cnabench/tests/test_tb_assoc.py
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path

import numpy as np
import pytest

from cnabench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "tb500k.assoc"
# 60 samples in 12 batches of 50 cells on average: the QC drops about a
# tenth of the neighbourhoods and the sweep stops at its first ridge, so
# that skipping either changes the answer
TINY = dict(n_samples=60, n_batches=12, n_cells=3000, min_cells=20,
            nnull=200, batch_offset=0.3)
NEW = ("assoc.batch_qc_s", "assoc.ridge_sweep_s", "assoc.ridge_step_s")


@pytest.fixture
def x64():
    import cna_tpu_torch as ct

    ct.config.enable_x64(True)
    try:
        yield
    finally:
        ct.config.enable_x64(False)


def _run(trace=False):
    warnings.filterwarnings("ignore")
    return run.run_cell(BENCH, CELL, 2**33 + 5, 0.3, trace, device="cpu",
                        config_overrides=TINY)


def test_tiny_run_is_correct_and_reads_the_batch_metrics(x64):
    result, rows, numbers = _run(trace=True)
    assert result["correct"], rows
    for name in NEW:
        assert result["metrics"][name]["value"] > 0, name
    assert numbers["qc_flip"] == 0 and numbers["ridge_steps_diff"] == 0


def _sweep_skipped(monkeypatch):
    """The ridge sweep's schedule cut to ridge 0: the exact projector at
    once."""
    from cna_tpu_torch.tools import _nam

    monkeypatch.setattr(_nam, "_DEFAULT_RIDGES", (0.0,))


def _qc_skipped(monkeypatch):
    """Every neighbourhood kept, whatever its batch kurtosis."""
    from cna_tpu_torch.tools import _nam

    monkeypatch.setattr(
        _nam, "_qc_nam_arrays",
        lambda arrays, batches, show_progress=False: (
            arrays, np.ones(arrays.nam.shape[1], dtype=bool)))


def _covariates_dropped(monkeypatch):
    """The residualization run on the batches alone."""
    from cna_tpu_torch.tools import _association

    orig = _association._resid_nam
    monkeypatch.setattr(
        _association, "_resid_nam",
        lambda nam, covs, batches, **kw: orig(nam, None, batches, **kw))


@pytest.mark.parametrize("fault", [_sweep_skipped, _qc_skipped,
                                   _covariates_dropped],
                         ids=lambda f: f.__name__.strip("_"))
def test_broken_batch_path_is_not_correct(fault, x64, monkeypatch):
    fault(monkeypatch)
    result, rows, _ = _run()
    assert not result["correct"], rows
