"""CPU tests of the benchmark's harness: every cell resolves to its files,
the frozen data recipe, the roofline counts, the trace reader, and no JAX
after a run.  ``python -m pytest cnabench/tests``."""

from __future__ import annotations

import json
import re
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from cnabench import control, kinds, metrics, roofline, run, trace
from cnabench.data import synth

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SMALL = dict(n_samples=20, cells_per_sample=150, nnull=200)


@pytest.mark.parametrize("cell", BENCH["workloads"],
                         ids=lambda c: c["name"])
def test_every_workload_resolves(cell):
    c, config, traffic, limits = run.cell_files(BENCH, cell["name"])
    assert kinds.load(traffic["job"]).name == traffic["job"]
    assert config["knn_judged_rows"] == "all" or \
        config["knn_judged_rows"] >= 1
    assert control.control_precision(config).name == "tf32"
    assert limits["numbers"]
    for lim in limits["numbers"].values():
        assert set(lim) in ({"max"}, {"min"})
    for trace_on in (False, True):
        entries = run.cell_metrics(BENCH, cell["name"], trace_on)
        assert entries, "every cell reports metrics of both kinds"
        for m in entries:
            assert callable(metrics.load(m["name"]).read)
            if m["name"].endswith("_roofline"):
                mod = roofline.load(m["name"][: -len("_roofline")])
                assert mod.TARGETS and callable(mod.count)
    names = [m["name"] for m in run.cell_metrics(BENCH, cell["name"], False)]
    assert "setup_s" in names and len(names) >= 2


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for entry in (BENCH["configs"] + BENCH["workloads"]
                  + BENCH["end_to_end"] + BENCH["per_layer"]):
        assert NAME.match(entry["name"]), entry["name"]
        names.add(entry["name"])
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists()
        assert c["file"].startswith(BENCH["paths"][0] + "/")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"]
    chips4 = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert chips4 <= max(1, len(BENCH["workloads"]) // 4)


def test_frozen_recipe_matches_the_package():
    from cna_tpu_torch.data import synthetic_dataset

    for seed in (0, 7, 2**32 - 1):
        x, obs, samplem = synth.archetypes(12, 40, n_genes=30, seed=seed)
        d, sm = synthetic_dataset(n_samples=12, cells_per_sample=40,
                                  n_genes=30, seed=seed)
        np.testing.assert_array_equal(x, d.X)
        assert obs.equals(d.obs)
        assert samplem.equals(sm)


def test_seed_words_take_large_seeds():
    a = kinds.seed_words(2**33 + 5, 4)
    assert a == kinds.seed_words(2**33 + 5, 4)
    assert a != kinds.seed_words(2**33 + 6, 4)
    assert all(0 <= v < 2**32 for v in a)


def test_knn_exact_count_by_hand():
    mod = roofline.load("knn_exact")
    x = torch.zeros((1000, 20))
    flops, nbytes = mod.count((x, 15), {})()
    assert flops == 2.0 * 1000 * 1000 * 20
    assert nbytes == 4.0 * 1000 * 20 + 8.0 * 1000 * 15


def test_ivf_score_count_by_hand():
    mod = roofline.load("ivf_score")
    g, d_pad = 4, 8
    x4 = torch.zeros((3, g, d_pad))
    x4[:, :, :5] = 1.0  # 5 live coordinates
    counts = torch.tensor([4, 2, 0], dtype=torch.int32)
    csum = torch.tensor([0, 4, 6], dtype=torch.int32)
    sel = torch.tensor([0, 1], dtype=torch.int32)
    probes = torch.tensor([[0, 1], [1, 2]], dtype=torch.int32)
    flops, nbytes = mod.count((x4, sel, probes, counts, csum, 3),
                              dict(g=g, q_blocks=1))()
    # slot 0: 4 rows x (4 + 2) candidates; slot 1: 2 rows x (2 + 0)
    assert flops == 2.0 * (4 * 6 + 2 * 2) * 5
    assert nbytes == 4.0 * x4.numel() + 4.0 * (2 + 4 + 6) + 8.0 * 2 * g * 3


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_roofline_share_against_the_peak():
    launch = (lambda: (989e12 * 0.5, 0.0), _Event(0.0), _Event(1000.0))
    h100 = "NVIDIA H100 80GB HBM3"
    assert roofline.share([launch], h100) == pytest.approx(50.0)
    launch = (lambda: (0.0, 3.35e12 * 0.25), _Event(0.0), _Event(1000.0))
    assert roofline.share([launch], h100) == pytest.approx(25.0)
    assert roofline.share([launch], "some other card") is None
    assert roofline.share([], h100) is None
    # no events (a launch off the card): nothing to read, never 0
    assert roofline.share([(launch[0], None, None)], h100) is None


def test_trace_summary():
    ev = [
        dict(ph="X", cat="kernel", name="void knn_tile_kernel<32>(int)",
             ts=0, dur=10),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD", ts=5, dur=10),
        dict(ph="X", cat="kernel", name="ivf_score_kernel", ts=40, dur=20),
        dict(ph="X", cat="cpu_op", name="aten::sort", ts=16, dur=20),
        dict(ph="X", cat="user_annotation", name="test", ts=0, dur=100),
    ]
    s = trace.summarize(ev)
    assert s["busy_s"] == pytest.approx(35e-6)
    assert trace.short_name(
        "void (anonymous namespace)::ivf_score_kernel<32, 4>(float const*)"
    ) == "ivf_score_kernel<32, 4>"
    assert s["kernel_s"]["knn_tile_kernel<32>"] == pytest.approx(10e-6)
    assert s["idle_gaps"] == [["aten::sort", pytest.approx(25e-6)]]
    assert s["kernel_s"]["ivf_score_kernel"] == pytest.approx(20e-6)


def test_judged_rows():
    assert kinds.judged_rows(dict(knn_judged_rows="all"), 7, 1).tolist() \
        == list(range(7))
    rows = kinds.judged_rows(dict(knn_judged_rows=5), 1000, 3)
    assert len(set(rows.tolist())) == 5 and rows.tolist() == sorted(rows)
    assert kinds.judged_rows(dict(knn_judged_rows=50), 20, 3).size == 20
    with pytest.raises(FileNotFoundError):
        kinds.load("no_such_kind")


def test_control_precision_follows_the_configuration():
    assert control.control_precision(
        dict(dtype="float32", tf32=False)).tf32
    with pytest.raises(ValueError):
        control.control_precision(dict(dtype="float64", tf32=False))


def test_run_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert run.main(["--workload", "bench100k.assoc", "--seed", "1",
                     "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_reference_agrees_with_the_port_on_the_cpu(workload):
    """The whole run on the CPU at 3,000 cells: the port (float32) holds
    the cell's limits against the float64 reference, and no JAX module is
    loaded."""
    warnings.filterwarnings("ignore")
    result, rows, _ = run.run_cell(BENCH, workload, 2**33 + 11, 0.5, False,
                                device="cpu", config_overrides=SMALL)
    assert result["correct"], rows
    assert result["attempted"] >= 1
    assert not any(m in sys.modules for m in ("jax", "jaxlib", "flax"))
    assert run.forbidden_modules() == []


def test_traced_run_on_the_cpu():
    """A traced run reads the per-layer metrics of its cell (the kernels'
    rooflines and a device's idle share need a card: on the CPU the
    harness leaves what it cannot read out, and never reads 0)."""
    warnings.filterwarnings("ignore")
    result, _, _ = run.run_cell(BENCH, "bench100k.assoc", 2**33 + 1, 0.3, True,
                             device="cpu", config_overrides=SMALL)
    for name in ("assoc.nam_s", "assoc.test_s", "assoc.host_s"):
        assert result["metrics"][name]["value"] > 0
    assert "busy_s" in result["device"] and "breakdown" in result
    assert list(result)[-1] == "checks"
