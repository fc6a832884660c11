"""The port's demo script (``examples/demo_torch.py``) runs end to end on
the CPU: the counterpart of ``tests/test_demo_script.py``."""

import os
import subprocess
import sys


def test_demo_torch_script_end_to_end(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "demo_out"
    env = dict(os.environ, MPLBACKEND="Agg")
    r = subprocess.run(
        [sys.executable, os.path.join(repo, "examples", "demo_torch.py"),
         "--cpu", "--out", str(out), "--cells-per-sample", "60"],
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert (out / "association.png").exists()
    assert (out / "demo.h5ad").exists()
    # the demo prints the global p-value it computed
    assert "global p-value" in r.stdout


def test_demo_torch_script_needs_the_card_without_cpu(tmp_path):
    """Without ``--cpu`` and without a card the demo stops at the first
    entry point; it does not carry on on the CPU."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the demo runs on it")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, os.path.join(repo, "examples", "demo_torch.py"),
         "--out", str(tmp_path / "out"), "--cells-per-sample", "60"],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, MPLBACKEND="Agg"))
    assert r.returncode != 0
    assert "set_device('cpu')" in r.stderr
    assert not (tmp_path / "out" / "association.png").exists()
