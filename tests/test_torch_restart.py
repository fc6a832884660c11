"""Restart/resume of the port after a killed process: the counterpart of
``tests/test_restart.py``.

A process computes the NAM, persists the fingerprint-keyed savepoint
(``utils.checkpoint``) and dies before the association statistics; a
fresh process rerunning the same association must resume from the
savepoint (no diffusion recompute) and give the results of a run that
never crashed.
"""

import json
import os
import subprocess
import sys

import numpy as np

_WORKER = os.path.join(os.path.dirname(__file__), "torch_restart_worker.py")
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(phase, savepoint, out_path):
    return subprocess.run(
        [sys.executable, _WORKER, phase, str(savepoint), str(out_path)],
        capture_output=True, text=True, timeout=600, cwd=_ROOT)


def test_torch_resume_after_killed_process(tmp_path):
    sp = tmp_path / "nam_savepoint.npz"
    out_resume = tmp_path / "resume.json"
    out_clean = tmp_path / "clean.json"

    # phase 1: compute the NAM and its savepoint, then die hard
    r = _run("crash", sp, tmp_path / "unused.json")
    assert r.returncode == 17, (r.returncode, r.stderr[-2000:])
    assert sp.exists()
    assert "computing NAM" in r.stdout

    # phase 2: a FRESH process resumes and must hit the savepoint
    r = _run("resume", sp, out_resume)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "loading NAM from savepoint" in r.stdout, r.stdout[-2000:]
    assert "computing NAM" not in r.stdout

    # ground truth: a never-crashed run in its own process
    r = _run("clean", sp, out_clean)
    assert r.returncode == 0, r.stderr[-2000:]

    resumed = json.load(open(out_resume))
    clean = json.load(open(out_clean))
    assert resumed["p"] == clean["p"]
    np.testing.assert_allclose(resumed["ncorrs"], clean["ncorrs"],
                               rtol=1e-12, atol=1e-12)


def test_torch_restart_worker_imports_neither_jax_nor_cna_tpu(tmp_path):
    """The worker runs where the port runs: a clean run loads no module
    of JAX or of the TPU package."""
    probe = ("import runpy, sys; sys.argv = [sys.argv[1], 'clean', "
             "sys.argv[2], sys.argv[3]]; runpy.run_path(sys.argv[0], "
             "run_name='__main__'); "
             "bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'cna_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run(
        [sys.executable, "-c", probe, _WORKER, str(tmp_path / "sp.npz"),
         str(tmp_path / "out.json")],
        capture_output=True, text=True, timeout=600, cwd=_ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert (tmp_path / "out.json").exists()
