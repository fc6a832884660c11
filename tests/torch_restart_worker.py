"""Subprocess worker of the port's restart/resume test
(``tests/test_torch_restart.py``), the counterpart of
``tests/restart_worker.py``.  Imports ``cna_tpu_torch`` only.

    python tests/torch_restart_worker.py PHASE SAVEPOINT OUT_JSON

Phases (CPU, float64):
  crash  — build the dataset, compute the NAM with a savepoint, then
           die hard (``os._exit(17)``) BEFORE the association statistics
           run: the savepoint on disk is all that survives.
  resume — run the full association with the same savepoint; prints the
           pipeline progress (the savepoint hit emits "loading NAM from
           savepoint") and writes results to the output json.
  clean  — full association with NO savepoint (ground truth).
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _dataset():
    import cna_tpu_torch as ct

    ct.config.set_device("cpu")
    ct.config.enable_x64(True)
    d, samplem = ct.data.synthetic_dataset(n_samples=20, cells_per_sample=60,
                                           n_genes=12, seed=13)
    ct.pp.pca(d, n_comps=8)
    ct.pp.neighbors(d, n_neighbors=8)
    y = samplem["case"].astype(float)
    return d, y


def main():
    phase, savepoint, out_path = sys.argv[1], sys.argv[2], sys.argv[3]
    if phase not in ("crash", "resume", "clean"):
        raise SystemExit(f"unknown phase {phase!r}")
    d, y = _dataset()
    import cna_tpu_torch as ct

    if phase == "crash":
        from cna_tpu_torch.tools._nam import nam_arrays

        nam_arrays(d, "id", nam_savepoint=savepoint, show_progress=True)
        if not os.path.exists(savepoint):
            raise SystemExit("the savepoint was not written")
        sys.stdout.flush()
        os._exit(17)  # an abrupt kill mid-pipeline

    kwargs = {} if phase == "clean" else {"nam_savepoint": savepoint}
    res = ct.tl.association(d, y, "id", Nnull=200, seed=0,
                            return_full=True, show_progress=True,
                            **kwargs)
    with open(out_path, "w") as f:
        json.dump({"p": float(res.p),
                   "ncorrs": np.asarray(res.ncorrs).tolist()}, f)


if __name__ == "__main__":
    main()
