"""The port's mesh across two processes, over torch.distributed (gloo).

Mirrors ``tests/test_multiprocess.py``: two processes with 4 ``cpu``
slots each join one process group, build ``launch.global_mesh(perms=2)``
(4 cells x 2 perms) and run the full ``association(mesh=)`` (halo
exchange between the processes' cell slots, perms-sharded nulls, the
cross-process ``assert_agreement`` digests) on one dataset written once
by the test.  The processes must agree bit for bit and match a
single-process run of the same data and seed.  A second layout gives
each process 3 slots (3 cells x 2 perms): cell shard 1 then has its
primary slot in one process and its perms replica in the other.

The worker is this file run as a script (``__main__`` below); it imports
nothing of JAX.
"""

import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

_HERE = Path(__file__)
_TIMEOUT_S = 300
_NNULL = 200


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _load(path):
    import pandas as pd
    import scipy.sparse as sp

    import cna_tpu_torch as ct

    with np.load(path, allow_pickle=False) as z:
        n = len(z["ids"])
        conn = sp.csr_matrix((z["data"], z["indices"], z["indptr"]),
                             shape=(n, n))
        d = ct.CellData(X=z["x_pca"], obs=pd.DataFrame({"id": z["ids"]}),
                        obsm={"X_pca": z["x_pca"]},
                        obsp={"connectivities": conn})
        y = pd.Series(z["y"], index=pd.Index(z["samples"]))
    return d, y


def _outputs(res):
    return dict(p=np.array(res.p), k=np.array(res.k), ncorrs=res.ncorrs,
                nullminps=res.nullminps, fdr=res.fdrs.fdr.to_numpy())


@pytest.fixture(scope="module")
def mp_dataset(tmp_path_factory):
    """The data and its graph, built once by the port and written to
    disk, so that every process reads the same bits."""
    import cna_tpu_torch as ct
    from cna_tpu_torch import config

    config.set_device("cpu")
    config.enable_x64(True)
    d, samplem = ct.data.synthetic_dataset(
        n_samples=50, cells_per_sample=60, n_genes=50, seed=0,
        dtype=np.float64)
    ct.pp.pca(d, n_comps=20)
    ct.pp.neighbors(d, n_neighbors=10)
    conn = d.obsp["connectivities"].tocsr()
    y = samplem["case"].astype(float)
    path = tmp_path_factory.mktemp("mp") / "data.npz"
    np.savez(path, data=conn.data, indices=conn.indices, indptr=conn.indptr,
             x_pca=np.asarray(d.obsm["X_pca"]),
             ids=d.obs["id"].to_numpy().astype(str), y=y.to_numpy(),
             samples=np.asarray(y.index).astype(str))
    return path


@pytest.fixture(scope="module", params=[4, 3], ids=["4x2", "3x2"])
def mp_results(mp_dataset, request):
    port = _free_port()
    slots = request.param
    out_dir = mp_dataset.parent / f"slots{slots}"
    out_dir.mkdir()
    procs = [subprocess.Popen(
        [sys.executable, str(_HERE), str(i), "2", str(port),
         str(mp_dataset), str(out_dir), str(slots)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        cwd=str(_HERE.parent.parent)) for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {i} failed:\n{log[-4000:]}"
        assert "diffusion path halo" in log, log[-2000:]
    results = []
    for i in range(2):
        with np.load(out_dir / f"result{i}.npz") as z:
            results.append({k: z[k] for k in z.files})
    return results


def test_processes_agree_bit_for_bit(mp_results):
    a, b = mp_results
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_matches_single_process(mp_results, mp_dataset):
    import cna_tpu_torch as ct
    from cna_tpu_torch import config

    config.set_device("cpu")
    config.enable_x64(True)
    d, y = _load(mp_dataset)
    res = _outputs(ct.tl.association(d, y, "id", seed=0, Nnull=_NNULL,
                                     return_full=True))
    mp = mp_results[0]
    assert mp["p"] == res["p"] and mp["k"] == res["k"]
    for key in ("ncorrs", "nullminps", "fdr"):
        np.testing.assert_allclose(mp[key], res[key], rtol=1e-9,
                                   atol=1e-12, err_msg=key)


def _worker(pid, nproc, port, data_path, out_dir, slots):
    import torch

    torch.set_num_threads(1)  # one summation order in both processes
    sys.path.insert(0, str(_HERE.parent.parent))
    import cna_tpu_torch as ct
    from cna_tpu_torch import config
    from cna_tpu_torch.parallel import launch

    assert "jax" not in sys.modules
    config.set_device("cpu")
    config.enable_x64(True)
    launch.initialize_distributed(f"127.0.0.1:{port}", num_processes=nproc,
                                  process_id=pid)
    try:
        assert torch.distributed.get_backend() == "gloo"
        mesh = launch.global_mesh(perms=2, local_devices=["cpu"] * slots)
        assert mesh.multiprocess and mesh.shape == {"cells": slots,
                                                    "perms": 2}
        assert mesh.ranks == [0, 1]
        d, y = _load(data_path)
        res = ct.tl.association(d, y, "id", mesh=mesh, seed=0,
                                Nnull=_NNULL, return_full=True)
        print("diffusion path", d.uns["_cna_tpu_torch_diffusion_path"],
              flush=True)
        launch.assert_agreement(res.p, "global_p")
        launch.assert_agreement(res.ncorrs, "ncorrs")
        launch.assert_agreement(res.nullminps, "nullminps")
        np.savez(Path(out_dir) / f"result{pid}.npz", **_outputs(res))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            sys.argv[5], int(sys.argv[6]))
