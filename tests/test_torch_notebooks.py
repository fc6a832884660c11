"""Execute the port's tutorial notebooks code cell by code cell (CPU).

The counterpart of ``tests/test_notebooks.py`` for
``examples/makedata_torch.ipynb`` and ``examples/demo_torch.ipynb``: every
code cell runs in order, in a shared namespace per notebook, in one temp
directory, after ``ct.config.set_device("cpu")`` (the notebooks keep the
default device, the card).
"""

import json
import os
import pathlib

import pytest

import cna_tpu_torch as ct

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


@pytest.fixture(scope="module", autouse=True)
def torch_cpu():
    """The notebooks run as a user runs them (float32), on the CPU; the
    precision in force before is restored after."""
    x64 = ct.config.x64_enabled()
    ct.config.set_device("cpu")
    ct.config.enable_x64(False)
    yield
    ct.config.enable_x64(x64)


def _run_notebook(path, workdir):
    with open(path) as f:
        nb = json.load(f)
    cells = [c for c in nb["cells"] if c["cell_type"] == "code"]
    assert cells, f"{path} has no code cells"
    ns = {}
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        for i, cell in enumerate(cells):
            src = "".join(cell["source"])
            try:
                exec(compile(src, f"{path.name}[cell {i}]", "exec"), ns)
            except Exception as e:  # pragma: no cover - failure reporting
                pytest.fail(f"{path.name} code cell {i} raised "
                            f"{type(e).__name__}: {e}\n---\n{src}")
    finally:
        os.chdir(cwd)
    return ns


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_notebooks")


def test_makedata_torch_notebook(workdir):
    _run_notebook(EXAMPLES / "makedata_torch.ipynb", workdir)
    assert (workdir / "demo_data.h5ad").exists()
    assert (workdir / "demo_samplem.csv").exists()


def test_demo_torch_notebook(workdir):
    # runs after makedata in the same dir, exercising the read_h5ad path
    ns = _run_notebook(EXAMPLES / "demo_torch.ipynb", workdir)
    assert 0 < ns["res"].p <= 1
    assert 0 < ns["p_sex"] <= 1
    assert (workdir / "demo_umap_ncorr.png").exists()
    assert ns["NAM"].shape[0] == 50


def test_notebooks_keep_the_tpu_notebooks_cells():
    """Cell for cell: the same number of code cells as the TPU package's
    notebooks, and no cell names that package or JAX."""
    for name in ("makedata", "demo"):
        cells = {}
        for suffix in ("", "_torch"):
            nb = json.loads((EXAMPLES / f"{name}{suffix}.ipynb").read_text())
            cells[suffix] = ["".join(c["source"]) for c in nb["cells"]
                             if c["cell_type"] == "code"]
        assert len(cells["_torch"]) == len(cells[""]), name
        for src in cells["_torch"]:
            assert "import cna_tpu\n" not in src + "\n"
            assert "cna_tpu." not in src and "jax" not in src
