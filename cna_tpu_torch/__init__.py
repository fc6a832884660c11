"""cna_tpu_torch: Covarying Neighborhood Analysis in PyTorch and CUDA.

The port of the TPU package (``cna_tpu``) to PyTorch on an NVIDIA H100.
It keeps that package's public names and contracts:

  cna_tpu_torch.tl.association / nam / svd_nam / diffuse / diffuse_stepwise
  cna_tpu_torch.tl.set_graph_format, cna_tpu_torch.tl._stats
  cna_tpu_torch.pl.umap_ncorr / umap_overlay / violinplot
  cna_tpu_torch.pp (HVG / PCA / kNN / fuzzy-connectivity graph / UMAP)
  cna_tpu_torch.CellData, cna_tpu_torch.read_h5ad, cna_tpu_torch.config,
  cna_tpu_torch.ut
  cna_tpu_torch.parallel (make_mesh, CELLS, PERMS, halo, launch, sharded)

Plain tensor code is PyTorch; each TPU kernel on the ported path is a
CUDA kernel written by hand for Hopper (``csrc/``, built by ``nvcc`` at
first use).  Entry points compute on ``cuda`` unless the caller asks for
the CPU with ``config.set_device("cpu")``.  ``pl`` needs matplotlib and
``read_h5ad`` / ``CellData.write`` need h5py, imported at first use.
``association(mesh=)``, ``nam(mesh=)`` and ``pp.ivf_knn(devices=)`` spread
the work over several slots of a ``parallel.make_mesh`` mesh (several
cards, several processes, or several slots on one device).
"""

from . import config
from . import parallel
from . import pp
from . import tools as tl
from . import plotting as pl
from . import utils as ut
from .data import CellData, read_h5ad
from .tools import association, nam, svd_nam, diffuse, diffuse_stepwise

__version__ = "0.1.0"

__all__ = [
    "association",
    "nam",
    "svd_nam",
    "diffuse",
    "diffuse_stepwise",
    "CellData",
    "read_h5ad",
    "tl",
    "pl",
    "ut",
    "config",
    "parallel",
]
