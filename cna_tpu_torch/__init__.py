"""cna_tpu_torch: Covarying Neighborhood Analysis in PyTorch and CUDA.

The port of the TPU package (``cna_tpu``) to PyTorch on an NVIDIA H100.
It keeps that package's public names and contracts:

  cna_tpu_torch.tl.association / nam / svd_nam / diffuse / diffuse_stepwise
  cna_tpu_torch.tl.set_graph_format, cna_tpu_torch.tl._stats
  cna_tpu_torch.pp (PCA / kNN / fuzzy-connectivity graph construction)
  cna_tpu_torch.CellData, cna_tpu_torch.config, cna_tpu_torch.ut

Plain tensor code is PyTorch; each TPU kernel on the ported path is a
CUDA kernel written by hand for Hopper (``csrc/``, built by ``nvcc`` at
first use).  Entry points compute on ``cuda`` unless the caller asks for
the CPU with ``config.set_device("cpu")``.  Still to port (ROADMAP.md):
``parallel``, ``pl``, ``pp.umap`` / ``pp.select_hvg`` and ``read_h5ad``.
"""

from . import config
from . import pp
from . import tools as tl
from . import utils as ut
from .data import CellData
from .tools import association, nam, svd_nam, diffuse, diffuse_stepwise

__version__ = "0.1.0"

__all__ = [
    "association",
    "nam",
    "svd_nam",
    "diffuse",
    "diffuse_stepwise",
    "CellData",
    "tl",
    "ut",
    "config",
]
