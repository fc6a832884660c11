"""Several devices and processes: the (cells, perms) mesh of slots,
halo-exchange diffusion and the sharded pipeline stages (the TPU
package's ``parallel``)."""
from . import mesh
from .mesh import make_mesh, CELLS, PERMS
from . import dist
from . import halo
from . import launch
from . import sharded

__all__ = ["mesh", "make_mesh", "sharded", "halo", "launch", "dist",
           "CELLS", "PERMS"]
