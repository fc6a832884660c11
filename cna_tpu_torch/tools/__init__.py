"""``cna_tpu_torch.tl``: the scanpy-idiomatic tools namespace.

Mirrors the reference's ``cna.tl`` exports (``tools/__init__.py:1-9``):
association, nam, svd_nam, diffuse, diffuse_stepwise; plus the
graph-format selector and the reference-compatible ``tl._stats``
namespace.
"""
from . import _stats
from ._association import association
from ._nam import (diffuse, diffuse_stepwise, nam, set_graph_format,
                   svd_nam)

__all__ = ["association", "nam", "svd_nam", "diffuse", "diffuse_stepwise",
           "set_graph_format"]
