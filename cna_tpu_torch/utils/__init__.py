from . import checkpoint, checks, interop, multisample, profiling, transfer
from .interop import (banded_graph_from_numpy, block_graph_from_numpy,
                      fine_index_from_numpy, graph_from_numpy,
                      hybrid_graph_from_numpy, sorted_ext_graph_from_numpy)
from .multisample import obs_to_sample
from .transfer import fetch, fetch_many

__all__ = ["checkpoint", "checks", "interop", "multisample", "profiling",
           "transfer", "banded_graph_from_numpy", "block_graph_from_numpy",
           "fine_index_from_numpy", "graph_from_numpy",
           "hybrid_graph_from_numpy", "sorted_ext_graph_from_numpy",
           "obs_to_sample", "fetch", "fetch_many"]
