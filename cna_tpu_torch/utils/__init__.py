from . import checks, interop, profiling, transfer
from .interop import (fine_index_from_numpy, graph_from_numpy,
                      sorted_ext_graph_from_numpy)
from .transfer import fetch, fetch_many

__all__ = ["checks", "interop", "profiling", "transfer",
           "fine_index_from_numpy", "graph_from_numpy",
           "sorted_ext_graph_from_numpy", "fetch", "fetch_many"]
