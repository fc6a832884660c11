from . import checks, interop, profiling, transfer
from .interop import graph_from_numpy
from .transfer import fetch, fetch_many

__all__ = ["checks", "interop", "profiling", "transfer", "graph_from_numpy",
           "fetch", "fetch_many"]
