from .buckets import BucketEllGraph, degree_ordering, from_scipy_buckets
from .device import (DeviceConnectivities, LazyDistances, SortedExtGraph,
                     build_sym_ell)
from .ell import EllGraph, from_arrays, from_scipy
from .reorder import Reordering, permute_graph

__all__ = ["EllGraph", "from_arrays", "from_scipy",
           "BucketEllGraph", "degree_ordering", "from_scipy_buckets",
           "Reordering", "permute_graph", "DeviceConnectivities",
           "LazyDistances", "SortedExtGraph", "build_sym_ell"]
