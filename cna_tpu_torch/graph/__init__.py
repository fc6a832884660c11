from .blocks import (BlockGraph, HybridGraph, cluster_ordering,
                     from_scipy_blocks, from_scipy_hybrid)
from .buckets import BucketEllGraph, degree_ordering, from_scipy_buckets
from .device import (DeviceConnectivities, LazyDistances, SortedExtGraph,
                     build_sym_ell)
from .ell import EllGraph, from_arrays, from_scipy
from .reorder import (Reordering, bandwidth_profile, permute_graph,
                      permute_graph_unsorted, rcm_ordering)

__all__ = ["EllGraph", "from_arrays", "from_scipy",
           "BucketEllGraph", "degree_ordering", "from_scipy_buckets",
           "BlockGraph", "HybridGraph", "cluster_ordering",
           "from_scipy_blocks", "from_scipy_hybrid",
           "Reordering", "permute_graph", "permute_graph_unsorted",
           "rcm_ordering", "bandwidth_profile", "DeviceConnectivities",
           "LazyDistances", "SortedExtGraph", "build_sym_ell"]
