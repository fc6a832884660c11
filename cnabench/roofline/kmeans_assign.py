"""``kmeans_assign`` (``csrc/kmeans_assign.cu``): the nearest of C
centroids for every row of width d, all three kernels of a launch (the
centring pre-pass, the key rows and the distance tiles).

Operations: ``2 * rows * C * d``, d the rows' own width (the kernel pads
nothing in memory).  Bytes: the rows and the centroids read once, the id
and distance of every row written once.  The arithmetic of
``chip_smoke.py``'s ``kmeans_phase``.

The target is the wrapper as ``pp/ivf_fine.py`` calls it, a module global
there; a program without it (a checkout before the kernel) has nothing to
wrap, and the metric then reads nothing.
"""

import importlib

_OWNER = "cna_tpu_torch.pp.ivf_fine"


def _targets():
    try:
        owner = importlib.import_module(_OWNER)
    except ImportError:
        return ()
    return ((_OWNER, "kmeans_assign"),) if hasattr(owner, "kmeans_assign") \
        else ()


TARGETS = _targets()


def count(args, kwargs):
    x = args[0] if args else kwargs["x"]
    cent = args[1] if len(args) > 1 else kwargs["cent"]
    rows, d = x.shape
    c = cent.shape[0]

    def thunk():
        return (2.0 * rows * c * d,
                4.0 * (rows * d + c * d) + 8.0 * rows)

    return thunk
