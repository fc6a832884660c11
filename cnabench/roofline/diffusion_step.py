"""``diffusion_step`` (``cna_tpu_torch/ops/spmm.py``): one step of the
association's diffusion, ``A @ (s / colsums) + self_weight * s / colsums``,
whatever computes it (the gather SpMM kernel, or the plain gather and
einsum of a checkout before it).

Bytes: a bound that no implementation can beat: the state read once and
the step written once (``N * S * itemsize`` each), the column sums
(``N * itemsize``), and an id and a weight (``4 + itemsize`` bytes) for
every edge of the graph whose weight is not 0; padded slots and the zero
self entries of the kNN lists are not counted.  Operations:
``2 * nnz * S`` (a product and a sum a term) plus ``3 * N * S`` (the
division, and the self term's product and sum).

The target is the function as ``tools/_nam.py`` calls it, a module
attribute of ``cna_tpu_torch.ops.spmm``, so that a checkout before the
kernel reads the same work through its plain path.  The edges are
counted in the thunk, after the traced window.
"""

import importlib

_OWNER = "cna_tpu_torch.ops.spmm"
_WEIGHTS = ("weights", "direct_weights", "spill_weights",
            "overflow_weights")


def _targets():
    try:
        owner = importlib.import_module(_OWNER)
    except ImportError:
        return ()
    return ((_OWNER, "diffusion_step"),) \
        if hasattr(owner, "diffusion_step") else ()


TARGETS = _targets()


def nonzero_edges(graph) -> int:
    """Edges of ``graph`` with a weight that is not 0: its ELL (or
    direct), spill and COO arrays, and of its mirror buckets the rows its
    ``inv_pi`` reads (a bucket slice carried over from the TPU package may hold
    copies that no row reads)."""
    total = 0
    for name in _WEIGHTS:
        arrays = getattr(graph, name, ())
        for w in arrays if isinstance(arrays, tuple) else (arrays,):
            total += int((w != 0).sum())
    pos, start = getattr(graph, "inv_pi", None), 0
    for w in getattr(graph, "ext_weights", ()):
        rows = w.shape[0]
        read = pos[(pos >= start) & (pos < start + rows)] - start
        total += int((w[read] != 0).sum())
        start += rows
    return total


def count(args, kwargs):
    got = dict(zip(("s", "graph", "colsums", "self_weight"), args))
    got.update(kwargs)
    s, graph = got["s"], got["graph"]
    n, width = s.shape
    item = s.element_size()

    def thunk():
        nnz = nonzero_edges(graph)
        return (2.0 * nnz * width + 3.0 * n * width,
                2.0 * n * width * item + n * item + (4.0 + item) * nnz)

    return thunk
