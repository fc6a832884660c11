"""``knn_exact`` (``csrc/knn_exact.cu``): the exact self-kNN of N rows of
width D, all three kernels of a launch (the centring pre-pass, the key
rows and the distance tiles).

Operations: ``2 * N^2 * D``.  Bytes: the rows read once, the (distance,
id) top-k of every row written once.  The arithmetic of
``chip_smoke.py``'s ``knn_bound``.
"""

TARGETS = (("cna_tpu_torch.ops.knn", "knn_exact"),)


def count(args, kwargs):
    x = args[0] if args else kwargs["x"]
    k = int(args[1] if len(args) > 1 else kwargs["k"])
    n, d = x.shape

    def thunk():
        return 2.0 * n * n * d, 4.0 * n * d + 8.0 * n * k

    return thunk
