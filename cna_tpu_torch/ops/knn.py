"""Exact self-kNN: the hand-written CUDA kernel and its plain version.

Counterpart of the TPU package's ``ops/knn_pallas.py`` (the Pallas kernel
``_knn_kernel`` at :44, launched through ``_knn_call`` / ``knn_pallas``).
The contract is the same (``knn_pallas.py:132-147``):

* the computation is float32 whatever the x64 setting;
* it returns ``(neg_sq_dists (N, k) float32, descending; ids (N, k)
  int32)``, with each point its own first neighbour at distance 0.

``knn_exact`` is the wrapper.  A CUDA tensor goes to the kernel in
``csrc/knn_exact.cu`` (built by ``nvcc`` at first use) or raises; a CPU
tensor goes to ``knn_exact_plain``, the plain PyTorch version that the
CPU tests run and that the card's smoke run compares the kernel with.
There is no fallback from one to the other.

What bounds the kernel on an H100, and its design, are stated at the top
of ``csrc/knn_exact.cu``: float32 operations (2 N^2 D flop), one thread
per query with the query in registers, key tiles broadcast from shared
memory, direct ``sum((q - x)^2)`` distances, and a per-thread sorted
top-k that is touched only when a key beats the current k-th.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = "knn_exact"
MAX_K = 128  # must match kMaxK in csrc/knn_exact.cu
MAX_D = 128  # must match kMaxD
# row blocks of the plain version: a (4096, 16384) float32 distance block
# is 256 MiB, small on the card and fine on the CPU
_PLAIN_QUERY_BLOCK = 4096
_PLAIN_KEY_BLOCK = 16384


def _check(x, k):
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError("knn_exact expects a 2-D tensor of points")
    if x.dtype != torch.float32:
        raise TypeError(f"knn_exact computes in float32; got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("knn_exact expects a contiguous (N, D) tensor")
    n, d = x.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"knn_exact supports 1 <= D <= {MAX_D}; got D={d}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_exact supports 1 <= k <= {MAX_K}; got k={k}")
    if k > n:
        raise ValueError(f"k={k} exceeds the number of points N={n}")


def knn_exact(x: torch.Tensor, k: int):
    """Exact self-kNN of the rows of ``x`` ((N, D) float32, contiguous).

    Returns (neg_sq_dists (N, k) float32 descending, ids (N, k) int32).
    Raises ValueError for k > 128 or D > 128 (the kernel's limits) on
    every device.
    """
    _check(x, k)
    if x.device.type == "cpu":
        return knn_exact_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"knn_exact runs on cuda or cpu, not {x.device}")
    lib = _lib()
    n, d = x.shape
    negd = torch.empty((n, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((n, k), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.knn_exact_launch(x.data_ptr(), n, d, k, negd.data_ptr(),
                                   idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"knn_exact launch failed with CUDA error {err}")
    _build.count_launch(KERNEL)
    return negd, idx


def knn_exact_plain(x: torch.Tensor, k: int):
    """Plain PyTorch version of the kernel, on any device.

    Blocked direct-difference squared distances (``torch.cdist`` without
    the matmul expansion, so the self distance is an exact 0) and a
    running ``torch.topk`` merge over key blocks; float32 like the
    kernel.  Returns the same (neg_sq_dists, ids) pair.
    """
    x = x.to(torch.float32)
    n = x.shape[0]
    dev = x.device
    out_d, out_i = [], []
    for qs in range(0, n, _PLAIN_QUERY_BLOCK):
        q = x[qs:qs + _PLAIN_QUERY_BLOCK]
        nq = q.shape[0]
        best_d = torch.full((nq, k), float("inf"), dtype=torch.float32,
                            device=dev)
        best_i = torch.zeros((nq, k), dtype=torch.int64, device=dev)
        for ks in range(0, n, _PLAIN_KEY_BLOCK):
            xb = x[ks:ks + _PLAIN_KEY_BLOCK]
            d2 = torch.cdist(q, xb,
                             compute_mode="donot_use_mm_for_euclid_dist") ** 2
            ids = torch.arange(ks, ks + xb.shape[0], device=dev)
            cat_d = torch.cat([best_d, d2], dim=1)
            cat_i = torch.cat([best_i, ids.expand(nq, -1)], dim=1)
            best_d, pos = torch.topk(cat_d, k, dim=1, largest=False,
                                     sorted=True)
            best_i = torch.gather(cat_i, 1, pos)
        out_d.append(-best_d)
        out_i.append(best_i.to(torch.int32))
    return torch.cat(out_d), torch.cat(out_i)


def _lib():
    lib = _build.load(KERNEL)
    if lib.knn_exact_launch.argtypes is None:  # first use: declare the C ABI
        lib.knn_exact_launch.restype = ctypes.c_int
        lib.knn_exact_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        if (lib.knn_exact_max_k(), lib.knn_exact_max_d()) != (MAX_K, MAX_D):
            raise RuntimeError("knn_exact library limits disagree with "
                               "ops/knn.py's MAX_K / MAX_D")
    return lib
