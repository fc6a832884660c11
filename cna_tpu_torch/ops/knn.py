"""Exact self-kNN: the hand-written CUDA kernel and its plain version.

Counterpart of the TPU package's ``ops/knn_pallas.py`` (the Pallas kernel
``_knn_kernel`` at :44, launched through ``_knn_call`` / ``knn_pallas``).
The contract is the same (``knn_pallas.py:132-147``):

* the computation is float32 whatever the x64 setting;
* it returns ``(neg_sq_dists (N, k) float32, descending; ids (N, k)
  int32)``, with each point its own first neighbour at distance 0.

Each distance is the direct float32 sum of ``(q - x)^2`` (so a self
distance is an exact 0) and among equal distances the lower id comes
first.

``knn_exact`` is the wrapper.  A CUDA tensor goes to the kernel in
``csrc/knn_exact.cu`` (built by ``nvcc`` at first use) or raises; a CPU
tensor goes to ``knn_exact_plain``, the plain PyTorch version that the
CPU tests run and that the card's smoke run compares the kernel with.
There is no fallback from one to the other.

What bounds the kernel on an H100, and its design, are stated at the top
of ``csrc/knn_exact.cu``: 2 N^2 D operations, run as TF32 distance tiles
on the tensor cores (``csrc/dist_tile.cuh``) that only decide which
candidates are looked at; every candidate that can enter a row's top-k
is decided in float32 with the first kernel's arithmetic, in id order,
so the result is the exact float32 top-k.  The filter's error terms come
from ``ops/_dist_tile.py:filter_bound``, shared with ``ops.ivf``.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.checks import kernel_outputs
from . import _build
from ._dist_tile import filter_bound, kernel_d_pad

KERNEL = "knn_exact"
MAX_K = 128  # must match kMaxK in csrc/knn_exact.cu
MAX_D = 128  # must match kMaxD
N_STATS = 5  # counters of the debug argument ``stats``
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


def knn_exact(x: torch.Tensor, k: int, stats=None):
    """Exact self-kNN of the rows of ``x`` ((N, D) float32, contiguous).

    Returns (neg_sq_dists (N, k) float32 descending, ids (N, k) int32).
    Raises ValueError for k > 128 or D > 128 (the kernel's limits) on
    every device.

    ``stats`` is a debug argument that no path of the package passes: an
    int64 tensor of ``N_STATS`` counters on ``x``'s card that the launch
    adds to, [0] the candidates whose exact distance the kernel computed,
    [1] the (query row, candidate) pairs it met (N^2), [2], [3], [4] the
    cycles its MMA warps spent waiting for key tiles, in the filter and on
    the exact path (``clock64``, summed over warps; reading the clock is
    the only work a launch with ``stats`` adds)."""
    _check(x, k)
    if x.device.type == "cpu":
        return knn_exact_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"knn_exact runs on cuda or cpu, not {x.device}")
    if stats is not None and (
            stats.dtype != torch.int64 or stats.shape != (N_STATS,)
            or stats.device != x.device or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous int64 tensor of "
                         f"{N_STATS} counters on x's device")
    lib = _lib()
    n, d = x.shape
    eps, gam = filter_bound(kernel_d_pad(d))
    negd = torch.empty((n, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((n, k), dtype=torch.int32, device=x.device)
    scratch = torch.empty((lib.knn_exact_scratch_bytes(n, d),),
                          dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.knn_exact_launch(
            x.data_ptr(), n, d, k, eps, gam, scratch.data_ptr(),
            negd.data_ptr(), idx.data_ptr(),
            None if stats is None else stats.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"knn_exact launch failed with CUDA error {err}")
    _build.count_launch(KERNEL)
    kernel_outputs(KERNEL, negd, idx)
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
        lib.knn_exact_scratch_bytes.restype = ctypes.c_longlong
        lib.knn_exact_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.knn_exact_launch.restype = ctypes.c_int
        lib.knn_exact_launch.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
            + [ctypes.c_void_p] * 5)
        if (lib.knn_exact_max_k(), lib.knn_exact_max_d()) != (MAX_K, MAX_D):
            raise RuntimeError("knn_exact library limits disagree with "
                               "ops/knn.py's MAX_K / MAX_D")
    return lib
