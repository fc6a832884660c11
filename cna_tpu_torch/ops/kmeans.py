"""The k-means assignment: the hand-written CUDA kernel and its plain
version.

For every row of ``x`` (rows, d) float32, the id of its nearest centroid
among ``cent`` (C, d) float32, as int32, and that squared distance, as
float32.  The IVF build's Lloyd iterations (``pp/ivf_fine.py``) and the
multi-device partition's clustering (``graph/partition.py``) call it.

``kmeans_assign`` is the wrapper.  A CUDA tensor goes to the kernel in
``csrc/kmeans_assign.cu`` (built by ``nvcc`` at first use) or raises; a
CPU tensor goes to ``kmeans_assign_plain``, the plain PyTorch version that
the CPU tests run and that the card's smoke run compares the kernel with.
There is no fallback from one to the other.

The kernel never writes a (rows, C) value: TF32 distance tiles on the
tensor cores (``csrc/dist_tile.cuh``) only decide which centroids are
looked at, each of those is decided by the direct float32 sum of
``(q - c)^2`` in id order, and the lowest id wins among equal distances.
The plain version takes the argmin of the matmul expansion
``|c|^2 - 2 q.c`` over (rows, C) tiles, the step the kernel replaced, so
the two may pick different centroids where two distances lie within the
expansion's rounding of each other.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.checks import kernel_outputs
from . import _build
from ._dist_tile import MAX_D, filter_bound, kernel_d_pad

KERNEL = "kmeans_assign"
N_STATS = 2  # counters of the debug argument ``stats``
# elements of the plain version's (rows, C) distance tile: 1 GiB of float32
_PLAIN_TILE = 1 << 28


def _check(x, cent):
    for name, t in (("x", x), ("cent", cent)):
        if not isinstance(t, torch.Tensor) or t.dim() != 2:
            raise ValueError(f"kmeans_assign expects a 2-D tensor {name}")
        if t.dtype != torch.float32:
            raise TypeError(f"kmeans_assign computes in float32; got "
                            f"{name} of {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"kmeans_assign expects a contiguous {name}")
    if x.device != cent.device:
        raise ValueError(f"x is on {x.device}, cent on {cent.device}")
    d = x.shape[1]
    if cent.shape[1] != d:
        raise ValueError(f"x has {d} coordinates, cent {cent.shape[1]}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"kmeans_assign supports 1 <= d <= {MAX_D}; got "
                         f"d={d}")
    if cent.shape[0] < 1:
        raise ValueError("kmeans_assign needs at least one centroid")


def kmeans_assign(x: torch.Tensor, cent: torch.Tensor, stats=None):
    """Nearest centroid of every row of ``x`` ((rows, d) float32,
    contiguous) among ``cent`` ((C, d) float32, contiguous).

    Returns (ids (rows,) int32, squared distances (rows,) float32).
    Raises on any other dtype, a non-contiguous tensor or d outside
    1..128, on every device.

    ``stats`` is a debug argument that no path of the package passes: an
    int64 tensor of ``N_STATS`` counters on ``x``'s card that the launch
    adds to, [0] the centroids whose exact distance the kernel computed
    (besides centroid 0, with which every row starts), [1] the (row,
    centroid) pairs it met (rows x C)."""
    _check(x, cent)
    if x.device.type == "cpu":
        return kmeans_assign_plain(x, cent)
    if x.device.type != "cuda":
        raise ValueError(f"kmeans_assign runs on cuda or cpu, not "
                         f"{x.device}")
    if stats is not None and (
            stats.dtype != torch.int64 or stats.shape != (N_STATS,)
            or stats.device != x.device or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous int64 tensor of "
                         f"{N_STATS} counters on x's device")
    lib = _lib()
    n, d = x.shape
    c = cent.shape[0]
    ids = torch.empty((n,), dtype=torch.int32, device=x.device)
    dist = torch.empty((n,), dtype=torch.float32, device=x.device)
    eps, gam = filter_bound(kernel_d_pad(d))
    scratch = torch.empty((lib.kmeans_assign_scratch_bytes(c, d),),
                          dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.kmeans_assign_launch(
            x.data_ptr(), n, d, cent.data_ptr(), c, eps, gam,
            scratch.data_ptr(), ids.data_ptr(), dist.data_ptr(),
            None if stats is None else stats.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"kmeans_assign launch failed with CUDA error "
                           f"{err}")
    _build.count_launch(KERNEL)
    kernel_outputs(KERNEL, dist)
    return ids, dist


def kmeans_assign_plain(x: torch.Tensor, cent: torch.Tensor):
    """Plain PyTorch version of the kernel, on any device: the argmin of
    ``|c|^2 - 2 q.c`` over tiles of ``_PLAIN_TILE`` elements (the first
    of equal minima), then the direct float32 squared distance to the
    chosen centroid.  Returns the same (ids int32, squared distances
    float32) pair."""
    rows = max(1, _PLAIN_TILE // cent.shape[0])
    cn = torch.sum(cent * cent, dim=1)[None, :]
    ids = torch.cat([
        torch.argmin(cn - 2.0 * (x[lo:lo + rows] @ cent.T), dim=1)
        for lo in range(0, x.shape[0], rows)])
    dist = torch.sum((x - cent[ids]) ** 2, dim=1)
    return ids.to(torch.int32), dist


def _lib():
    lib = _build.load(KERNEL)
    if lib.kmeans_assign_launch.argtypes is None:  # first use: the C ABI
        lib.kmeans_assign_scratch_bytes.restype = ctypes.c_longlong
        lib.kmeans_assign_scratch_bytes.argtypes = [ctypes.c_int,
                                                    ctypes.c_int]
        lib.kmeans_assign_launch.restype = ctypes.c_int
        lib.kmeans_assign_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float]
            + [ctypes.c_void_p] * 5)
        if lib.kmeans_assign_max_d() != MAX_D:
            raise RuntimeError("kmeans_assign library limit disagrees with "
                               "ops/_dist_tile.py's MAX_D")
    return lib
