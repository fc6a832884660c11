"""IVF fine-block scoring: the hand-written CUDA kernel and its plain version.

Counterpart of the TPU package's ``ops/ivf_pallas.py`` (the Pallas kernel
``_score_kernel`` at :71, launched through ``score_blocks_pallas``; its
plain twin there is ``score_blocks_xla``).  The contract is the same:

* ``x4`` (F_pad, g, d_pad) float32 is the fine-block layout: block ``b``
  owns ``blk_counts[b]`` live rows, a count-0 block is a dummy, ``g`` is a
  power of two;
* ``sel_ids`` (ns,) names the slot scored by each output row; slot ``s``
  owns the query blocks ``[s*q_blocks, (s+1)*q_blocks)``;
* ``probe_ids`` (ns, P) names the probed blocks, P a multiple of
  ``CANDS_PER_STEP`` padded with dummy (count-0) blocks;
* the result is ``(negd (ns, q_blocks*g, k) float32 descending, ids same
  shape int32)``: for every query row the exact top-k within the live
  rows of its probed blocks, ids in compact coordinates
  ``blk_csum[b] + row-within-block``.

Where the TPU kernel leaves garbage this package defines the value: a
query row at or beyond its block's live count, and an entry for which the
probed set held fewer than k rows, is ``-inf`` with id 0.  Distances keep
full float32 (the TPU kernel's packed-id quantization is a Mosaic
workaround and is not carried over).

``score_blocks`` is the wrapper.  A CUDA tensor goes to the kernel in
``csrc/ivf_score.cu`` (built by ``nvcc`` at first use) or raises; a CPU
tensor goes to ``score_blocks_plain``.  There is no fallback from one to
the other.  What bounds the kernel on an H100, and its design, are stated
at the top of ``csrc/ivf_score.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = "ivf_score"
CANDS_PER_STEP = 16  # probe lists are padded to a multiple of this
MAX_K = 128  # must match kMaxK in csrc/ivf_score.cu
MAX_G = 128  # must match kMaxG
MAX_D = 128  # must match kMaxD
# the layout widths the kernel is compiled for
D_PADS = (4, 8, 12, 16, 20, 24, 28, 32, 48, 64, 96, 128)
# elements of the plain version's (slots, rows, candidates) distance tile
_PLAIN_TILE_ELEMS = 1 << 26


def kernel_d_pad(d: int) -> int:
    """The layout width for ``d`` coordinates: the smallest width the
    kernel is compiled for (rows then start on 16-byte boundaries)."""
    for w in D_PADS:
        if w >= d:
            return w
    raise ValueError(f"ivf_score supports at most {MAX_D} coordinates; "
                     f"got {d}")


def _check(x4, sel_ids, probe_ids, blk_counts, blk_csum, k, g, q_blocks):
    if x4.dim() != 3 or x4.dtype != torch.float32 or not x4.is_contiguous():
        raise ValueError("score_blocks expects x4 as a contiguous "
                         "(F_pad, g, d_pad) float32 tensor")
    f_pad, g_x, d_pad = x4.shape
    if g != g_x or g & (g - 1) or not 1 <= g <= MAX_G:
        raise ValueError(f"block rows g must be a power of two <= {MAX_G} "
                         f"and match x4; got g={g}, x4 {tuple(x4.shape)}")
    if d_pad not in D_PADS:
        raise ValueError(f"x4's width {d_pad} is not one of {D_PADS} "
                         "(see kernel_d_pad)")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"score_blocks supports 1 <= k <= {MAX_K}; got "
                         f"k={k}")
    if q_blocks < 1:
        raise ValueError("q_blocks must be at least 1")
    if probe_ids.dim() != 2 or probe_ids.shape[0] != sel_ids.shape[0]:
        raise ValueError("probe_ids must be (ns, P) with one row per slot")
    if probe_ids.shape[1] % CANDS_PER_STEP:
        raise ValueError(f"probe list width must be a multiple of "
                         f"{CANDS_PER_STEP} (pad with a count-0 dummy block)")
    if blk_counts.shape != (f_pad,) or blk_csum.shape != (f_pad,):
        raise ValueError("blk_counts and blk_csum must be (F_pad,)")
    for name, t in (("sel_ids", sel_ids), ("probe_ids", probe_ids),
                    ("blk_counts", blk_counts), ("blk_csum", blk_csum)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous int32 tensor")
        if t.device != x4.device:
            raise ValueError(f"{name} is on {t.device}, x4 on {x4.device}")


def score_blocks(x4, sel_ids, probe_ids, blk_counts, blk_csum, k, g=128,
                 q_blocks=1):
    """Exact top-k of each slot's rows against its probed fine blocks
    (module docstring).  Returns (negd (ns, q_blocks*g, k) float32
    descending, ids (ns, q_blocks*g, k) int32, compact coordinates)."""
    _check(x4, sel_ids, probe_ids, blk_counts, blk_csum, k, g, q_blocks)
    if x4.device.type == "cpu":
        return score_blocks_plain(x4, sel_ids, probe_ids, blk_counts,
                                  blk_csum, k, g=g, q_blocks=q_blocks)
    if x4.device.type != "cuda":
        raise ValueError(f"score_blocks runs on cuda or cpu, not {x4.device}")
    lib = _lib()
    ns, p = probe_ids.shape
    f_pad, _, d_pad = x4.shape
    mq = q_blocks * g
    negd = torch.empty((ns, mq, k), dtype=torch.float32, device=x4.device)
    idx = torch.empty((ns, mq, k), dtype=torch.int32, device=x4.device)
    if ns == 0:
        return negd, idx
    with torch.cuda.device(x4.device):
        stream = torch.cuda.current_stream(x4.device).cuda_stream
        err = lib.ivf_score_launch(
            x4.data_ptr(), sel_ids.data_ptr(), probe_ids.data_ptr(),
            blk_counts.data_ptr(), blk_csum.data_ptr(), ns, f_pad, g, d_pad,
            q_blocks, p, k, negd.data_ptr(), idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ivf_score launch failed with CUDA error {err}")
    _build.count_launch(KERNEL)
    return negd, idx


def score_blocks_plain(x4, sel_ids, probe_ids, blk_counts, blk_csum, k,
                       g=128, q_blocks=1):
    """Plain PyTorch version of the kernel, on any device.

    A few slots at a time, a few probed blocks at a time: direct-difference
    squared distances (``torch.cdist`` without the matmul expansion, so a
    row's distance to itself is an exact 0), dead candidate columns masked
    to +inf, and a running ``torch.topk`` merge.  Same contract as
    ``score_blocks``.
    """
    x4 = x4.to(torch.float32)
    dev = x4.device
    ns, p = probe_ids.shape
    f_pad, _, d_pad = x4.shape
    mq = q_blocks * g
    counts = blk_counts.long()
    csum = blk_csum.long()
    probes = probe_ids.long()
    valid = (probes >= 0) & (probes < f_pad)
    probes = probes.clamp(0, f_pad - 1)
    within = torch.arange(g, device=dev)
    inf = float("inf")

    step = max(1, min(p, _PLAIN_TILE_ELEMS // (mq * g)))  # blocks per step
    batch = max(1, _PLAIN_TILE_ELEMS // (mq * g * step))  # slots per batch
    out_d, out_i = [], []
    for lo in range(0, ns, batch):
        sel = sel_ids[lo:lo + batch].long()
        nb = sel.shape[0]
        qblk = sel[:, None] * q_blocks + torch.arange(q_blocks, device=dev)
        q_ok = (sel[:, None] >= 0) & (qblk < f_pad)
        qblk = qblk.clamp(0, f_pad - 1)
        q = x4[qblk].reshape(nb, mq, d_pad)
        q_live = (within[None, None, :]
                  < (counts[qblk] * q_ok)[:, :, None]).reshape(nb, mq)
        best_d = torch.full((nb, mq, k), inf, dtype=torch.float32,
                            device=dev)
        best_i = torch.zeros((nb, mq, k), dtype=torch.int64, device=dev)
        for j in range(0, p, step):
            ids = probes[lo:lo + nb, j:j + step]  # (nb, s)
            s = ids.shape[1]
            cand = x4[ids].reshape(nb, s * g, d_pad)
            d2 = torch.cdist(
                q, cand, compute_mode="donot_use_mm_for_euclid_dist") ** 2
            cnt = counts[ids] * valid[lo:lo + nb, j:j + step]
            col_live = (within[None, None, :] < cnt[:, :, None]).reshape(
                nb, 1, s * g)
            d2 = torch.where(col_live, d2, inf)
            comp = (csum[ids][:, :, None] + within).reshape(nb, 1, s * g)
            cat_d = torch.cat([best_d, d2], dim=2)
            cat_i = torch.cat([best_i, comp.expand(nb, mq, s * g)], dim=2)
            best_d, pos = torch.topk(cat_d, k, dim=2, largest=False,
                                     sorted=True)
            best_i = torch.gather(cat_i, 2, pos)
        found = q_live[:, :, None] & (best_d < inf)
        out_d.append(torch.where(found, -best_d, -inf))
        out_i.append(torch.where(found, best_i, 0).to(torch.int32))
    if not out_d:
        return (torch.empty((0, mq, k), dtype=torch.float32, device=dev),
                torch.empty((0, mq, k), dtype=torch.int32, device=dev))
    return torch.cat(out_d), torch.cat(out_i)


def _lib():
    lib = _build.load(KERNEL)
    if lib.ivf_score_launch.argtypes is None:  # first use: declare the C ABI
        lib.ivf_score_launch.restype = ctypes.c_int
        lib.ivf_score_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
            + [ctypes.c_void_p] * 3)
        limits = (lib.ivf_score_max_k(), lib.ivf_score_max_g(),
                  lib.ivf_score_max_d())
        if limits != (MAX_K, MAX_G, MAX_D):
            raise RuntimeError("ivf_score library limits disagree with "
                               "ops/ivf.py's MAX_K / MAX_G / MAX_D")
    return lib
