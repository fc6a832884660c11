"""Multi-process launch helpers.

The TPU package's ``parallel/launch.py``.  Every process runs the same
program (SPMD): ``initialize_distributed`` joins the default process
group of ``torch.distributed`` (NCCL when this process computes on a
card, gloo on the CPU), and ``global_mesh`` builds the (cells, perms)
mesh over every process's slots.  The pipeline stages
(``parallel.sharded``, ``parallel.halo``) are written against the mesh
and need no change across processes.

A two-card run, one process per card (``RANK`` 0 and 1)::

    from cna_tpu_torch.parallel import launch
    launch.initialize_distributed("10.0.0.1:29500", num_processes=2,
                                  process_id=rank)
    mesh = launch.global_mesh(perms=1)   # one slot on each card
    p = cna_tpu_torch.tl.association(data, y, "sample", mesh=mesh)

A process may also hold several slots (``local_devices=["cuda:0"] * 4``);
with NCCL all of a process's slots must be on its one card.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from .mesh import Slot, make_mesh


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, local_device_ids=None) -> None:
    """Join the process group (``torch.distributed.init_process_group``).

    ``coordinator_address``: ``"host:port"`` of rank 0 (a TCP store), or
    an init URL (``"tcp://..."``, ``"file:///..."``); None reads the
    ``MASTER_ADDR`` / ``MASTER_PORT`` environment (``env://``).
    ``num_processes`` / ``process_id``: world size and rank (None reads
    ``WORLD_SIZE`` / ``RANK``).  ``local_device_ids``: this process's
    CUDA device index (the first is used; default ``process_id`` modulo
    the visible cards).  The backend is NCCL when ``config.device()`` is a
    CUDA device, gloo when the caller asked for the CPU.  Call once per
    process, before any collective.
    """
    dist = torch.distributed
    if coordinator_address is None:
        init = "env://"
    elif "://" in str(coordinator_address):
        init = str(coordinator_address)
    else:
        init = f"tcp://{coordinator_address}"
    kwargs = dict(init_method=init)
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    if config.device().type == "cuda":
        if local_device_ids is not None:
            index = int(np.atleast_1d(local_device_ids)[0])
        else:
            index = int(process_id or 0) % torch.cuda.device_count()
        torch.cuda.set_device(index)
        kwargs["backend"] = "nccl"
        kwargs["device_id"] = torch.device("cuda", index)
    else:
        kwargs["backend"] = "gloo"
    dist.init_process_group(**kwargs)


def _local_default():
    dev = config.device()
    if dev.type == "cuda":
        return [torch.device("cuda", torch.cuda.current_device())]
    return [dev]


def global_mesh(perms: int = 1, local_devices=None):
    """(cells, perms) mesh over every process's slots, in rank order.

    ``local_devices``: this process's slots (device names, repeats
    allowed); default one slot on ``config.device()``.  Collective: every
    process of the group calls it.
    """
    local = [torch.device(d) for d in (local_devices or _local_default())]
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return make_mesh(local, perms=perms)
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, [str(d) for d in local])
    slots = [Slot(r, torch.device(d))
             for r, names in enumerate(per_rank) for d in names]
    return make_mesh(slots, perms=perms)


def process_info():
    """(process_index, process_count, local_device_count,
    global_device_count); the device counts are of the visible cards,
    or 1 per process on the CPU."""
    dist = torch.distributed
    active = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if active else 0
    world = dist.get_world_size() if active else 1
    local = (torch.cuda.device_count()
             if config.device().type == "cuda" else 1)
    return rank, world, local, local * world


def _digest(value):
    """Order-independent numeric digest of an array-like: (size, sum,
    |x| sum, max) — enough to catch any nondeterministic collective or
    divergent input without shipping the full array between hosts."""
    from .dist import fetch

    local = np.asarray(fetch(value), dtype=np.float64).ravel()
    mx = float(local.max()) if local.size else 0.0
    return np.array([float(local.size), float(local.sum()),
                     float(np.abs(local).sum()), mx])


def _check_digest_rows(rows, name, atol):
    """Raise if any process's digest deviates from process 0's.

    A NaN anywhere in the digest (the value itself contained NaN, even
    identically on every process) raises a dedicated error rather than a
    misattributed "cross-process disagreement" — ``allclose`` would flag
    NaN == NaN as a mismatch otherwise.
    """
    rows = np.atleast_2d(np.asarray(rows))
    if np.isnan(rows).any():
        raise RuntimeError(
            f"digest of {name!r} contains NaN — the checked value itself "
            "has NaN entries; fix the producing computation (this is not "
            "a cross-process disagreement)"
        )
    ref = rows[0]
    for pid, row in enumerate(rows[1:], start=1):
        if not np.allclose(row, ref, atol=atol, rtol=0.0):
            raise RuntimeError(
                f"cross-process disagreement on {name!r}: process {pid} "
                f"digest {row.tolist()} != process 0 digest {ref.tolist()}"
            )


def assert_agreement(value, name="value", atol=0.0):
    """Deterministic-collective assertion.

    Every process computes a numeric digest of ``value`` and all-gathers
    it through the process group (NCCL or gloo, a world of one included);
    a mismatch raises on every process, naming the first divergent one.
    Without a process group it checks this process's digest alone.
    ``atol`` admits benign reduction-order noise in float32 runs; the
    default demands bit-identical digests.
    """
    from .dist import _comm_device

    digest = _digest(value)
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        _check_digest_rows(digest[None, :], name, atol)
        return
    buf = torch.as_tensor(digest, device=_comm_device())
    rows = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
    dist.all_gather(rows, buf)
    _check_digest_rows(torch.stack(rows).cpu().numpy(), name, atol)
