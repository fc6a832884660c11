"""Collectives over ``mesh.Sharded`` tensors, and host access to them.

The TPU package's ``parallel/dist.py`` (``fetch`` / ``fetch_many``) plus
the collectives that the TPU package's runtime inserts on its own.  Each
is a plain function over the container of ``parallel.mesh``:

* ``gather`` — the global value on this process's lead device: the
  blocks concatenated when every slot is local, an ``all_gather`` across
  processes otherwise;
* ``psum`` — a sum over slots: the local parts added, then an
  ``all_reduce`` across processes;
* ``ppermute`` — the ring exchange of the halo rounds: a producer ->
  consumer pair whose slots are both in this process is a tensor copy to
  the consumer's device (a peer copy between two cards, a device-local
  copy on one); a pair across processes is one ``isend`` / ``irecv`` of a
  single ``batch_isend_irecv``.

So the single-process CPU mesh, the one-card mesh and a multi-node run
execute the same code.  Across processes the collectives ride the
default process group of ``torch.distributed`` (``launch``): gloo on CPU
slots, NCCL on CUDA slots.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh, Sharded


def _comm_device() -> torch.device:
    """Where the process group's buffers live: this process's card for
    NCCL, the host for gloo."""
    dist = torch.distributed
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _check_group(mesh: Mesh):
    world = torch.distributed.get_world_size()
    if mesh.ranks != list(range(world)):
        raise ValueError(f"a mesh across processes must hold slots of every "
                         f"rank of the process group (ranks {mesh.ranks}, "
                         f"world size {world})")


def gather(x: Sharded) -> torch.Tensor:
    """The global value of ``x`` on its mesh's lead device, on every
    process."""
    mesh, spec = x.mesh, x.spec
    dev = mesh.lead_device
    blocks = {cp: t.to(dev) for cp, t in x.shards.items()}
    if mesh.multiprocess:
        _check_group(mesh)
        dtype = x.dtype
        sizes = {r: sum(int(np.prod(spec.block_shape(x.shape, cp)))
                        for cp in spec.primaries
                        if mesh.slots[cp].rank == r)
                 for r in mesh.ranks}
        width = max(sizes.values())
        cdev = _comm_device()
        mine = [blocks[cp].reshape(-1) for cp in spec.primaries
                if cp in blocks]
        buf = torch.zeros(width, dtype=dtype, device=cdev)
        if mine:
            flat = torch.cat(mine).to(cdev)
            buf[:flat.numel()] = flat
        bufs = [torch.empty_like(buf) for _ in mesh.ranks]
        torch.distributed.all_gather(bufs, buf)
        offset = dict.fromkeys(mesh.ranks, 0)
        for cp in spec.primaries:
            r = mesh.slots[cp].rank
            shape = spec.block_shape(x.shape, cp)
            n = int(np.prod(shape))
            blocks[cp] = bufs[r][offset[r]:offset[r] + n].reshape(
                shape).to(dev)
            offset[r] += n
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    for cp in spec.primaries:
        out[spec.bounds(x.shape, cp)] = blocks[cp]
    return out


def fetch(x) -> np.ndarray:
    """The GLOBAL value of ``x`` (``Sharded``, tensor, array or scalar) as
    a host numpy array, on every process."""
    if isinstance(x, Sharded):
        x = gather(x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def fetch_many(*xs):
    """Pull several values to the host, in order."""
    return tuple(fetch(x) for x in xs)


def psum(mesh: Mesh, parts, shape, dtype) -> torch.Tensor:
    """Sum of the tensors ``parts`` (this process's contributions, any
    devices, each of ``shape`` and ``dtype``; there may be none) over
    every process of ``mesh``, on its lead device."""
    dev = mesh.lead_device
    total = torch.zeros(shape, dtype=dtype, device=dev)
    for t in parts:
        total = total + t.to(dev)
    if mesh.multiprocess:
        _check_group(mesh)
        buf = total.to(_comm_device()).contiguous()
        torch.distributed.all_reduce(buf)
        total = buf.to(dev)
    return total


def ppermute(mesh: Mesh, rounds):
    """Ring exchanges over the ``cells`` axis, all rounds posted at once.

    ``rounds``: a list of (sends, pairs, recv_shape, dtype): ``sends``
    maps this process's producer slots to the (recv_shape) tensor each
    ships; ``pairs`` lists (producer, consumer) slot coordinates.  Returns
    one dict per round mapping this process's consumer slots to what they
    received, on the consumer's device (a slot that receives nothing is
    absent; ``lax.ppermute`` gives it zeros).
    """
    out = []
    ops, pending = [], []
    for t, (sends, pairs, shape, dtype) in enumerate(rounds):
        got = {}
        for src, dst in pairs:
            if not mesh.is_local(dst):
                if mesh.is_local(src):
                    buf = sends[src].to(_comm_device()).contiguous()
                    ops.append(torch.distributed.P2POp(
                        torch.distributed.isend, buf, mesh.slots[dst].rank,
                        tag=_tag(mesh, t, dst)))
                continue
            if mesh.is_local(src):
                got[dst] = sends[src].to(mesh.device(dst))
            else:
                buf = torch.empty(shape, dtype=dtype, device=_comm_device())
                ops.append(torch.distributed.P2POp(
                    torch.distributed.irecv, buf, mesh.slots[src].rank,
                    tag=_tag(mesh, t, dst)))
                pending.append((t, dst, buf))
        out.append(got)
    if ops:
        _check_group(mesh)
        for req in torch.distributed.batch_isend_irecv(ops):
            req.wait()
        for t, dst, buf in pending:
            out[t][dst] = buf.to(mesh.device(dst))
    return out


def _tag(mesh: Mesh, t: int, dst) -> int:
    """A message's tag: its round and consumer slot (gloo matches on it;
    NCCL matches sends and receives in posting order, the same on both
    sides)."""
    return t * mesh.size + dst[0] * mesh.shape["perms"] + dst[1]


def broadcast_object(mesh: Mesh, value):
    """``value`` as the mesh's first rank holds it, on every process
    (identity within one process)."""
    if not mesh.multiprocess:
        return value
    _check_group(mesh)
    box = [value]
    torch.distributed.broadcast_object_list(box, src=mesh.ranks[0])
    return box[0]
