"""The (cells, perms) mesh of slots, and tensors sharded over it.

The TPU package's ``parallel/mesh.py``.  The pipeline's two axes of scale
map onto a 2-D grid:

* ``cells`` — the long axis (up to millions).  The diffusion state and
  the neighborhood statistics are row-sharded over it.
* ``perms`` — the permutation-null axis (embarrassingly parallel).  Null
  phenotype columns, min-p batches and FDR tail counts shard over it and
  merge with tiny collectives.

The TPU package's mesh is single-controller: one process holds many
devices.  Here a ``Mesh`` is a grid of **slots**, each a (rank,
``torch.device``) pair, so one representation serves one process and
many: devices may repeat
(``make_mesh(["cpu"] * 8, perms=2)`` is the test mesh,
``make_mesh(["cuda:0"] * 4)`` the one-card mesh), and slots of other
ranks join through ``launch.global_mesh``.

A ``Sharded`` tensor is its mesh, its ``Spec`` (which tensor dimension is
split over which mesh axis, as a ``PartitionSpec`` says there) and this
process's shards.  Each block is kept once, on its **primary slot**: the
first slot in row-major order whose coordinates select the block (for a
spec over ``cells`` only, the slot at perms 0).  The collectives over
this container are in ``parallel.dist``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

CELLS = "cells"
PERMS = "perms"


@dataclasses.dataclass(frozen=True)
class Slot:
    """One place of the mesh: the process ``rank`` and its ``device``."""

    rank: int
    device: torch.device


def _this_rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _as_device(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device()
                           if torch.cuda.is_available() else 0)
    return dev


class Mesh:
    """A (cells, perms) grid of ``Slot``s."""

    axis_names = (CELLS, PERMS)

    def __init__(self, slots: np.ndarray):
        self.slots = slots
        self.rank = _this_rank()

    @property
    def devices(self) -> np.ndarray:
        """(cells, perms) object array of the slots' devices."""
        out = np.empty(self.slots.shape, dtype=object)
        for cp in np.ndindex(self.slots.shape):
            out[cp] = self.slots[cp].device
        return out

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.slots.shape))

    @property
    def size(self) -> int:
        return int(self.slots.size)

    @property
    def ranks(self) -> list:
        return sorted({s.rank for s in self.slots.flat})

    @property
    def multiprocess(self) -> bool:
        """Whether slots of other processes are part of the mesh."""
        return self.ranks != [self.rank]

    def is_local(self, cp) -> bool:
        return self.slots[cp].rank == self.rank

    def device(self, cp) -> torch.device:
        return self.slots[cp].device

    @property
    def local_slots(self) -> list:
        """This process's slot coordinates, in row-major order."""
        return [cp for cp in np.ndindex(self.slots.shape)
                if self.is_local(cp)]

    @property
    def lead_device(self) -> torch.device:
        """Device of this process's first slot: where gathered values and
        the unsharded stages of the pipeline live."""
        local = self.local_slots
        if not local:
            raise ValueError(f"rank {self.rank} holds no slot of this mesh")
        return self.device(local[0])

    def __repr__(self):
        return (f"Mesh({self.shape}, ranks={self.ranks}, devices="
                f"{sorted({str(s.device) for s in self.slots.flat})})")


def make_mesh(devices=None, cells: int | None = None, perms: int = 1) -> Mesh:
    """Build a (cells, perms) mesh over ``devices``.

    ``devices``: device names, ``torch.device``s or ``Slot``s (slots of
    other processes come from ``launch.global_mesh``); names may repeat.
    Default: every visible CUDA device; with none visible this raises, as
    ``config.device()`` does (the mesh never falls back to the CPU).
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() takes every visible CUDA device by default and "
                "none is available; pass devices= explicitly (for example "
                "['cpu'] * 8) to build a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    rank = _this_rank()
    slots = [d if isinstance(d, Slot) else Slot(rank, _as_device(d))
             for d in devices]
    n = len(slots)
    if cells is None:
        if n % perms:
            raise ValueError(f"{n} devices not divisible by perms={perms}")
        cells = n // perms
    if cells * perms > n:
        raise ValueError(
            f"mesh {cells}x{perms} needs {cells * perms} devices, have {n}")
    grid = np.empty((cells, perms), dtype=object)
    for i, s in enumerate(slots[: cells * perms]):
        grid[divmod(i, perms)] = s
    return Mesh(grid)


@dataclasses.dataclass(frozen=True)
class Spec:
    """Which dimension of a tensor is split over which mesh axis (an axis
    name or None per dimension, as the TPU package's ``PartitionSpec``)."""

    mesh: Mesh
    dims: tuple

    def parts(self, cp) -> tuple:
        """The block coordinates of slot ``cp``: one index per dimension
        (0 for an unsplit dimension)."""
        return tuple(0 if a is None else cp[self.mesh.axis_names.index(a)]
                     for a in self.dims)

    def is_primary(self, cp) -> bool:
        """Whether ``cp`` is the first slot holding its block: its
        coordinate is 0 on every mesh axis the spec does not split."""
        return all(c == 0 for a, c in zip(self.mesh.axis_names, cp)
                   if a not in self.dims)

    @property
    def primaries(self) -> list:
        return [cp for cp in np.ndindex(self.mesh.slots.shape)
                if self.is_primary(cp)]

    def bounds(self, shape, cp) -> tuple:
        """Slices of slot ``cp``'s block of a tensor of ``shape`` (the
        split of ``np.array_split``: leading blocks one longer)."""
        out = []
        for size, a, i in zip(shape, self.dims, self.parts(cp)):
            if a is None:
                out.append(slice(None))
            else:
                n = self.mesh.shape[a]
                q, r = divmod(int(size), n)
                lo = i * q + min(i, r)
                out.append(slice(lo, lo + q + (i < r)))
        return tuple(out)

    def block_shape(self, shape, cp) -> tuple:
        sl = self.bounds(shape, cp) + (slice(None),) * (len(shape)
                                                        - len(self.dims))
        return tuple(len(range(*s.indices(int(n))))
                     for s, n in zip(sl, shape))


def cell_rows(mesh: Mesh) -> Spec:
    """Rows sharded over the cell axis: (n_cells, ...) tensors."""
    return Spec(mesh, (CELLS,))


def cell_cols(mesh: Mesh) -> Spec:
    """Columns sharded over the cell axis: (S, n_cells) tensors (the NAM)."""
    return Spec(mesh, (None, CELLS))


def perm_cols(mesh: Mesh) -> Spec:
    """Columns sharded over the permutation axis: (n, Nnull) null matrices."""
    return Spec(mesh, (None, PERMS))


def cell_by_perm(mesh: Mesh) -> Spec:
    """(n_cells, Nnull) tensors sharded over both axes (null ncorrs)."""
    return Spec(mesh, (CELLS, PERMS))


def replicated(mesh: Mesh) -> Spec:
    return Spec(mesh, ())


@dataclasses.dataclass
class Sharded:
    """A tensor of global ``shape`` and ``dtype`` split by ``spec``:
    ``shards`` maps each of this process's primary slots to its block, on
    the slot's device.  ``np.asarray`` gives the global value
    (``parallel.dist.fetch``)."""

    spec: Spec
    shape: tuple
    dtype: torch.dtype
    shards: dict

    @property
    def mesh(self) -> Mesh:
        return self.spec.mesh

    @property
    def device(self) -> torch.device:
        return self.mesh.lead_device

    def __array__(self, dtype=None, copy=None):
        from .dist import fetch

        out = fetch(self)
        return out if dtype is None else out.astype(dtype)


def place(x, spec: Spec) -> Sharded:
    """Put ``x`` (a global tensor or array that every process holds) on
    the mesh: each of this process's primary slots gets its block, copied
    to its device."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    shards = {cp: x[spec.bounds(x.shape, cp)].to(spec.mesh.device(cp))
              for cp in spec.primaries if spec.mesh.is_local(cp)}
    return Sharded(spec, tuple(x.shape), x.dtype, shards)
