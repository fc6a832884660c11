"""Permutation-null generation for the association test.

Replaces reference ``_stats.py:4-32``:

* ``conditional_permutation``: permute the phenotype independently within
  each batch, ``num`` times.  All batches and all permutations are one
  batched sort: order by a uniform random key, then stable-sort by batch
  id (torch has no multi-key sort), which yields a uniform within-batch
  permutation per null column, scattered back to the original batch
  layout.
* ``grouplevel_permutation``: permute donor-level phenotype values and
  broadcast back to samples (the phenotype must be constant within
  donor).

Random numbers come from an explicit ``torch.Generator``.  Neither
numpy's global-seed stream nor the TPU package's counter-based stream can
be replicated, so agreement with them is distributional; the association
layer accepts precomputed null matrices (``null_y``) for exact tests.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.transfer import fetch


def _encode_groups(values):
    """Host-side: map group labels to [0, G) ids in np.unique (sorted) order."""
    values = np.asarray(values)
    uniq, ids = np.unique(values, return_inverse=True)
    return uniq, ids.astype(np.int64)


def conditional_permutation(generator, batches, y, num):
    """Permute ``y`` within batches, ``num`` times.

    Args:
      generator: ``torch.Generator`` on ``y``'s device.
      batches: host array-like (n,) of batch labels.
      y: (n,) phenotype tensor.
      num: number of permutations.

    Returns (n, num) tensor whose columns are within-batch permutations
    of y.
    """
    n = y.shape[0]
    dev = y.device
    _, ids = _encode_groups(batches)
    # positions sorted stably by batch (the reference's concatenated
    # np.where layout); host-computable, no RNG involved
    pos_by_batch = torch.as_tensor(np.argsort(ids, kind="stable"),
                                   device=dev)
    batch_ids = torch.as_tensor(ids, device=dev)
    r = torch.rand((n, num), generator=generator, device=dev)
    by_key = torch.argsort(r, dim=0)  # (n, num) uniform random order
    by_batch = torch.sort(batch_ids[by_key], dim=0, stable=True).indices
    perm = torch.gather(by_key, 0, by_batch)  # batch-grouped, shuffled within
    out = torch.zeros((n, num), dtype=y.dtype, device=dev)
    out[pos_by_batch] = y[perm]
    return out


def grouplevel_permutation(generator, groups, y, num):
    """Permute donor-level values of ``y`` and broadcast to samples.

    Requires ``y`` constant within each group (reference ``_stats.py:28-30``
    prints an error and returns None; this raises, which is safer).
    """
    y_host = fetch(y)
    uniq, ids = _encode_groups(groups)
    ng = len(uniq)
    first = np.full(ng, -1, dtype=np.int64)
    for i in range(len(ids) - 1, -1, -1):
        first[ids[i]] = i
    yg = y_host[first]
    if np.any(yg[ids] != y_host):
        raise ValueError(
            "phenotype must be constant within each donor group for "
            "donor-level permutation"
        )
    dev = y.device
    yg = torch.as_tensor(yg, device=dev)
    r = torch.rand((ng, num), generator=generator, device=dev)
    order = torch.argsort(r, dim=0)
    yg_perm = yg[order]  # (ng, num)
    return yg_perm[torch.as_tensor(ids, device=dev)]  # (n, num)
