"""The diffusion of ``reference.assoc.diffuse`` at a cohort's size: the
same arithmetic, with the state updated in place and the stopping rule's
statistics taken over blocks of cells, so that a float64 NAM of 10^9
entries is held about twice, not five or six times.

* ``t = s / c`` overwrites ``s``; ``s <- A t + t`` adds ``t`` into the
  product; the median over cells of the excess kurtosis of ``s / C`` is
  taken over blocks of at most ``BLOCK`` entries.
* ``watch(step, s, counts)`` sees the unnormalized state of every step
  (the NAM of that step is ``(s / counts)'``) and reads it by blocks too.
* The NAM comes back as a (samples, cells) view of the (cells, samples)
  state divided in place.
"""

from __future__ import annotations

import torch

from . import Precision
from . import assoc as ref_assoc

BLOCK = 1 << 25  # entries of a block of cells' statistics


def row_blocks(n, width):
    """(lo, hi) of the blocks of at most ``BLOCK`` entries of ``n`` rows
    of ``width`` entries."""
    rows = max(1, BLOCK // max(width, 1))
    return [(lo, min(lo + rows, n)) for lo in range(0, n, rows)]


def diffuse(keys, vals, n, codes, n_samples, prec: Precision, watch=None):
    """The NAM (samples x cells, a view) and the steps taken; the steps
    and the rule of ``reference.assoc.diffuse``."""
    a = ref_assoc.adjacency(keys, vals, n, prec)
    colsums = torch.zeros(n, dtype=prec.dtype, device=keys.device)
    colsums.index_add_(0, keys % n, vals.to(prec.dtype))
    colsums += 1.0
    codes = torch.as_tensor(codes, device=keys.device).long()
    counts = torch.bincount(codes, minlength=n_samples).to(prec.dtype)
    s = torch.zeros((n, n_samples), dtype=prec.dtype, device=keys.device)
    s[torch.arange(n, device=keys.device), codes] = 1.0
    blocks = row_blocks(n, n_samples)
    prev = torch.tensor(float("inf"), dtype=prec.dtype)
    steps = 0
    for steps in range(1, ref_assoc.MAX_STEPS + 1):
        s.div_(colsums[:, None])
        nxt = torch.sparse.mm(a, s)
        nxt.add_(s)
        s = nxt
        del nxt
        kurt = torch.cat([ref_assoc.kurtosis_rows(s[lo:hi] / counts[None, :])
                          for lo, hi in blocks])
        medk = ref_assoc.median(kurt).cpu()
        del kurt
        if watch is not None:
            watch(steps, s, counts)
        if steps >= 3 and bool(prev - medk < 3):
            break
        prev = medk
    return s.div_(counts[None, :]).T, steps
