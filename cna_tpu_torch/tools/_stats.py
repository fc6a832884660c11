"""Reference-compatible statistics namespace (``cna.tl._stats`` parity).

The reference keeps its permutation and FDR/FWER kernels in
``src/cna/tools/_stats.py`` (lines 4-105); downstream code sometimes
reaches them directly via attribute access (``import cna;
cna.tl._stats.tail_counts(...)``) or ``from cna.tools import _stats``.
This module provides the same names with the same call signatures,
implemented on the package's tensor programs (``ops.permutations``,
``ops.fdr``), following the TPU package's ``tools/_stats.py``.

Signature notes:

* ``conditional_permutation(B, Y, num)`` / ``grouplevel_permutation(G, Y,
  num)``: the reference draws from numpy's *global* seed
  (``_stats.py:12,31``).  A ``torch.Generator`` cannot replicate that
  stream bit for bit; these wrappers seed one from the numpy global
  stream, so ``np.random.seed(...)`` still makes runs reproducible, and
  the permutation *distribution* is identical.  Pass ``generator=`` (a
  ``torch.Generator`` on the configured device, or an integer seed) for
  determinism independent of numpy's state.
* ``grouplevel_permutation`` raises on a phenotype that is not constant
  within donor groups; the reference prints and returns ``None``
  (``_stats.py:28-30``); raising is the strictly safer behavior.
* The tail-count / FDR / FWER helpers are exact re-exports; they return
  tensors on the configured device (``utils.fetch`` converts).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..ops import permutations as _perms
from ..ops.fdr import (empirical_fdrs, empirical_fwers, minfwer_loo,
                       numtests, numtests_loo, tail_counts)
from ..utils.transfer import as_tensor

__all__ = [
    "conditional_permutation",
    "grouplevel_permutation",
    "tail_counts",
    "empirical_fdrs",
    "empirical_fwers",
    "minfwer_loo",
    "numtests",
    "numtests_loo",
]


def _generator(generator):
    """A ``torch.Generator`` on the configured device: the one given, one
    seeded with the integer given, or (None) one seeded from numpy's
    global stream, so ``np.random.seed`` governs reproducibility exactly
    as it does for the reference's ``np.random`` draws."""
    if isinstance(generator, torch.Generator):
        return generator
    seed = (int(np.random.randint(0, 2**31 - 1)) if generator is None
            else int(generator))
    gen = torch.Generator(device=config.device())
    gen.manual_seed(seed)
    return gen


def conditional_permutation(B, Y, num, generator=None):
    """Permute ``Y`` within each batch of ``B``, ``num`` times.

    Reference ``conditional_permutation`` (``_stats.py:4-18``): returns an
    (len(Y), num) tensor whose columns are independent within-batch
    permutations of ``Y``.
    """
    return _perms.conditional_permutation(
        _generator(generator), np.asarray(B),
        as_tensor(np.asarray(Y, dtype=float)), num)


def grouplevel_permutation(G, Y, num, generator=None):
    """Permute donor-level values of ``Y`` and broadcast back to samples.

    Reference ``grouplevel_permutation`` (``_stats.py:20-32``); requires
    ``Y`` constant within each group of ``G`` (raises otherwise).
    """
    return _perms.grouplevel_permutation(
        _generator(generator), np.asarray(G),
        as_tensor(np.asarray(Y, dtype=float)), num)
