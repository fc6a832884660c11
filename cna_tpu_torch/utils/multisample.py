"""Sample-level aggregation helpers (reference ``utils/multisample.py``)."""

from __future__ import annotations

import pandas as pd


def obs_to_sample(d, columns, sid_name, aggregate="mean"):
    """Aggregate per-cell ``obs`` columns to one row per sample.

    Mirrors reference ``obs_to_sample`` (``multisample.py:4-11``): groupby
    the sample-id column and aggregate (mean by default), indexed by the
    order samples first appear in ``obs`` (pandas ``unique`` order).
    """
    if isinstance(columns, str):
        columns = [columns]

    samplem = pd.DataFrame(index=pd.Index(d.obs[sid_name].unique(), name=sid_name))
    samplem[columns] = d.obs.groupby(by=sid_name)[columns].aggregate(aggregate)
    return samplem
