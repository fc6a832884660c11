"""Runtime numeric post-conditions.

``assert_finite`` is an always-on check on the pipeline's small host-side
outputs (global p, min-p nulls, neighbourhood coefficients, FDR curve).
An output NaN/Inf is always a framework bug or degenerate input, and the
check costs microseconds, so it is on by default
(``cna_tpu_torch.config.enable_runtime_checks(False)`` to opt out).
"""

from __future__ import annotations

import numpy as np

_RUNTIME_CHECKS = True


def enable_runtime_checks(enable: bool = True) -> None:
    global _RUNTIME_CHECKS
    _RUNTIME_CHECKS = bool(enable)


def runtime_checks_enabled() -> bool:
    return _RUNTIME_CHECKS


def assert_finite(**named_arrays) -> None:
    """Raise FloatingPointError naming the first non-finite output.

    No-op when runtime checks are disabled.  Accepts arrays or scalars;
    None values are skipped (optional outputs).
    """
    if not _RUNTIME_CHECKS:
        return
    for name, value in named_arrays.items():
        if value is None:
            continue
        arr = np.asarray(value)
        if arr.dtype.kind not in "fc":
            continue
        if not np.isfinite(arr).all():
            n_bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(
                f"association produced {n_bad} non-finite value(s) in "
                f"{name!r} (shape {arr.shape}). This indicates a numeric "
                "bug in the pipeline or degenerate input (e.g. a constant "
                "phenotype or an empty graph)."
            )
