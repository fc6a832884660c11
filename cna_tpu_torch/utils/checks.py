"""Runtime numeric sanitizers.

1. ``assert_finite`` is an always-on check on the pipeline's small
   host-side outputs (global p, min-p nulls, neighbourhood coefficients,
   FDR curve).  An output NaN/Inf is always a framework bug or degenerate
   input, and the check costs microseconds, so it is on by default
   (``cna_tpu_torch.config.enable_runtime_checks(False)`` to opt out).
2. ``checkify_float_checks(fn)`` runs ``fn`` under ``FloatChecks``, a
   dispatch mode that checks the floating outputs of every tensor op
   inside it and raises on the first op that made a NaN or Inf: the
   counterpart of the TPU package's checkify float checks.
3. ``cna_tpu_torch.config.enable_debug_nans`` keeps the same mode on
   until it is switched off.

The hand-written CUDA kernels are called through ctypes and bypass the
dispatcher, so their wrappers hand their outputs to ``kernel_outputs``,
which checks them for NaN while a mode is on.  Both are for debugging:
every op then waits for the device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

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


# ops whose outputs are allocated, not computed: their contents are
# whatever the allocator held
_ALLOCATING = frozenset({"empty", "empty_like", "empty_strided",
                         "new_empty", "new_empty_strided", "resize_",
                         "set_"})


def _floats(tree):
    leaves, _ = tree_flatten(tree)
    return [t for t in leaves if isinstance(t, torch.Tensor)
            and t.layout == torch.strided
            and (t.is_floating_point() or t.is_complex()) and t.numel()]


def _any_nonfinite(args, kwargs) -> bool:
    """Whether an input of an op (a tensor or a Python number) already
    holds a NaN or Inf: then one in its output is passed on, not made."""
    leaves, _ = tree_flatten((args, kwargs))
    for v in leaves:
        if isinstance(v, float) and not np.isfinite(v):
            return True
    return any(not bool(torch.isfinite(t).all()) for t in _floats(leaves))


def _where() -> str:
    from .profiling import open_phases

    phases = open_phases()
    return f" in phase {phases[-1]!r} ({' > '.join(phases)})" if phases \
        else " (no profiling phase open)"


class FloatChecks(TorchDispatchMode):
    """Raises ``FloatingPointError`` at the first tensor op whose floating
    output holds a NaN or Inf that none of its inputs held, naming the op
    and the ``utils.profiling`` phases open at the time (NaN or Inf passed
    on from an input, or written from a constant such as
    ``full_like(x, inf)``, is allowed: it was made earlier or on
    purpose)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.overloadpacket.__name__ in _ALLOCATING:
            return out
        bad = [t for t in _floats(out) if not bool(torch.isfinite(t).all())]
        if bad and not _any_nonfinite(args, kwargs):
            what = "NaN" if any(bool(torch.isnan(t).any()) for t in bad) \
                else "Inf"
            raise FloatingPointError(
                f"{func} made a {what} from finite inputs{_where()}")
        return out

    def __enter__(self):
        global _MODES_ON
        _MODES_ON += 1
        return super().__enter__()

    def __exit__(self, *exc):
        global _MODES_ON
        _MODES_ON -= 1
        return super().__exit__(*exc)


_MODES_ON = 0
_DEBUG_MODE: FloatChecks | None = None


def kernel_outputs(kernel: str, *tensors) -> None:
    """Called by each CUDA kernel's wrapper after its launch: while a
    ``FloatChecks`` mode is on, raise if an output holds a NaN.  (Inf is
    allowed: a missing neighbour is -inf by contract.)"""
    if not _MODES_ON:
        return
    if any(bool(torch.isnan(t).any()) for t in _floats(tensors)):
        raise FloatingPointError(
            f"kernel {kernel!r} wrote a NaN into its output{_where()}")


def checkify_float_checks(fn):
    """Wrap ``fn``: the returned callable, with the same signature, runs
    ``fn`` under ``FloatChecks`` and raises ``FloatingPointError`` on a
    NaN / Inf made anywhere inside it."""

    def wrapper(*args, **kwargs):
        with FloatChecks():
            return fn(*args, **kwargs)

    return wrapper


def set_debug_mode(enable: bool) -> None:
    """Push (``True``) or pop (``False``) the process's ``FloatChecks``
    mode; see ``config.enable_debug_nans``."""
    global _DEBUG_MODE
    if enable and _DEBUG_MODE is None:
        _DEBUG_MODE = FloatChecks()
        _DEBUG_MODE.__enter__()
    elif not enable and _DEBUG_MODE is not None:
        mode, _DEBUG_MODE = _DEBUG_MODE, None
        mode.__exit__(None, None, None)
