"""Device and numeric configuration for cna_tpu_torch.

The dtype policy is the TPU package's (``cna_tpu/config.py:26-49``):
float32 by default, float64 when x64 is on (for close agreement with the
reference on small data; on the card keep float32).

The device is chosen once per process.  The default is ``cuda``; without
a card the entry points raise ``RuntimeError`` unless the caller asked
for the CPU with ``set_device("cpu")`` (as the tests do).  Nothing falls
back to the CPU on its own.

TF32 is switched off for matmuls and convolutions at import: TF32 keeps
about three decimal digits and would move the PCA covariance, the Gram
SVD and the F-test products by about 1e-3.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_DEVICE: torch.device | None = None
_X64 = False


def set_device(dev) -> None:
    """Pin the device every entry point computes on ("cuda", "cuda:1",
    "cpu", a ``torch.device``); ``None`` restores the default (cuda)."""
    global _DEVICE
    _DEVICE = None if dev is None else torch.device(dev)


def device() -> torch.device:
    """The device entry points compute on.  Raises RuntimeError when the
    default (cuda) is asked for and no card is present."""
    dev = _DEVICE if _DEVICE is not None else torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cna_tpu_torch computes on a CUDA device by default and none is "
            "available; call cna_tpu_torch.config.set_device('cpu') to run "
            "on the CPU explicitly")
    return dev


def enable_x64(enable: bool = True) -> None:
    """Toggle float64 compute (for close agreement with the reference)."""
    global _X64
    _X64 = bool(enable)


def x64_enabled() -> bool:
    return _X64


def default_float() -> torch.dtype:
    """The working dtype for dense statistics (NAM, projections, tests)."""
    return torch.float64 if _X64 else torch.float32


def enable_runtime_checks(enable: bool = True) -> None:
    """Toggle the finiteness post-conditions on association outputs
    (``utils.checks.assert_finite``); on by default."""
    from .utils import checks

    checks.enable_runtime_checks(enable)
