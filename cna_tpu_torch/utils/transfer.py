"""Moving arrays between the host and the compute device.

``fetch`` is the single-device counterpart of the TPU package's
``parallel/dist.py:29-42`` (which also gathers arrays sharded over
processes; the port has no multi-process path yet): every host pull in
the pipeline goes through it, or through ``scalar`` for one number.
Each tensor pulled adds one to the ``host_reads`` counter of the open
``utils.profiling`` span, on every device: on a card each read waits
for the queue to drain.  ``as_tensor`` is the counterpart of
``jnp.asarray`` under the dtype policy of ``config``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from . import profiling


def fetch(x) -> np.ndarray:
    """``x`` (tensor, array or scalar) as a host numpy array."""
    if isinstance(x, torch.Tensor):
        profiling.count("host_reads")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def scalar(x):
    """``x`` (a one-element tensor, or a host number) as a Python
    number."""
    if isinstance(x, torch.Tensor):
        profiling.count("host_reads")
        return x.item()
    return x


def fetch_many(*xs):
    """Pull several tensors to the host, in order."""
    return tuple(fetch(x) for x in xs)


def to_device(x, device, dtype=None) -> torch.Tensor:
    """``x`` (tensor or array-like, dtype kept unless given) on ``device``."""
    if not isinstance(x, torch.Tensor):
        arr = np.asarray(x)
        # torch warns on read-only arrays (e.g. pandas .to_numpy() views)
        x = torch.as_tensor(arr if arr.flags.writeable else arr.copy())
    return x.to(device=device, dtype=dtype)


def as_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a floating tensor on ``device`` (default: the configured
    device).  float64 stays float64 only when x64 is on, as a float64
    numpy array does under the TPU package's ``jnp.asarray``; other
    floats keep their width down to float32; non-float input becomes the
    default float."""
    dev = config.device() if device is None else torch.device(device)
    t = to_device(x, "cpu") if not isinstance(x, torch.Tensor) else x
    if t.dtype == torch.float64:
        dtype = config.default_float()
    elif t.is_floating_point():
        dtype = torch.float32
    else:
        dtype = config.default_float()
    return t.to(device=dev, dtype=dtype)
