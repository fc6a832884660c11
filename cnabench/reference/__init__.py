"""The plain reference of the benchmark: PyTorch and scipy only.

It imports nothing of ``cna_tpu_torch`` (nor ``jax`` / ``cna_tpu``) and
takes nothing the program made except the outputs it judges.  Every
function takes a ``Precision``: ``float64`` is the reference itself,
``tf32`` is the control (float32 storage, every dense product on operands
rounded to TF32, as the tensor cores take them).
"""

from __future__ import annotations

import torch

NAMES = ("float64", "tf32")


class Precision:
    """``float64``: the reference.  ``tf32``: float32 storage, dense
    products of TF32-rounded operands (10 explicit mantissa bits)
    accumulated in float32 - the nearest precision below the
    float32-with-TF32-off that the configurations state.  Sparse products
    have no TF32 form and stay float32."""

    def __init__(self, name: str):
        if name not in NAMES:
            raise ValueError(f"precision {name!r} is not one of {NAMES}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32
        self.tf32 = name == "tf32"

    def __repr__(self):
        return f"Precision({self.name!r})"


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 ``t`` to TF32 (round to nearest, ties to even),
    keeping float32 storage."""
    i = t.contiguous().view(torch.int32)
    i = i + (0x0FFF + ((i >> 13) & 1))
    return (i & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Dense product in ``prec`` (operands already in ``prec.dtype``)."""
    if prec.tf32:
        return to_tf32(a) @ to_tf32(b)
    return a @ b
