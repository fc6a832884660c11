"""What the nearest-neighbour kernels share: the widths they are compiled
for and the error terms of their TF32 candidate filter.

``csrc/dist_tile.cuh`` holds the filter, the proof of its error bound and
the rule the terms enter (``filter_threshold``); ``ops/knn.py`` and
``ops/ivf.py`` both take ``(eps, gam)`` from ``filter_bound`` here.
"""

from __future__ import annotations

MAX_D = 128
# the row widths the kernels are compiled for
D_PADS = (4, 8, 12, 16, 20, 24, 28, 32, 48, 64, 96, 128)


def kernel_d_pad(d: int) -> int:
    """The compiled width for ``d`` coordinates: the smallest width the
    kernels are compiled for (rows then start on 16-byte boundaries)."""
    for w in D_PADS:
        if w >= d:
            return w
    raise ValueError(f"the distance-tile kernels support at most {MAX_D} "
                     f"coordinates; got {d}")


def filter_bound(d_pad: int) -> tuple:
    """``(eps, gam)`` of the kernels' candidate filter for a row width.

    With ``q'`` and ``x'`` the rows centred on a vector ``c`` that both
    share, the TF32 key ``T = (1 - eps) |x'|^2 - 2 q'.x'`` satisfies
    ``|q - x|^2 >= T + (1 - eps) |q'|^2`` and a candidate is dropped only
    when ``T >= tau (1 + gam) - (1 - eps) |q'|^2``, which no candidate
    whose float32 distance beats the row's current k-th distance ``tau``
    can reach (``csrc/dist_tile.cuh``).  ``v = 2^-10`` covers both
    rounding to nearest and truncation to TF32's 11 significand bits,
    ``u = 2^-24`` is float32's unit roundoff, and the products run in
    ``ceil(d_pad / 8)`` k-steps."""
    if not 1 <= d_pad <= MAX_D:
        raise ValueError(f"d_pad must lie in [1, {MAX_D}]; got {d_pad}")
    u, v = 2.0 ** -24, 2.0 ** -10
    k_steps = -(-d_pad // 8)
    eps = 2 * v + v * v + (36 * k_steps + 2 * d_pad + 16) * u
    gam = 2 * (d_pad + 8) * u
    return eps, gam
