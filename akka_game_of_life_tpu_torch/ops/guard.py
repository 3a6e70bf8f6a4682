"""Shared intermediate-size guard: refuse loudly, never allocate-and-die.

Copy of ``akka_game_of_life_tpu/ops/guard.py`` (it has no JAX in it) with
the same knob, so one ``GOL_INTERMEDIATE_CAP_MB`` bounds both packages.  A
path that materializes off-board intermediates (the plain LtL window sums
of ``ops/ltl.py``) prices them up front, compares against the cap and raises
a ``ValueError`` that names the shapes, the cap and the knob that raises it,
before anything is allocated.  ``nearest_3smooth`` is the width the
banded-matmul family's refusal suggests (``ops/matmul_stencil.py``).
"""

from __future__ import annotations

import os
from typing import Iterable, Tuple

CAP_ENV = "GOL_INTERMEDIATE_CAP_MB"
DEFAULT_CAP_MB = 8192


def intermediate_cap_bytes() -> int:
    """The active cap in bytes (``GOL_INTERMEDIATE_CAP_MB`` or the
    default), read per call."""
    try:
        mb = int(os.environ.get(CAP_ENV, DEFAULT_CAP_MB))
    except ValueError:
        raise ValueError(
            f"{CAP_ENV}={os.environ.get(CAP_ENV)!r} is not an integer MiB count"
        ) from None
    return mb * 2**20


def plane_bytes(shape: Tuple[int, ...], itemsize: int) -> int:
    """Bytes of one dense plane of ``shape`` at ``itemsize`` bytes/element."""
    total = itemsize
    for dim in shape:
        total *= int(dim)
    return total


def nearest_3smooth(n: int) -> int:
    """The smallest 3-smooth width (2^a · 3^b with b ≥ 1 and a ≥ 5, so
    32 | width keeps every packed layout eligible) that is ≥ ``n``: the pad
    target the matmul family's refusal suggests when a power-of-two width
    caps its f32 digit-packing depth at 2 (the depth must divide the width,
    and a width with a factor of 3 packs 3 to 6 digits)."""
    if n < 1:
        raise ValueError(f"width must be positive, got {n}")
    best = None
    b = 1
    while 3**b <= max(n, 96) * 2:
        a = 5
        while (3**b) << a < n:
            a += 1
        cand = (3**b) << a
        if best is None or cand < best:
            best = cand
        b += 1
    return best


def require_intermediates_fit(
    estimated_bytes: int,
    *,
    what: str,
    detail: str = "",
    shapes: Iterable[Tuple[Tuple[int, ...], int]] = (),
) -> None:
    """Raise ``ValueError`` if ``estimated_bytes`` exceeds the cap.
    ``what`` names the path, ``detail`` the remedy beyond raising the cap,
    ``shapes`` itemizes (shape, itemsize) planes for the message."""
    cap = intermediate_cap_bytes()
    if estimated_bytes <= cap:
        return
    itemized = "; ".join(
        f"{tuple(s)}x{i}B={plane_bytes(s, i) / 2**20:.0f}MiB" for s, i in shapes
    )
    raise ValueError(
        f"{what} would materialize ~{estimated_bytes / 2**20:.0f} MiB of "
        f"intermediates, over the {cap / 2**20:.0f} MiB cap"
        + (f" ({itemized})" if itemized else "")
        + " — refusing up front instead of allocate-and-die (the recorded "
        f"LtL OOM lesson, ops/ltl.py). "
        + (f"{detail} " if detail else "")
        + f"Raise {CAP_ENV} (MiB) to override."
    )
