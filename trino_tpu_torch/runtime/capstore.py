"""Canonical capacity classes.

The port keeps only ``capacity_class`` of ``trino_tpu.runtime.capstore``:
the hash-join path sizes its bucket table and its slot width with it. The
persisted capacity store (adaptive narrowing, fragment fingerprints) is not
ported yet.
"""

from __future__ import annotations


def capacity_class(n: int, base: int = 1024) -> int:
    """The canonical 4x-spaced capacity class (``base``, 4*base, 16*base,
    ...): the smallest class ``>= n``. ``n`` exactly on a class edge
    resolves to that class (``capacity_class(4096) == 4096``); ``n <= 0``
    resolves to ``base``. A pure function of ``n``, as in the reference."""
    cap = base
    while cap < n:
        cap *= 4
    return cap
