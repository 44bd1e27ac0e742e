"""Seeds derived from the run's --seed: the same keys give the same seed."""

from __future__ import annotations

import zlib

_MASK = (1 << 64) - 1


def _mix(z: int) -> int:
    """splitmix64's finalizer."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def derive(seed: int, *keys) -> int:
    """A 63-bit seed from a run's seed and keys (ints or strings)."""
    z = _mix(int(seed) & _MASK)
    for k in keys:
        k = zlib.crc32(k.encode()) if isinstance(k, str) else int(k)
        z = _mix(z ^ (k & _MASK))
    return z >> 1
