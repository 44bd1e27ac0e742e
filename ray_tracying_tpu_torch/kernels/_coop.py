"""Work counters of the cooperative kernels (wave_level, occlusion_any and
the chunk kernels).

Each launch takes five int32 of device memory that are zero at launch and
that the last block of the launch zeroes again.  There is one set per
device and stream, so that launches in flight at once never share one;
launches on one stream run in turn and share it.
"""

from __future__ import annotations

import torch

_COUNTERS: dict = {}


def work_counters(device, stream: int) -> torch.Tensor:
    """The counters of launches on `stream` of `device`."""
    key = (device, stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(5, dtype=torch.int32, device=device)
    return _COUNTERS[key]
