"""What decides `correct` for frames: the program's bytes at sampled
pixels against independent renders of the same pixels by the plain
reference.

The reference renders each sampled pixel `copies` (M) times at the frame's
samples a pixel, each quantized as a frame is.  The number compared is the
excess error, in uint8 steps:

    excess_err = mean |program - mean(copies 1..M-1)|
                 - mean over j of |copy j - mean(the other M-1 copies)|

over every sampled pixel and channel: how much farther the program's bytes
lie from the reference's mean than a correct render of the same pixels
does, both measured against a mean of M-1 copies.  A correct frame reads
about 0 (its distance is a render's noise); a frame computed in a lower
precision, a biased frame, a frame of another view or with fewer samples a
pixel reads more.  A difference and not a ratio, so that an error much
smaller than the noise of a pixel still adds where a pixel has no noise.
"""

from __future__ import annotations

import numpy as np
import torch


def sample_pixels(width: int, height: int, count: int, rng: np.random.Generator):
    """`count` distinct pixels of the frame, drawn uniformly -> (x, y)."""
    idx = rng.choice(width * height, size=min(count, width * height), replace=False)
    return idx % width, idx // width


def excess_error(program: torch.Tensor, copies: torch.Tensor) -> float:
    """program: (P, 3) uint8; copies: (M, P, 3) uint8, M >= 3."""
    r = copies.double()
    m = r.shape[0]
    total = r.sum(dim=0)
    prog = (program.double() - (total - r[0]) / (m - 1)).abs().mean()
    loo = (r - (total - r) / (m - 1)).abs().mean()
    return float(prog - loo)
