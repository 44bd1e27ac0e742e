"""ASCII P3 PPM codec, byte-compatible with the reference writer.

The reference writes `P3\\n<w> <h>\\n255\\n` then one line per row with
pixels separated by two spaces and channels by one (Code/image.cpp:53-83),
and reads P3 with comment skipping and [0,255] clamping
(Code/image.cpp:86-133).  write_ppm reproduces the writer's byte layout
exactly so golden files diff clean.  Pure Python and numpy.
"""

from __future__ import annotations

import numpy as np


def read_ppm(path: str) -> np.ndarray:
    """Read an ASCII P3 PPM file -> (H, W, 3) uint8.

    Raises ValueError on a non-P3 magic; values are clamped to [0,255]
    like the reference reader.
    """
    with open(path, "rb") as f:
        data = f.read()
    # Tokenize, dropping comment lines (# ... \n).
    tokens: list[bytes] = []
    for line in data.split(b"\n"):
        hash_idx = line.find(b"#")
        if hash_idx >= 0:
            line = line[:hash_idx]
        tokens.extend(line.split())
    if not tokens or tokens[0] != b"P3":
        raise ValueError(f"{path}: only P3 PPM format is supported")
    # The reference only warns when maxval != 255 (Code/image.cpp:118-120).
    w, h = int(tokens[1]), int(tokens[2])
    vals = np.array(tokens[4 : 4 + w * h * 3], dtype=np.int64)
    if vals.size != w * h * 3:
        raise ValueError(f"{path}: truncated pixel data")
    return np.clip(vals, 0, 255).astype(np.uint8).reshape(h, w, 3)


def write_ppm(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) uint8 as ASCII P3, matching the reference's exact
    separators: "  " between pixels, " " between channels, newline per row."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError("write_ppm expects uint8")
    h, w, _ = img.shape
    flat = img.reshape(h, w * 3)
    rows = []
    for y in range(h):
        row = flat[y]
        rows.append(
            "  ".join(
                f"{row[3*x]} {row[3*x+1]} {row[3*x+2]}" for x in range(w)
            )
        )
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        f.write("\n".join(rows))
        f.write("\n")
