"""ASCII P3 PPM codec, byte-compatible with the reference writer.

The reference writes `P3\\n<w> <h>\\n255\\n` then one line per row with
pixels separated by two spaces and channels by one (Code/image.cpp:53-83),
and reads P3 with comment skipping and [0,255] clamping
(Code/image.cpp:86-133).  write_ppm reproduces the writer's byte layout
exactly so golden files diff clean.

`read_ppm` and `write_ppm` run the native codec (native/src/ppm_codec.cpp,
built at first use); `read_ppm_plain` and `write_ppm_plain`, in Python and
numpy, are its plain versions, which the tests hold it against byte for
byte.
"""

from __future__ import annotations

import numpy as np

from ray_tracying_tpu_torch import native


def read_ppm(path: str) -> np.ndarray:
    """Read an ASCII P3 PPM file -> (H, W, 3) uint8, through the native
    codec.  Raises ValueError on a non-P3 magic or truncated data; values
    are clamped to [0,255] like the reference reader."""
    return native.ppm_read(path)


def write_ppm(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) uint8 as ASCII P3 through the native codec, with the
    reference writer's separators: "  " between pixels, " " between
    channels, newline per row."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError("write_ppm expects uint8")
    native.ppm_write(path, img)


def read_ppm_plain(path: str) -> np.ndarray:
    """Read an ASCII P3 PPM file -> (H, W, 3) uint8 (the Python codec).

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


def write_ppm_plain(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) uint8 as ASCII P3, matching the reference's exact
    separators: "  " between pixels, " " between channels, newline per row
    (the Python codec)."""
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
