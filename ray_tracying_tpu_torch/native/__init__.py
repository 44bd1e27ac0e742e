"""Host C++ builders, loaded with ctypes: the LBVH build and the PPM codec.

`src/lbvh.cpp` builds the same tree as `accel/lbvh.py::build_lbvh` (Morton
sort of the box centroids, preorder median split, leaves of at most 4
geoms), and `src/ppm_codec.cpp` reads and writes the same ASCII P3 bytes as
the Python codec of `io/ppm.py`; the numpy build and the Python codec stay
as their plain versions, and the tests hold these against them bit for bit.

The sources are compiled by `g++ -std=c++17 -O3 -shared -fPIC` into ONE
library at the first call that needs it, never at import, under a name
that carries the hash of the sources and flags (in the package's `build/`,
beside the CUDA kernels' library).  A failed build or load raises with the
compiler's output; there is no other path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
BUILD_DIR = os.path.join(PKG_DIR, "build")
CXX = "g++"
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

_lib = None
# What the last build or reuse did: path, seconds, whether g++ ran.
last_build: dict = {}


def build() -> str:
    """Compile src/*.cpp if no library of the current sources and flags
    exists yet; returns the library's path."""
    srcs = sorted(os.path.join(SRC_DIR, n) for n in os.listdir(SRC_DIR) if n.endswith(".cpp"))
    h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode())
    for path in srcs:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    lib_path = os.path.join(BUILD_DIR, f"libnative-{h.hexdigest()[:16]}.so")
    t0 = time.time()
    ran = not os.path.exists(lib_path)
    if ran:
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [CXX, *CXX_FLAGS, "-o", tmp, *srcs]
        os.makedirs(BUILD_DIR, exist_ok=True)
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"{CXX} could not run: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"{CXX} failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib_path)
    last_build.update(path=lib_path, seconds=time.time() - t0, compiled=ran)
    return lib_path


def load() -> ctypes.CDLL:
    """The builders' library, built at the first call.  Every pointer is
    declared c_void_p (undeclared, ctypes would cut it to 32 bits)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.ppm_read_header.argtypes = [ctypes.c_char_p, ctypes.POINTER(i32),
                                        ctypes.POINTER(i32)]
        lib.ppm_read_pixels.argtypes = [ctypes.c_char_p, p, i64]
        lib.ppm_write.argtypes = [ctypes.c_char_p, p, i32, i32]
        for fn in (lib.ppm_read_header, lib.ppm_read_pixels, lib.ppm_write):
            fn.restype = ctypes.c_int
        lib.lbvh_build.argtypes = [p, i64, i32, p, p, p]
        lib.lbvh_build.restype = i64
        _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def lbvh_build(aabbs: np.ndarray, leaf_size: int):
    """-> (boxes (M, 6) f32, topo (M, 4) int32, order (G,) int64), the
    arrays of accel/lbvh.py::build_lbvh for the same (G, 6) boxes."""
    aabbs = np.ascontiguousarray(aabbs, np.float32)
    if aabbs.ndim != 2 or aabbs.shape[1] != 6:
        raise ValueError(f"aabbs must be (G, 6), not {aabbs.shape}")
    g = aabbs.shape[0]
    if g == 0:
        # build_lbvh's tree over no geoms: one empty leaf
        return (np.zeros((1, 6), np.float32), np.array([[-1, -1, 0, 0]], np.int32),
                np.zeros(0, np.int64))
    if g >= 1 << 31:
        raise ValueError(f"{g} geoms: the native LBVH indexes them with int32")
    boxes = np.empty((2 * g - 1, 6), np.float32)
    topo = np.empty((2 * g - 1, 4), np.int32)
    order = np.empty(g, np.int64)
    n = load().lbvh_build(_ptr(aabbs), g, leaf_size, _ptr(boxes), _ptr(topo), _ptr(order))
    if n < 0:
        raise RuntimeError(f"lbvh_build failed ({n})")
    return boxes[:n].copy(), topo[:n].copy(), order


_READ_ERRORS = {
    -2: "only P3 PPM format is supported",
    -3: "no width and height of at least 0 in the header",
    -5: "truncated pixel data",
    -6: "a pixel value is not an integer",
}


def ppm_read(path: str) -> np.ndarray:
    """Read an ASCII P3 PPM file -> (H, W, 3) uint8, values clamped to
    [0, 255] like the reference reader.  The file is taken as the Python
    codec takes it: any comments, a leading sign, values past w*h*3
    ignored (src/ppm_codec.cpp states the grammar)."""
    lib = load()
    w, h = ctypes.c_int32(), ctypes.c_int32()
    err = lib.ppm_read_header(os.fsencode(path), ctypes.byref(w), ctypes.byref(h))
    if err == 0:
        out = np.empty((h.value, w.value, 3), np.uint8)
        err = lib.ppm_read_pixels(os.fsencode(path), _ptr(out), out.size)
    if err == -1:
        raise FileNotFoundError(path)
    if err == -7:
        raise OverflowError(f"{path}: a pixel value is outside the int64 range")
    if err:
        raise ValueError(f"{path}: {_READ_ERRORS.get(err, f'error {err}')}")
    return out


def ppm_write(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) uint8 as ASCII P3 with the reference writer's bytes."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"the PPM writer takes (H, W, 3) uint8, not {img.shape} {img.dtype}")
    h, w, _ = img.shape
    err = load().ppm_write(os.fsencode(path), _ptr(img), w, h)
    if err:
        raise OSError(f"{path}: writing the PPM failed ({err})")
