"""Build the CUDA kernels at first use and load them with ctypes.

`csrc/*.cu` are compiled by `nvcc` into ONE shared library with a plain C
interface — no PyTorch headers, so a build takes seconds.  The library
lands in `<package>/build/` under a name that carries the hash of the
sources and flags: a changed source or flag builds a new file, an
unchanged one is reused.  Nothing here runs at import: the first kernel
launch calls `load()`.  A failed build raises with the compiler's output;
there is no other path.

The build runs with --fmad=false: no FMA contraction, which keeps the
kernels' arithmetic equal to the plain PyTorch versions term by term (see
csrc/wavefront.cu).  `load_variant(fmad=True)` builds the contracted
variant beside it for the one measurement that compares the two
(chip_smoke.py); nothing in the package calls it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # One compilation per source file, all at once.
    "--threads", "0",
    # Print registers, shared memory and spills of every kernel.
    "-Xptxas", "-v",
)

_lib = None
# What the last build or reuse did: path, seconds, whether nvcc ran, and
# nvcc's output (the -Xptxas -v resource report).
last_build: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, in CUDA_HOME and in /usr/local/cuda):"
        " the CUDA kernels cannot be built"
    )


def _sources():
    names = sorted(os.listdir(CSRC_DIR))
    cu = [os.path.join(CSRC_DIR, n) for n in names if n.endswith(".cu")]
    hdr = [os.path.join(CSRC_DIR, n) for n in names if n.endswith(".cuh")]
    return cu, hdr


def build(fmad: bool = False) -> str:
    """Compile csrc/*.cu if no library of the current sources and flags
    exists yet; returns the library's path."""
    cu, hdr = _sources()
    flags = NVCC_FLAGS + (f"--fmad={'true' if fmad else 'false'}",)
    h = hashlib.sha256(" ".join(flags).encode())
    for path in cu + hdr:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    lib_path = os.path.join(BUILD_DIR, f"libwavefront-{h.hexdigest()[:16]}.so")
    t0 = time.time()
    log = ""
    ran = not os.path.exists(lib_path)
    if ran:
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *flags, "-o", tmp, *cu]
        os.makedirs(BUILD_DIR, exist_ok=True)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}"
            )
        os.replace(tmp, lib_path)
    last_build.update(
        path=lib_path, seconds=time.time() - t0, compiled=ran, log=log,
        flags=" ".join(flags),
    )
    return lib_path


def load_variant(fmad: bool) -> ctypes.CDLL:
    """Build and open the library with FMA contraction as asked.  Every
    pointer and the stream are declared c_void_p: undeclared, ctypes would
    pass them as 32-bit ints and cut the addresses."""
    lib = ctypes.CDLL(build(fmad))
    p, i = ctypes.c_void_p, ctypes.c_int
    level = [
        p, p, p, p, p, p, p,                 # q fuzz table lights tex twh out
        ctypes.c_longlong, i, i, i,          # R G n_cols n_lights
        ctypes.POINTER(ctypes.c_int), i,     # ranges n_ranges
        i, i,                                # glossy has_tex
        i, i, i,                             # n_tex tex_h tex_w
        ctypes.c_float,                      # min_tp
        i, i, i, i,                          # motion refraction area_mask nss
    ]
    lib.wave_level_launch.argtypes = level + [
        i, i,                                # record build
        p, p, p, ctypes.POINTER(ctypes.c_int), i,  # xf perm_rows windows window_ranges n_win
        p, p, p, p,                          # work ctr live stream
    ]
    lib.wave_level_lane_launch.argtypes = level + [i, p]      # threads stream
    # G n_cols n_lights build n_win out
    lib.wave_level_plan.argtypes = [i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.wave_level_launch, lib.wave_level_lane_launch, lib.wave_level_plan):
        fn.restype = i
    ranges = ctypes.POINTER(ctypes.c_int)
    closest = [p, p, p, p, ctypes.c_longlong, i, ranges, i, i]  # rays table t id R G ranges n motion
    closest_n = [p, p, p, p, p, ctypes.c_longlong, i, ranges, i, i]  # ... t id n ...
    lib.brute_closest_launch.argtypes = closest + [p, p, p]          # ctr live stream
    lib.brute_closest_n_launch.argtypes = closest_n + [p, p, p]
    lib.brute_closest_lane_launch.argtypes = closest + [i, p]        # threads stream
    lib.brute_closest_n_lane_launch.argtypes = closest_n + [i, p]
    lib.brute_closest_plan.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]  # G want_n out
    lib.occlusion_any_launch.argtypes = [
        p, p, p, p,                          # rays maxt table blocked
        ctypes.c_longlong, i, ranges, i,
        p, p, p,                             # ctr live stream
    ]
    lib.occlusion_any_lane_launch.argtypes = [
        p, p, p, p,
        ctypes.c_longlong, i, ranges, i,
        i, p,                                # threads stream
    ]
    lib.occlusion_any_plan.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
    sizes = [ctypes.c_longlong, i, i]        # R G chunk
    lib.brute_closest_chunked_launch.argtypes = [
        p, p, p, p, *sizes, i, p, p, p,      # rays table t id | motion ctr live stream
    ]
    lib.brute_closest_chunked_lane_launch.argtypes = [
        p, p, p, p, *sizes, i, i, p,         # rays table t id | motion threads stream
    ]
    lib.brute_closest_chunked_plan.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    lib.chunk_closest_launch.argtypes = [
        p, p, p, p, p, p, *sizes, i,         # rays boxes graze table t id | motion
        p, p, p, p,                          # work ctr live stream
    ]
    lib.chunk_closest_n_launch.argtypes = [
        p, p, p, p, p, p, p, *sizes, i,      # rays boxes graze table t id n | motion
        p, p, p, p,                          # work ctr live stream
    ]
    lib.chunk_occlusion_launch.argtypes = [
        p, p, p, p, p, p, *sizes,            # rays maxt boxes graze table blocked
        p, p, p, p,                          # work ctr live stream
    ]
    lib.chunk_closest_lane_launch.argtypes = [
        p, p, p, p, p, p, *sizes, i, p, i, p,  # ... motion work threads stream
    ]
    lib.chunk_closest_n_lane_launch.argtypes = [
        p, p, p, p, p, p, p, *sizes, i, p, i, p,  # ... motion work threads stream
    ]
    lib.chunk_occlusion_lane_launch.argtypes = [
        p, p, p, p, p, p, *sizes, p, i, p,   # ... work threads stream
    ]
    lib.chunk_sweep_plan.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.bvh_closest_launch.argtypes = [
        p, p, p, p, p, p, p, p,              # rays boxes topo graze inner rows t id
        ctypes.c_longlong, i, i,             # R G motion
        p, p, p, p,                          # work ctr live stream
    ]
    lib.bvh_closest_n_launch.argtypes = [
        p, p, p, p, p, p, p, p, p,           # rays boxes topo graze inner rows t id n
        ctypes.c_longlong, i, i,
        p, p, p, p,
    ]
    lib.bvh_closest_plan.argtypes = [i, ctypes.POINTER(ctypes.c_int)]  # want_n out
    lib.bvh_closest_lane_launch.argtypes = [
        p, p, p, p, p, p, p,                 # rays table boxes topo graze t id
        ctypes.c_longlong, i, i,             # R G M
        i, i, p,                             # motion threads stream
    ]
    lib.bvh_closest_n_lane_launch.argtypes = [
        p, p, p, p, p, p, p, p,              # rays table boxes topo graze t id n
        ctypes.c_longlong, i, i,
        i, i, p,
    ]
    for fn in (lib.brute_closest_launch, lib.brute_closest_n_launch,
               lib.brute_closest_lane_launch, lib.brute_closest_n_lane_launch,
               lib.brute_closest_plan, lib.bvh_closest_n_launch,
               lib.occlusion_any_launch, lib.occlusion_any_lane_launch,
               lib.occlusion_any_plan, lib.brute_closest_chunked_launch,
               lib.chunk_closest_launch, lib.chunk_closest_n_launch,
               lib.chunk_occlusion_launch, lib.chunk_closest_lane_launch,
               lib.chunk_closest_n_lane_launch,
               lib.chunk_occlusion_lane_launch, lib.chunk_sweep_plan,
               lib.brute_closest_chunked_lane_launch, lib.brute_closest_chunked_plan,
               lib.bvh_closest_launch, lib.bvh_closest_plan,
               lib.bvh_closest_lane_launch, lib.bvh_closest_n_lane_launch):
        fn.restype = i
    lib.wave_error_string.argtypes = [i]
    lib.wave_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The kernels' library (--fmad=false), built at the first call."""
    global _lib
    if _lib is None:
        _lib = load_variant(fmad=False)
    return _lib
