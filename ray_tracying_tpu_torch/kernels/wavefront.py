"""Fused wavefront level: one whole bounce level — closest hit (motion
blur included), material record, Blinn-Phong, shadow visibility (any-hit
loops with early exit, one hard shadow ray per point light and
`light_samples` jittered ones per area light), texture UV (spherical,
cube entry face, rect, projective plane) and texel, glossy reflection or
one-way refraction spawn — in ONE kernel launch.

`wave_level` is the wrapper: for a CUDA tensor it launches the
hand-written kernel of csrc/wavefront.cu (built at first use by
kernels/_build.py) or raises; only for a CPU tensor does it take
`wave_level_plain`, the plain PyTorch version of the same function, which
is also what the kernel is held against on the card.

Replaces the TPU kernel `kernels/wavefront.py::_wave_kernel` (with
`_any_hit`, called through `wave_level_call`) of the JAX package.

What bounds it on an H100.  Level 0, where every lane is live: operations
(G slab/quadratic tests a lane for the closest hit, up to G more for each
shadow ray it casts, about 80 f32 operations each, against ~100 bytes a
lane).  The deep levels, where under 1 % of lanes live: bytes (every lane's
act read and its 13 rows written).  The kernel is built around that
(csrc/wavefront.cu), one cooperative launch a level: persistent blocks that
stage the table once; a scan that retires dead lanes with 16-byte zero
stores and lists the live ones; after a grid barrier, chunks of that list
spread over every block, each run on dense warps in three stages (closest
hit without the normal, two lanes a thread, each transform read as three
16-byte broadcasts; every shadow ray that matters queued and tested on
dense warps; shading with a count of blocked rays per light).  Each lane's
arithmetic is that of the plain version, so the two are bit-equal.  Every
table is culled by window: `with_windows` sorts each kind range's rows by
the Morton code of their boxes, cuts them into windows of WAVE_WINDOW rows
with one box each, and packs a permuted geom-major copy of the rows; a warp
runs a window's geoms only when one of its rays can hit the box nearer than
its best t so far (or its shadow ray's reach).  The winner merges by (t,
original row), so the cull changes no bit.  `package_build` names the
build: "staged_windows" where a block's shared memory holds the table, its
window records and its permuted rows (`wave_cap_geoms`: 1,106 geoms
textured, 1,130 untextured, with one light), which each block copies in;
"windows" above that up to WAVE_MAX_GEOMS, the rows read from global
memory.  The unculled "staged" build (every lane tests every row of the
staged table) stays as the reference the culled builds are held to on the
card; nothing in the package launches it.
`wave_level_lane` launches the one-thread-per-lane schedule of the same
stages, to be measured against; nothing in the package calls it.

Dataflow (row-major (rows, R) f32; lane i of row r at r * R + i):

  queue pack     rows 0..8   [ox oy oz dx dy dz time act tp]
  level output   rows 0..8   next queue pack (same layout)
                 rows 9..11  contribution (tp-weighted, visibility and
                             texel applied): the level's radiance
                 row  12     act_hit (stats)
  record mode    row  13     the winner's geom id (table column 16), -1
                             for none
                 rows 14..   per-light raw visibility (an area light's the
                             fraction of its samples), then (textured) the
                             texel rgb: the discrete decisions the backward
                             replays (`WaveLevelFn`, kernels/wave_ref.py)

The next level reads the previous output tensor directly.  Glossy fuzz and
area-light jitter are sampled OUTSIDE the kernel and fed in as fuzz rows
(the JAX package's layout: glossy rows 0..2 when the scene is glossy, then
3 * light_samples rows per area light in light order, rows 3k..3k+2 its
sample k), so tests can feed the same draws to every implementation.

Scope: `wave_refusal` names what this level does not take; such scenes go
down the integrator's general path.

Differentiable rendering: `WaveLevelFn` runs the level in record mode
forward, and its backward differentiates `kernels/wave_ref.py::
wave_level_ref`, the level rebuilt as tensor code from the recorded
decisions (the JAX package's custom VJP of `wave_level_call`).  Rows 0..12
of a record-mode launch are those of an inference launch, bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ray_tracying_tpu_torch import spans
from ray_tracying_tpu_torch.accel.lbvh import geom_aabbs, morton_codes, row_graze
from ray_tracying_tpu_torch.core import constants as C
from ray_tracying_tpu_torch.kernels import _build, _coop
from ray_tracying_tpu_torch.kernels.closest_hit import (
    KIND_CUBE,
    KIND_RECT,
    KIND_SPHERE,
    RayBlock,
    geom_step_n,
    geom_t,
)
from ray_tracying_tpu_torch.kernels.geom_table import (
    GEOM_COLS,
    KIND_PLANE,
    SHADED_COLS,
    pack_geom_table_shaded,
    pack_light_table,
)
from ray_tracying_tpu_torch.scene.types import Scene

_INF = float("inf")
_TINY = 1e-20

Q_ROWS = 9
C_BASE = 9    # contribution rows
HIT_ROW = 12  # act_hit
OUT_ROWS = 13

WAVE_MAX_LIGHTS = 8
# Most geoms of a table the level takes: the JAX package's cap
# (kernels/wavefront.py::WAVE_MAX_GEOMS); larger scenes go down the general
# path there and here.
WAVE_MAX_GEOMS = 6144
# Most shadow rays an area-lit lane casts at one level: light_samples times
# the number of area lights (3 fuzz rows each), the JAX package's cap.
WAVE_MAX_AREA_SAMPLES = 32
# Kind ranges of a table: sphere, cube, rect, legacy plane.
WAVE_MAX_RANGES = 4
# Threads per block of the one-thread-per-lane schedule (wave_level_lane).
WAVE_THREADS = 256
# A block of the level holds in dynamic shared memory its copy of the
# shaded table and the light table, a list of live lanes, a count of
# blocked shadow rays per light for each lane of a chunk, a queue of
# shadow rays, the table's window records and its permuted rows; the
# launcher opts in with cudaFuncAttributeMaxDynamicSharedMemorySize, up to
# the 227 KB a block can have on sm_90.  A larger table takes the kernel's
# wide build, whose blocks stage everything but the table and its rows.
WAVE_MAX_SMEM_BYTES = 232448
# The least staging list and shadow queue (entries) a block runs with, the
# chunk of lanes it runs at once, and its header (csrc/wavefront.cu:
# kListCapMin, kQueueCapMin, kChunk, kSmemHeader); the launcher takes a
# larger list and queue where the table leaves room.
WAVE_LIST_MIN = 1024
WAVE_QUEUE_MIN = 256
WAVE_CHUNK = 512
_SMEM_HEADER = 256
# A table's windows (csrc/wavefront.cu: kWinRows, kWinCols, kWinRec,
# kMaxWindows): rows a window, floats of a row of the permuted copy
# (transform 12 | velocity 3 | original row as int32 bits), floats of a
# window's record (box 6 | graze | first row | count << 16 as int32 bits),
# and the most windows a table has (one range of WAVE_MAX_GEOMS rows cut
# into windows, plus a partial window for each other range).
WAVE_WINDOW = 32
WIN_COLS = 16
WIN_REC = 8
WAVE_MAX_WINDOWS = WAVE_MAX_GEOMS // WAVE_WINDOW + WAVE_MAX_RANGES
# Half the side of a box every ray starts in: that of a legacy plane whose
# test takes points along a whole line (`plane_boxes`), so that every warp
# runs its window.
_OPEN_BOX = 1e15
# Builds of the level kernel (csrc/wavefront.cu: kBuild*): the table staged
# in each block and read whole by every lane (the reference the culled
# builds are held to); a wide table read whole by every lane (kept only to
# be measured against); a table culled by window, its rows read by 16-byte
# read-only loads of the permuted copy (the package's build over
# `wave_cap_geoms`); the same counting the tests it runs; a table culled by
# window with the table, its window records and its permuted rows staged in
# each block (the package's build up to `wave_cap_geoms`).
WAVE_BUILDS = {"staged": 0, "unculled": 1, "windows": 2, "windows_count": 3,
               "staged_windows": 4}
# Counters of the counting build, a live lane's: closest-hit geom tests run,
# those of them in windows whose box the lane's own ray entered, window box
# tests; shadow-ray geom tests run (each ray up to its blocker), box tests.
WINDOW_WORK = ("closest_tests", "closest_wanted_tests", "closest_box_tests",
               "shadow_tests", "shadow_box_tests")

# Column offsets into the shaded table (kernels/geom_table.py).
_M = GEOM_COLS  # first material column
_SLOT_COL = GEOM_COLS + 14
# The spherical UV's pi, as the f32 the kernel holds (Code/shapes.cpp:257-259).
_PI = float(np.float32(3.14159265358979))
_TWO_PI = float(np.float32(2.0) * np.float32(_PI))


def record_rows(n_lights: int, has_tex: bool) -> int:
    """Rows a record-mode level appends after row 12."""
    return 1 + n_lights + (3 if has_tex else 0)


def split_record(out: torch.Tensor, n_lights: int, has_tex: bool):
    """(winner geom id (R,), visibility (L, R), texel (3, R) or None) of a
    record-mode level output."""
    vis_end = OUT_ROWS + 1 + n_lights
    return (out[OUT_ROWS], out[OUT_ROWS + 1 : vis_end],
            out[vis_end : vis_end + 3] if has_tex else None)


@dataclasses.dataclass(frozen=True)
class WaveTables:
    """Everything one level reads besides the rays: the operands packed by
    `wave_tables`, on one device, plus the static facts of the scene."""

    table: torch.Tensor            # (31|32, G) f32 shaded table, transposed
    ranges: Tuple[Tuple[int, int, int], ...]  # (kind, start, end) per kind
    lights: torch.Tensor           # (8, L) f32
    tex: Optional[torch.Tensor]    # (T, H, W, 4) uint8 texels (rgb + pad)
    twh: Optional[torch.Tensor]    # (2, T) f32 true (w, h) per slot
    n_lights: int
    glossy: bool
    has_tex: bool
    motion: bool                   # spheres move: origin - velocity * time
    refraction: bool               # some material refracts (one-way)
    area: Tuple[bool, ...]         # per light: an area light (radius > 0)
    nss: int                       # shadow rays per area light (light_samples)
    # The windowed builds' operands (`with_windows`; `wave_tables` gives
    # every table its windows): (G, WIN_COLS) permuted rows, (NW, WIN_REC)
    # window records, the first window of each range followed by NW, and
    # the table they were built from (its data pointer and version counter:
    # `check_windows`).
    perm_rows: Optional[torch.Tensor] = None
    windows: Optional[torch.Tensor] = None
    window_ranges: Tuple[int, ...] = ()
    window_src: Tuple[int, int] = ()


def fuzz_rows(tables: WaveTables) -> int:
    """Rows of a level's fuzz operand: 3 glossy rows when the scene is
    glossy, then 3 * nss per area light."""
    return 3 * int(tables.glossy) + 3 * tables.nss * sum(tables.area)


def area_fuzz_row(tables: WaveTables, li: int) -> int:
    """The fuzz row of sample 0 of area light li."""
    return 3 * int(tables.glossy) + 3 * tables.nss * sum(tables.area[:li])


def pack_tex_u8(scene: Scene):
    """((T, H, W, 4) uint8 texel table, (2, T) f32 true-size table).

    Texels are stored as the EXACT u8 values round(255 * atlas); the level
    multiplies the fetched integer by the f32 constant 1/255, which
    reproduces the reference's nearest-neighbor fetch
    (Code/material.hpp:122-133).  The fourth byte pads a texel to one
    aligned 32-bit load."""
    t, h, w, _ = scene.tex_atlas.shape
    rgb = torch.round(scene.tex_atlas * 255.0).to(torch.uint8)
    tex = torch.zeros((t, h, w, 4), dtype=torch.uint8, device=rgb.device)
    tex[..., :3] = rgb
    return tex, scene.tex_wh.T.to(torch.float32).contiguous()


def wave_smem_bytes(n_geoms: int, n_cols: int, n_lights: int, n_win: int = 0,
                    n_perm: int = 0) -> int:
    """Least dynamic shared memory of one block of the level
    (csrc/wavefront.cu::wave_layout): header, the staged shaded table
    (n_geoms rows) and light table, then 16-byte aligned a list of
    WAVE_LIST_MIN live lanes, the winner row of each lane of a chunk of
    WAVE_CHUNK (4 bytes) and its count of blocked shadow rays per light (8
    bytes, one a light), a queue of WAVE_QUEUE_MIN shadow rays (32 bytes
    each), n_win window records (4 * WIN_REC bytes each) and n_perm
    permuted rows (4 * WIN_COLS bytes each).  The staged build stages the
    table alone; the staged windowed build the table, its window records
    and its permuted rows (n_perm = n_geoms); the wide windowed build the
    window records alone (n_geoms = 0)."""
    tables = _SMEM_HEADER + 4 * (n_cols * n_geoms + 8 * max(n_lights, 1))
    return (-(-tables // 16) * 16 + 4 * (WAVE_LIST_MIN + WAVE_CHUNK)
            + 8 * WAVE_CHUNK + 32 * WAVE_QUEUE_MIN + 4 * WIN_REC * n_win
            + 4 * WIN_COLS * n_perm)


def max_windows(n_geoms: int) -> int:
    """The most windows a table of n_geoms rows has (`window_arrays`: each
    of up to WAVE_MAX_RANGES kind ranges adds at most one partial window)."""
    return n_geoms // WAVE_WINDOW + WAVE_MAX_RANGES


def staged_smem_bytes(n_geoms: int, n_cols: int, n_lights: int) -> int:
    """Least shared memory of a block of the staged windowed build for a
    table of n_geoms rows, whatever its kind ranges (`max_windows`)."""
    return wave_smem_bytes(n_geoms, n_cols, n_lights, max_windows(n_geoms), n_geoms)


def wave_cap_geoms(n_cols: int, n_lights: int) -> int:
    """The most geoms whose table, window records and permuted rows a block
    of the level stages (`staged_smem_bytes` within WAVE_MAX_SMEM_BYTES); a
    larger table takes the "windows" build (`package_build`)."""
    per_geom = 4 * n_cols + 4 * WIN_COLS + 4 * WIN_REC // WAVE_WINDOW
    g = (WAVE_MAX_SMEM_BYTES - staged_smem_bytes(0, n_cols, n_lights)) // per_geom
    while staged_smem_bytes(g + 1, n_cols, n_lights) <= WAVE_MAX_SMEM_BYTES:
        g += 1
    while staged_smem_bytes(g, n_cols, n_lights) > WAVE_MAX_SMEM_BYTES:
        g -= 1
    return g


def stages_table(tables: WaveTables) -> bool:
    """Whether a block's shared memory holds the table alone, as the
    unculled staged build and the one-thread-per-lane schedule stage it
    (1,669 geoms textured, 1,723 untextured, with one light)."""
    n_cols, g = tables.table.shape
    return wave_smem_bytes(g, n_cols, tables.n_lights) <= WAVE_MAX_SMEM_BYTES


def window_arrays(table_t: np.ndarray, ranges, boxes: np.ndarray):
    """(perm_rows (G, WIN_COLS), windows (NW, WIN_REC), window_ranges) of a
    shaded table: `table_t` the (n_cols, G) table, `boxes` (G, 6) each
    row's box (`geom_aabbs` of its geom: a moving sphere's holds its time-1
    extent, so one box serves every ray time in [0, 1]).

    Within each kind range the rows are sorted (stably) by the 30-bit
    Morton code of their box's centroid, over the whole table's extent; no
    window crosses a range, so the kernel keeps its dispatch by kind, and a
    range of one huge geom (a floor) is a window of its own.  A window
    holds WAVE_WINDOW consecutive permuted rows (fewer at a range's end):
    its box is the union of its members' boxes, its graze the largest
    `row_graze` of its rows (the sphere test's slack, csrc/geom.cuh::
    box_hit).  A legacy plane's box is first grown to every point its test
    takes (`plane_boxes`; the Morton code is of the box as given), and a
    window's box is rounded outward to f32.  A permuted row is columns
    0..14 of its table row (transform, velocity) and its original row:
    winners, records and everything the finish stage reads stay in the
    table's own row order."""
    g = table_t.shape[1]
    rows = np.ascontiguousarray(table_t[:GEOM_COLS].T)  # (G, 17)
    codes = morton_codes((boxes[:, :3] + boxes[:, 3:]) * 0.5)
    boxes = plane_boxes(rows, boxes)
    graze = row_graze(rows)
    perm = np.arange(g, dtype=np.int64)
    boxes_w, graze_w, span, bounds = [], [], [], [0]
    for _, start, end in ranges:
        perm[start:end] = start + np.argsort(codes[start:end], kind="stable")
        for first in range(start, end, WAVE_WINDOW):
            members = perm[first:min(first + WAVE_WINDOW, end)]
            boxes_w.append(np.concatenate([boxes[members, :3].min(axis=0),
                                           boxes[members, 3:].max(axis=0)]))
            graze_w.append(graze[members].max())
            span.append(first | (len(members) << 16))
        bounds.append(len(span))
    windows = np.zeros((len(span), WIN_REC), np.float32)
    windows[:, :6] = _round_out(np.asarray(boxes_w).reshape(-1, 6))
    windows[:, 6] = graze_w
    windows[:, 7] = np.asarray(span, np.int32).view(np.float32)
    perm_rows = np.zeros((g, WIN_COLS), np.float32)
    perm_rows[:, :15] = rows[perm, :15]
    perm_rows[:, 15] = perm.astype(np.int32).view(np.float32)
    return perm_rows, windows, tuple(bounds)


def _round_out(boxes: np.ndarray) -> np.ndarray:
    """(N, 6) f32 of (N, 6) f64 [min xyz | max xyz] boxes, each bound
    rounded outward."""
    b = boxes.astype(np.float32)
    lo, hi = b[:, :3], b[:, 3:]
    lo[...] = np.where(lo > boxes[:, :3], np.nextafter(lo, np.float32(-np.inf)), lo)
    hi[...] = np.where(hi < boxes[:, 3:], np.nextafter(hi, np.float32(np.inf)), hi)
    return b


def plane_boxes(rows: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(G, 6) f64: `boxes` with the box of each legacy plane row of a
    (G, 17) geom table grown to hold every point its test takes; every
    other row's box as it is.

    The test (csrc/geom.cuh::plane_t_x) takes the unit normal n of corners
    a, b, c in f32 (replayed here; the "w2o" columns of a plane hold a, b,
    c, e) and a point p of the plane through a whose edge functions
    cross(p1 - p0, p - p0) . n are all at least EPS_PLANE_EDGE in triangle
    (b, e, c) or (a, b, c).  A corner off that plane (e, where the four are
    not in one plane) acts through its projection along n.  Where the edge
    functions of a triangle are S at the opposite corners, the points they
    take are those of the triangle with each corner v_k moved by eps / S *
    (2 v_k - v_j - v_l) (its barycentric coordinates at least -eps / S;
    for S < 0 the same corners bound what is left), with eps
    |EPS_PLANE_EDGE| plus a bound on the f32 rounding of the edge
    functions.  That holds while the corners move less than the quad is
    wide; a plane whose corners move further (a sliver), or with a triangle
    of no area (a repeated corner: its test takes a strip along a whole
    line), gets a box every ray starts in.  A plane whose normal the test
    finds degenerate never reports a hit and keeps its box."""
    out = boxes.astype(np.float64)
    plane = np.nonzero(np.rint(rows[:, 15]) == KIND_PLANE)[0]
    k32 = rows[plane, :12].astype(np.float32).reshape(-1, 4, 3)
    e1, e2 = k32[:, 1] - k32[:, 0], k32[:, 2] - k32[:, 0]
    n = np.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                  e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                  e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], axis=1)
    ln = np.sqrt(n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1] + n[:, 2] * n[:, 2])
    hits = ln >= np.float32(C.EPS_PARALLEL)
    plane, k32, n, ln = plane[hits], k32[hits], n[hits], ln[hits]
    if plane.size == 0:
        return out
    nu = (n / ln[:, None]).astype(np.float64)
    k = k32.astype(np.float64)
    off = ((k - k[:, :1]) * nu[:, None]).sum(axis=2) / (nu * nu).sum(axis=1)[:, None]
    k = k - off[..., None] * nu[:, None]   # the corners on the test's plane
    lo, hi = k.min(axis=1), k.max(axis=1)
    wide = np.linalg.norm(hi - lo, axis=1)
    edges = ((1, 3), (3, 2), (2, 1), (0, 1), (1, 2), (2, 0))
    longest = np.max([np.linalg.norm(k[:, j] - k[:, i], axis=1) for i, j in edges], axis=0)
    # the f32 rounding of an edge function: a few ulp of |p1 - p0| times
    # |p - p0| + |p| + |p0|, with |p - p0| at most twice the quad's width
    # (or the box is open); 64 ulp of |p1 - p0| (width + coordinates)
    eps = abs(C.EPS_PLANE_EDGE) + 2.0 ** -18 * longest * (wide + np.abs(k).max(axis=(1, 2)))
    open_ = np.zeros(plane.size, bool)
    reg_lo, reg_hi = lo.copy(), hi.copy()
    for tri in ((1, 3, 2), (0, 1, 2)):
        v = k[:, tri]
        s = (np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]) * nu).sum(axis=1)
        open_ |= s == 0.0
        coef = eps / np.where(s == 0.0, 1.0, s)
        moved = v + coef[:, None, None] * (3.0 * v - v.sum(axis=1, keepdims=True))
        reg_lo = np.minimum(reg_lo, moved.min(axis=1))
        reg_hi = np.maximum(reg_hi, moved.max(axis=1))
    growth = np.maximum(lo - reg_lo, reg_hi - hi).max(axis=1)
    open_ |= ~(growth <= wide)
    grown = np.concatenate([np.minimum(out[plane, :3], reg_lo),
                            np.maximum(out[plane, 3:], reg_hi)], axis=1)
    grown[open_] = [-_OPEN_BOX] * 3 + [_OPEN_BOX] * 3
    out[plane] = grown
    return out


def with_windows(tables: WaveTables, scene: Scene) -> WaveTables:
    """`tables` with the windowed build's operands (`window_arrays`), built
    on the host in numpy from the detached table and `scene`'s geom boxes,
    on the table's device.  They never carry a gradient."""
    with spans.read("windows table"):
        table_t = tables.table.detach().cpu().numpy()
    ids = np.rint(table_t[16]).astype(np.int64)
    perm_rows, windows, bounds = window_arrays(table_t, tables.ranges, geom_aabbs(scene)[ids])
    dev = tables.table.device
    return dataclasses.replace(
        tables, perm_rows=torch.from_numpy(perm_rows).to(dev),
        windows=torch.from_numpy(windows).to(dev), window_ranges=bounds,
        window_src=(tables.table.data_ptr(), tables.table._version))


def check_windows(tables: WaveTables) -> None:
    """Raise unless `tables` has windows built from its own table as it
    stands: the permuted rows are a copy of the table's transforms, so a
    `dataclasses.replace` with another table, or an in-place edit of this
    one, would leave the cull reading stale transforms while the finish
    stage reads the new ones.  A detached view of the same table passes."""
    if tables.windows is None:
        raise ValueError("this build needs the table's windows (with_windows)")
    if tables.window_src != (tables.table.data_ptr(), tables.table._version):
        raise ValueError("the windows were built from another table, or the table changed "
                         "since: rebuild them with with_windows")


def window_spans(tables: WaveTables):
    """(first row, count) of each window, as two int64 numpy arrays."""
    span = tables.windows[:, 7].contiguous().view(torch.int32).cpu().numpy().astype(np.int64)
    return span & 0xFFFF, span >> 16


def wave_refusal(scene: Scene, use_bvh: bool = False,
                 light_samples: int = 1) -> Optional[str]:
    """Gate of the fused level path, in the form that answers: None for a
    scene (and options) the level takes, else the first feature it does
    not take.  The integrator sends a refused scene down the general path,
    which takes use_bvh.  The same gate serves differentiable rendering:
    textures are always in the kernel here, so record mode takes every
    scene the level takes.  light_samples: shadow rays per area light, the
    render's; with the area lights it sizes the fuzz operand (JAX's cap,
    `WAVE_MAX_AREA_SAMPLES`)."""
    if use_bvh:
        return "use_bvh (BVH traversal)"
    if scene.n_geoms == 0:
        return "an empty table (no geoms)"
    if scene.n_geoms > WAVE_MAX_GEOMS:
        return (
            f"a shaded table of {scene.n_geoms} geoms (more than {WAVE_MAX_GEOMS})"
        )
    if scene.has_two_way:
        return "two-way materials (reflect and refract on one hit)"
    if scene.n_lights > WAVE_MAX_LIGHTS:
        return f"more than {WAVE_MAX_LIGHTS} lights"
    if scene.has_textures and scene.tex_atlas is None:
        return "textures without an atlas"
    n_area = sum(1 for a in scene.lights.is_area if a)
    if n_area and light_samples * n_area > WAVE_MAX_AREA_SAMPLES:
        return (
            f"more than {WAVE_MAX_AREA_SAMPLES} area-light samples "
            f"({light_samples} a light, {n_area} area lights)"
        )
    return None


def wave_supported(scene: Scene, use_bvh: bool = False, light_samples: int = 1) -> bool:
    """The gate in the form that raises, for a caller that forces the
    fused path: True for a scene the level takes, else NotImplementedError
    naming the first feature `wave_refusal` refuses."""
    feature = wave_refusal(scene, use_bvh, light_samples)
    if feature is not None:
        raise NotImplementedError(
            f"the fused wavefront level does not support {feature} yet"
        )
    return True


def wave_tables(scene: Scene, differentiable: bool = False,
                light_samples: int = 1) -> WaveTables:
    """Pack the operands of the level for `scene`, on the scene's device.
    light_samples: shadow rays per area light (`nss`; 1 without area
    lights).

    The shaded table is transposed to (31|32, G): a column of the record
    of every geom is contiguous, so the winner-record reads of a warp
    spread over shared-memory banks.  Kind segments are NOT padded to a
    multiple of 8 as in the JAX package (that served a TPU loop unroll):
    the table holds the real rows only.

    differentiable: the table and the light table keep their autograd
    graph back to the scene's tensors (materials, transforms, lights), so
    that `WaveLevelFn`'s cotangents reach them; otherwise both are
    detached.  The kernel always reads detached views.

    Every table also gets its windows (`with_windows`), which every build
    the package launches culls by (`package_build`)."""
    table, ranges = pack_geom_table_shaded(scene, with_tex=scene.has_textures)
    lights = pack_light_table(scene)
    if not differentiable:
        table, lights = table.detach(), lights.detach()
    tex = twh = None
    if scene.has_textures:
        tex, twh = pack_tex_u8(scene)
    tables = WaveTables(
        table=table.T.contiguous(),
        ranges=ranges,
        lights=lights.contiguous(),
        tex=tex,
        twh=twh,
        n_lights=scene.n_lights,
        glossy=scene.has_glossy,
        has_tex=scene.has_textures,
        motion=scene.has_motion,
        refraction=scene.has_refraction,
        area=tuple(bool(a) for a in scene.lights.is_area),
        nss=int(light_samples) if any(scene.lights.is_area) else 1,
    )
    return with_windows(tables, scene)


def _check_level_args(out_prev, fuzz, tables: WaveTables):
    if out_prev.dtype != torch.float32 or out_prev.dim() != 2:
        raise TypeError("out_prev must be a 2-D float32 tensor")
    if out_prev.shape[0] < Q_ROWS:
        raise ValueError(f"out_prev needs at least {Q_ROWS} rows")
    if not out_prev.is_contiguous():
        raise ValueError("out_prev must be contiguous (row-major)")
    n_fuzz = fuzz_rows(tables)
    if n_fuzz:
        if fuzz is None or fuzz.dtype != torch.float32 or fuzz.dim() != 2:
            raise TypeError("glossy and area-lit scenes need a 2-D float32 fuzz tensor")
        if fuzz.shape[0] < n_fuzz or fuzz.shape[1] != out_prev.shape[1]:
            raise ValueError(f"fuzz must be (>={n_fuzz}, R)")
        if not fuzz.is_contiguous() or fuzz.device != out_prev.device:
            raise ValueError("fuzz must be contiguous, on out_prev's device")
    operands = [(tables.table, torch.float32), (tables.lights, torch.float32)]
    if tables.has_tex:
        operands += [(tables.tex, torch.uint8), (tables.twh, torch.float32)]
    for t, dtype in operands:
        if t.device != out_prev.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                "tables must be contiguous, of their dtype, on the rays' device"
            )


def wave_level_plain(
    out_prev: torch.Tensor,
    fuzz: Optional[torch.Tensor],
    tables: WaveTables,
    min_tp: float = 0.0,
    stats: Optional[dict] = None,
    record: bool = False,
) -> torch.Tensor:
    """One bounce level in plain PyTorch: the oracle of the CUDA kernel
    and the path of CPU tensors.  Loops over the table rows with (R,)
    tensors; never builds anything of size (R, G).

    out_prev: the previous level's (rows >= 9, R) output (or the primary
    bootstrap tensor); the queue is its rows 0..8.  fuzz: (>= fuzz_rows,
    R) unit-ball rows when the scene is glossy or has area lights (module
    docstring).  Returns (13, R), or with record (13 + record_rows, R):
    rows 0..12 unchanged, then the winner's geom id, each light's raw
    visibility (every hit lane casts every shadow ray; an area light's is
    the fraction of its samples that reach it), the texel rgb; a lane
    without a hit records id -1, visibility 0, texel 1.

    Lanes that enter dead (act <= 0) leave with rows 0..12 zero.

    stats: optional dict that receives what this call's data needed, for
    the roofline bound: live lanes, geom tests of the closest-hit loops,
    shadow rays cast, and geom tests of the shadow loops counted up to and
    including each ray's first blocker (what a loop with early exit
    runs)."""
    _check_level_args(out_prev, fuzz, tables)
    r = out_prev.shape[1]
    dev = out_prev.device
    rows = tables.table.T.tolist()        # G rows of Python floats (exact f32)
    lights = tables.lights.cpu().numpy()  # (8, L) np.float32
    rb = RayBlock(out_prev)
    act = out_prev[7]
    tp = out_prev[8]
    live = act > 0.0
    zero = torch.zeros(r, dtype=torch.float32, device=dev)

    # --- closest hit + winning normal and table row
    # (Code/acceleration.cpp:103-118); rows in table order, strict <.
    # Spheres of a scene with motion blur are tested at the ray's time
    # (origin - velocity * time, Code/shapes.cpp:201-210).
    best_t, best_row, bnx, bny, bnz = closest_rows(rows, tables, rb)
    finite = torch.isfinite(best_t)
    hit_f = finite & live
    act_hit = torch.where(hit_f, 1.0, 0.0)
    w_miss = torch.where(live & ~finite, tp, zero)

    ln = torch.sqrt(bnx * bnx + bny * bny + bnz * bnz)
    inv_n = 1.0 / torch.clamp(ln, min=_TINY)
    nx, ny, nz = bnx * inv_n, bny * inv_n, bnz * inv_n

    # --- winner record: plain indexing by the winner's table row; lanes
    # without a winner read an all-zero record.
    won = best_row >= 0
    rec = tables.table[:, torch.clamp(best_row, min=0)]
    rec = torch.where(won[None, :], rec, torch.zeros_like(rec))
    dr, dg, db = rec[_M + 0], rec[_M + 1], rec[_M + 2]
    sr, sg, sb = rec[_M + 3], rec[_M + 4], rec[_M + 5]
    ka, kd, ks = rec[_M + 6], rec[_M + 7], rec[_M + 8]
    shin, rough, refl = rec[_M + 9], rec[_M + 10], rec[_M + 11]
    # transparency and index: read only when the scene refracts
    trans = rec[_M + 12] if tables.refraction else zero
    ior = rec[_M + 13] if tables.refraction else zero

    # --- hit point & view (V = -d for unit d, Code/raytracer.cpp:197)
    t_fin = torch.where(hit_f, best_t, zero)
    px = rb.ox + t_fin * rb.dx
    py = rb.oy + t_fin * rb.dy
    pz = rb.oz + t_fin * rb.dz
    vx, vy, vz = -rb.dx, -rb.dy, -rb.dz

    # local weight max(0, 1 - refl - trans) (Code/raytracer.cpp:346-350).
    w_local = torch.where(hit_f, tp * torch.clamp(1.0 - refl - trans, min=0.0), zero)

    # --- contribution accumulators: D is tinted by the texel, S
    # (specular + background) is not (Code/raytracer.cpp:194).
    amb = ka * w_local
    d_r, d_g, d_b = dr * amb, dg * amb, db * amb
    s_r = w_miss * C.BACKGROUND_RGB[0]
    s_g = w_miss * C.BACKGROUND_RGB[1]
    s_b = w_miss * C.BACKGROUND_RGB[2]

    # --- per light: Blinn-Phong from the light CENTRE (Code/raytracer.cpp:
    # 244-262) times the visibility (:199-236): one hard shadow ray for a
    # point light; for an area light the share of its nss rays toward
    # lp + radius * fuzz that reach it.  Shadow rays carry time 0: no
    # motion shift.
    sox = px + nx * C.EPS_NORMAL_OFFSET
    soy = py + ny * C.EPS_NORMAL_OFFSET
    soz = pz + nz * C.EPS_NORMAL_OFFSET
    n_shadow = 0
    n_shadow_tests = 0
    rec_vis = []
    inv_nss = float(np.float32(1.0) / np.float32(tables.nss))
    for li in range(tables.n_lights):
        lpx, lpy, lpz, lr, lg, lb, inten, lrad = (
            float(x) for x in lights[:, li]
        )
        # 10 * I in f32, as the kernel computes it
        num = float(np.float32(C.ATTEN_NUM) * lights[6, li])
        lvx, lvy, lvz = lpx - px, lpy - py, lpz - pz
        d2 = lvx * lvx + lvy * lvy + lvz * lvz
        dist = torch.sqrt(d2)
        inv_d = 1.0 / torch.clamp(dist, min=_TINY)
        lcx, lcy, lcz = lvx * inv_d, lvy * inv_d, lvz * inv_d
        ndotl = torch.clamp(nx * lcx + ny * lcy + nz * lcz, min=0.0)
        hx, hy, hz = lcx + vx, lcy + vy, lcz + vz
        hn = torch.sqrt(hx * hx + hy * hy + hz * hz)
        inv_h = 1.0 / torch.clamp(hn, min=_TINY)
        ndoth = torch.clamp(
            nx * hx * inv_h + ny * hy * inv_h + nz * hz * inv_h, min=0.0
        )
        # pow(0, s) == 0, guarded
        spec_i = torch.where(
            ndoth > 0.0,
            torch.exp(shin * torch.log(torch.clamp(ndoth, min=1e-12))),
            zero,
        )
        # a true division (float / tensor would multiply by a reciprocal)
        atten = torch.full_like(dist, num) / (
            C.ATTEN_C0 + dist * C.ATTEN_C1 + d2 * C.ATTEN_C2
        )
        scale = atten * w_local
        dif = kd * ndotl * scale
        spc = ks * spec_i * scale
        pr, pg, pb = dr * lr * dif, dg * lg * dif, db * lb * dif
        qr, qg, qb = sr * lr * spc, sg * lg * spc, sb * lb * spc
        # zero-contribution lanes cast no shadow ray (result unchanged),
        # except in record mode, which records the raw visibility
        needs = (
            (pr != 0.0) | (pg != 0.0) | (pb != 0.0)
            | (qr != 0.0) | (qg != 0.0) | (qb != 0.0)
        )
        s_act = hit_f if record else hit_f & needs
        if tables.area[li]:
            fz = area_fuzz_row(tables, li)
            targets = [
                (lpx + fuzz[fz + 3 * k] * lrad, lpy + fuzz[fz + 3 * k + 1] * lrad,
                 lpz + fuzz[fz + 3 * k + 2] * lrad)
                for k in range(tables.nss)
            ]
        else:
            targets = [None]
        vsum = zero
        for target in targets:
            if target is None:
                sdx, sdy, sdz, maxt = lcx, lcy, lcz, dist
            else:
                svx, svy, svz = target[0] - px, target[1] - py, target[2] - pz
                maxt = torch.sqrt(svx * svx + svy * svy + svz * svz)
                inv_s = 1.0 / torch.clamp(maxt, min=_TINY)
                sdx, sdy, sdz = svx * inv_s, svy * inv_s, svz * inv_s
            # any-hit: blocked iff some geom has t <= maxt (visible iff
            # min_t > light_dist, Code/raytracer.cpp:233-235)
            srb = RayBlock(
                torch.stack([sox, soy, soz, sdx, sdy, sdz, zero], dim=0)
            )
            blocked, tests = shadow_rows(rows, tables.ranges, srb, maxt, s_act,
                                         stats is not None)
            n_shadow_tests += tests
            vsum = vsum + torch.where(blocked, 0.0, 1.0)
            if stats is not None:
                n_shadow += int(s_act.sum())
        vis = vsum * inv_nss if tables.area[li] else vsum
        if record:
            rec_vis.append(torch.where(hit_f, vis, zero))
            # the terms of the inference launch: visibility 0 where the
            # products are all zero
            vis = torch.where(needs, vis, zero)
        d_r = d_r + pr * vis
        d_g = d_g + pg * vis
        d_b = d_b + pb * vis
        s_r = s_r + qr * vis
        s_g = s_g + qg * vis
        s_b = s_b + qb * vis

    # --- texture: per-kind UV of the winner (Code/shapes.cpp:257-259
    # sphere, :396-407 cube entry face, :318-321 rect, :470-481 plane),
    # then the nearest texel with v flipped (Code/material.hpp:122-133).
    if tables.has_tex:
        w2o = [rec[k] for k in range(12)]
        kindv = rec[15]
        slotv = rec[_SLOT_COL]
        ox, oy, oz = rb.ox, rb.oy, rb.oz
        if tables.motion:
            # the winner's object space at the ray's time
            ox = rb.ox - rb.tm * rec[12]
            oy = rb.oy - rb.tm * rec[13]
            oz = rb.oz - rb.tm * rec[14]
        olx = w2o[0] * ox + w2o[1] * oy + w2o[2] * oz + w2o[3]
        oly = w2o[4] * ox + w2o[5] * oy + w2o[6] * oz + w2o[7]
        olz = w2o[8] * ox + w2o[9] * oy + w2o[10] * oz + w2o[11]
        dlx = w2o[0] * rb.dx + w2o[1] * rb.dy + w2o[2] * rb.dz
        dly = w2o[4] * rb.dx + w2o[5] * rb.dy + w2o[6] * rb.dz
        dlz = w2o[8] * rb.dx + w2o[9] * rb.dy + w2o[10] * rb.dz
        # best_t is Euclidean = t_loc * |d| (Code/shapes.cpp:251-253).
        t_loc = t_fin / torch.clamp(rb.dnorm, min=_TINY)
        plx = olx + t_loc * dlx
        ply = oly + t_loc * dly
        plz = olz + t_loc * dlz
        u = zero
        v = zero
        kinds = {k for k, _, _ in tables.ranges}
        if KIND_SPHERE in kinds:
            # true divisions by f32 pi, as the kernel's atan2f / asinf
            sel = kindv == float(KIND_SPHERE)
            u_s = 0.5 + torch.atan2(plz, plx) / torch.full_like(plx, _TWO_PI)
            v_s = 0.5 - torch.asin(torch.clamp(ply, -1.0, 1.0)) / torch.full_like(ply, _PI)
            u = torch.where(sel, u_s, u)
            v = torch.where(sel, v_s, v)
        if KIND_CUBE in kinds:
            # Entry face: recompute the slab entries once per lane; ties
            # break first-wins (strict >).
            ents = []
            sgns = []
            for oo, ddc in ((olx, dlx), (oly, dly), (olz, dlz)):
                par = torch.abs(ddc) < C.EPS_PARALLEL
                d_safe = torch.where(par, 1.0, ddc)
                s1 = (-0.5 - oo) / d_safe
                s2 = (0.5 - oo) / d_safe
                ents.append(torch.where(par, -_INF, torch.minimum(s1, s2)))
                sgns.append(torch.where(s1 < s2, -1.0, 1.0))
            win1 = ents[1] > ents[0]
            axv = torch.where(win1, ents[1], ents[0])
            win2 = ents[2] > axv
            ax0 = ~win1 & ~win2
            ax1 = win1 & ~win2
            sgn = torch.where(
                win2, sgns[2], torch.where(win1, sgns[1], sgns[0])
            )
            pos = sgn > 0.0
            uc = plx + 0.5
            vc = ply + 0.5
            wc = plz + 0.5
            u_c = torch.where(
                ax0,
                torch.where(pos, wc, 1.0 - wc),
                torch.where(ax1, uc, torch.where(pos, uc, 1.0 - uc)),
            )
            v_c = torch.where(
                ax0, vc, torch.where(ax1, torch.where(pos, wc, 1.0 - wc), vc)
            )
            sel = kindv == float(KIND_CUBE)
            u = torch.where(sel, u_c, u)
            v = torch.where(sel, v_c, v)
        if KIND_RECT in kinds:
            sel = kindv == float(KIND_RECT)
            u = torch.where(sel, plx + 0.5, u)
            v = torch.where(sel, ply + 0.5, v)
        if KIND_PLANE in kinds:
            # projective UV: the WORLD hit point onto the corner-0 -> 1
            # and corner-0 -> 3 edges, clamped to [0, 1]; the "w2o"
            # columns of a plane hold its corners.
            eux, euy, euz = w2o[3] - w2o[0], w2o[4] - w2o[1], w2o[5] - w2o[2]
            evx, evy, evz = w2o[9] - w2o[0], w2o[10] - w2o[1], w2o[11] - w2o[2]
            hvx, hvy, hvz = px - w2o[0], py - w2o[1], pz - w2o[2]
            eu2 = torch.clamp(eux * eux + euy * euy + euz * euz, min=_TINY)
            ev2 = torch.clamp(evx * evx + evy * evy + evz * evz, min=_TINY)
            u_p = torch.clamp((hvx * eux + hvy * euy + hvz * euz) / eu2, 0.0, 1.0)
            v_p = torch.clamp((hvx * evx + hvy * evy + hvz * evz) / ev2, 0.0, 1.0)
            sel = kindv == float(KIND_PLANE)
            u = torch.where(sel, u_p, u)
            v = torch.where(sel, v_p, v)
        twh = tables.twh.tolist()
        twid = zero
        thgt = zero
        for t in range(len(twh[0])):
            sel_t = slotv == float(t)
            twid = torch.where(sel_t, twh[0][t], twid)
            thgt = torch.where(sel_t, twh[1][t], thgt)
        xx = torch.minimum(
            torch.clamp(torch.floor(u * (twid - 1.0)), min=0.0),
            torch.clamp(twid - 1.0, min=0.0),
        )
        yy = torch.minimum(
            torch.clamp(torch.floor((1.0 - v) * (thgt - 1.0)), min=0.0),
            torch.clamp(thgt - 1.0, min=0.0),
        )
        has_t = hit_f & (slotv >= 0.0)
        # lanes without a texel read texel (0, 0, 0) and drop it below
        si = torch.where(has_t, slotv, zero).to(torch.int64)
        xi = torch.where(has_t, xx, zero).to(torch.int64)
        yi = torch.where(has_t, yy, zero).to(torch.int64)
        texel = tables.tex[si, yi, xi].to(torch.float32)  # (R, 4)
        inv255 = 1.0 / 255.0
        tr = torch.where(has_t, texel[:, 0] * inv255, 1.0)
        tg = torch.where(has_t, texel[:, 1] * inv255, 1.0)
        tb = torch.where(has_t, texel[:, 2] * inv255, 1.0)
        c_r = d_r * tr + s_r
        c_g = d_g * tg + s_g
        c_b = d_b * tb + s_b
        rec_tex = [tr, tg, tb]
    else:
        c_r = d_r + s_r
        c_g = d_g + s_g
        c_b = d_b + s_b

    # --- reflection continuation (Code/raytracer.cpp:307-333)
    ddn = rb.dx * nx + rb.dy * ny + rb.dz * nz
    rdx = rb.dx - ddn * 2.0 * nx
    rdy = rb.dy - ddn * 2.0 * ny
    rdz = rb.dz - ddn * 2.0 * nz
    if tables.glossy:
        # normalize(R + roughness * unit_ball); rays perturbed below the
        # surface are absorbed (raytracer.cpp:312-327).
        gx = rdx + rough * fuzz[0]
        gy = rdy + rough * fuzz[1]
        gz = rdz + rough * fuzz[2]
        gn = torch.sqrt(gx * gx + gy * gy + gz * gz)
        inv_g = 1.0 / torch.clamp(gn, min=_TINY)
        gx, gy, gz = gx * inv_g, gy * inv_g, gz * inv_g
        below = (gx * nx + gy * ny + gz * nz) < 0.0
        gx = torch.where(below, zero, gx)
        gy = torch.where(below, zero, gy)
        gz = torch.where(below, zero, gz)
        isg = rough > 0.0
        rdx = torch.where(isg, gx, rdx)
        rdy = torch.where(isg, gy, rdy)
        rdz = torch.where(isg, gz, rdz)
    rd2 = rdx * rdx + rdy * rdy + rdz * rdz
    ok = hit_f & (refl > 0.0) & (rd2 > C.EPS_GLOSSY_DIR2)
    tp2 = tp * refl
    cox, coy, coz = sox, soy, soz
    if tables.refraction:
        # --- refraction continuation (Code/raytracer.cpp:118-150): the
        # outer medium is n = 1 (:121); leaving the object swaps the
        # indices and flips the normal (:126-129); total internal
        # reflection gives a zero direction (:136-139); the direction is
        # renormalized (:149) and the origin offset by -1e-4 along the
        # normal used (:147).  A lane whose material refracts (trans > 0)
        # takes this continuation; a one-way material never also reflects.
        exiting = ddn > 0.0
        eta = torch.where(exiting, ior, 1.0) / torch.where(
            exiting, 1.0, torch.clamp(ior, min=_TINY)
        )
        nsg = torch.where(exiting, -1.0, 1.0)
        nex, ney, nez = nsg * nx, nsg * ny, nsg * nz
        cos_abs = torch.abs(ddn)
        disc = 1.0 - eta * eta * (1.0 - cos_abs * cos_abs)
        cos_t = torch.sqrt(torch.clamp(disc, min=0.0))
        kk = eta * cos_abs - cos_t
        tx = eta * rb.dx + kk * nex
        ty = eta * rb.dy + kk * ney
        tz = eta * rb.dz + kk * nez
        tn2 = tx * tx + ty * ty + tz * tz
        inv_t = 1.0 / torch.sqrt(torch.where(tn2 > 0.0, tn2, 1.0))
        live_t = (disc >= 0.0) & (tn2 > C.EPS_REFRACT_DIR2)
        use_refr = trans > 0.0
        ok = torch.where(use_refr, hit_f & live_t, ok)
        tp2 = tp * torch.where(use_refr, trans, refl)
        cox = torch.where(use_refr, px - nex * C.EPS_NORMAL_OFFSET, cox)
        coy = torch.where(use_refr, py - ney * C.EPS_NORMAL_OFFSET, coy)
        coz = torch.where(use_refr, pz - nez * C.EPS_NORMAL_OFFSET, coz)
        rdx = torch.where(use_refr, torch.where(live_t, tx * inv_t, zero), rdx)
        rdy = torch.where(use_refr, torch.where(live_t, ty * inv_t, zero), rdy)
        rdz = torch.where(use_refr, torch.where(live_t, tz * inv_t, zero), rdz)
    if min_tp > 0.0:
        ok = ok & (tp2 > min_tp)

    out = torch.stack(
        [
            cox, coy, coz, rdx, rdy, rdz,
            zero,  # secondary rays carry time 0 (Code/shapes.hpp:28)
            torch.where(ok, 1.0, 0.0),
            torch.where(ok, tp2, zero),
            c_r, c_g, c_b,
            act_hit,
        ],
        dim=0,
    )
    if stats is not None:
        n_live = int(live.sum())
        stats.update(
            lanes=r,
            live=n_live,
            closest_tests=n_live * len(rows),
            shadow_rays=n_shadow,
            shadow_tests=n_shadow_tests,
        )
    out = torch.where(live[None, :], out, torch.zeros_like(out))
    if not record:
        return out
    won_id = torch.where(hit_f, rec[16], -1.0)
    return torch.cat(
        [out, torch.stack([won_id] + rec_vis + (rec_tex if tables.has_tex else []))]
    )


def closest_rows(rows, tables: WaveTables, rb: RayBlock):
    """The closest hit of the rays `rb` over every table row (`rows`: the
    rows as lists of floats), in row order with strict <: (best t, best
    row, the winner's unnormalized normal).  Spheres of a scene with motion
    blur are tested at the ray's time."""
    r = rb.ox.shape[0]
    dev = rb.ox.device
    zero = torch.zeros(r, dtype=torch.float32, device=dev)
    best = (
        torch.full((r,), _INF, dtype=torch.float32, device=dev),
        torch.full((r,), -1, dtype=torch.int64, device=dev),
        zero, zero, zero,
    )
    for kind, start, end in tables.ranges:
        moving = tables.motion and kind == KIND_SPHERE
        for g in range(start, end):
            best = geom_step_n(g, best, rows[g], rb, kind, motion=moving)
    return best


def shadow_rows(rows, ranges, srb: RayBlock, maxt: torch.Tensor, s_act: torch.Tensor,
                count: bool):
    """Any-hit of the shadow rays `srb` that cast (`s_act`) over every table
    row in row order: (blocked (lanes that cast nothing count as blocked),
    the geom tests of a loop that leaves each ray at its first blocker, when
    `count`, else 0).  Blocked iff some geom has t <= maxt."""
    blocked = ~s_act
    tests = 0
    for kind, start, end in ranges:
        for g in range(start, end):
            if count:
                tests += int((~blocked).sum())
            blocked = blocked | (geom_t(rows[g], srb, kind) <= maxt)
    return blocked, tests


def _level_args(out_prev, fuzz, tables: WaveTables, min_tp: float, out):
    """The launchers' common arguments, after the checks of what the kernel
    takes."""
    n_cols, g = tables.table.shape
    if g > WAVE_MAX_GEOMS:
        raise NotImplementedError(
            f"a shaded table of {g} geoms (more than {WAVE_MAX_GEOMS})"
        )
    if len(tables.ranges) > WAVE_MAX_RANGES:
        raise NotImplementedError(f"more than {WAVE_MAX_RANGES} kind ranges")
    if any(a[2] > b[1] for a, b in zip(tables.ranges, tables.ranges[1:])):
        raise ValueError("the kind ranges must be in row order")
    for kind, _, _ in tables.ranges:
        if kind not in (KIND_SPHERE, KIND_CUBE, KIND_RECT, KIND_PLANE):
            raise NotImplementedError(f"geom kind {kind} in the CUDA level")
    if tables.table.data_ptr() % 16:
        raise ValueError("the shaded table must be 16-byte aligned (bulk copy)")
    flat = [x for rng in tables.ranges for x in rng]
    n_flat = 3 * WAVE_MAX_RANGES
    ranges = (ctypes.c_int * n_flat)(*(flat + [0] * (n_flat - len(flat))))
    if tables.has_tex:
        n_tex, tex_h, tex_w, _ = tables.tex.shape
        tex_ptr, twh_ptr = tables.tex.data_ptr(), tables.twh.data_ptr()
    else:
        n_tex = tex_h = tex_w = 0
        tex_ptr = twh_ptr = None
    return (
        out_prev.data_ptr(),
        fuzz.data_ptr() if fuzz_rows(tables) else None,
        tables.table.data_ptr(),
        tables.lights.data_ptr(),
        tex_ptr, twh_ptr,
        out.data_ptr(),
        out_prev.shape[1], g, n_cols, tables.n_lights,
        ranges, len(tables.ranges),
        int(tables.glossy), int(tables.has_tex),
        n_tex, tex_h, tex_w,
        float(min_tp),
        int(tables.motion), int(tables.refraction),
        sum(1 << li for li, a in enumerate(tables.area) if a), tables.nss,
    )


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(
            f"{what} failed: CUDA error {err} "
            f"({lib.wave_error_string(err).decode()})"
        )


def package_build(tables: WaveTables) -> str:
    """The build of the level kernel the package launches for `tables`, a
    window cull for every table: "staged_windows" up to `wave_cap_geoms`
    (each block stages the table, its window records and its permuted
    rows), "windows" above it (the rows read from global memory)."""
    n_cols, g = tables.table.shape
    return "staged_windows" if g <= wave_cap_geoms(n_cols, tables.n_lights) else "windows"


def _launch_build(out_prev, fuzz, tables: WaveTables, min_tp: float, record: bool,
                  build: str, work: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch `build` (a key of WAVE_BUILDS) on the current stream (no
    synchronization).  The unculled build reads each transform from a
    (G, 12) geom-major copy of the table's rows 0..11, made here; the
    windowed builds read the operands of `with_windows`; the counting build
    adds its counts to `work` (len(WINDOW_WORK) int64 on the device)."""
    rows = OUT_ROWS + (record_rows(tables.n_lights, tables.has_tex) if record else 0)
    out = torch.empty((rows, out_prev.shape[1]), dtype=torch.float32,
                      device=out_prev.device)
    args = _level_args(out_prev, fuzz, tables, min_tp, out)
    xf = xp = win = None
    wbeg = (ctypes.c_int * (WAVE_MAX_RANGES + 1))()
    n_win = 0
    if build == "unculled":
        xf = tables.table[:12].T.contiguous()
    elif build != "staged":
        check_windows(tables)
        for t in (tables.perm_rows, tables.windows):
            if t.device != out_prev.device or t.dtype != torch.float32 \
                    or not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError("the windows must be contiguous 16-byte aligned float32, "
                                 "on the rays' device")
        xp, win = tables.perm_rows, tables.windows
        n_win = win.shape[0]
        if xp.shape != (tables.table.shape[1], WIN_COLS) or win.shape[1] != WIN_REC \
                or len(tables.window_ranges) != len(tables.ranges) + 1:
            raise ValueError("the windows are not this table's (with_windows)")
        for k, w in enumerate(tables.window_ranges):
            wbeg[k] = w
    if (work is not None) != (build == "windows_count"):
        raise ValueError("the counting build, and it alone, takes `work`")
    if work is not None and (work.device != out_prev.device or work.dtype != torch.int64
                             or work.numel() != len(WINDOW_WORK)):
        raise ValueError(f"work must be {len(WINDOW_WORK)} int64 on the rays' device")
    lib = _build.load()
    with torch.cuda.device(out_prev.device):
        stream = torch.cuda.current_stream().cuda_stream
        ctr = _coop.work_counters(out_prev.device, stream)
        # the launch's list of live lanes (scratch, no initial value)
        live = torch.empty(out_prev.shape[1], dtype=torch.int32, device=out_prev.device)
        err = lib.wave_level_launch(
            *args, int(record), WAVE_BUILDS[build],
            *(None if t is None else t.data_ptr() for t in (xf, xp, win)), wbeg, n_win,
            None if work is None else work.data_ptr(), ctr.data_ptr(), live.data_ptr(),
            stream)
    _raise_on(lib, err, f"wave_level kernel launch ({build} build)")
    return out


def _launch(out_prev, fuzz, tables: WaveTables, min_tp: float,
            record: bool = False) -> torch.Tensor:
    """Launch the package's build of the kernel (`package_build`), counted."""
    out = _launch_build(out_prev, fuzz, tables, min_tp, record, package_build(tables))
    wave_level.launches += 1
    if record:
        wave_level.record_launches += 1
    return out


def wave_level_build(out_prev: torch.Tensor, fuzz: Optional[torch.Tensor],
                     tables: WaveTables, build: str, min_tp: float = 0.0,
                     record: bool = False,
                     work: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The level by a named build of the kernel (WAVE_BUILDS), whichever the
    package would take: only for measuring builds against each other
    (chip_smoke.py).  CUDA tensors only; not counted in
    `wave_level.launches`."""
    if not out_prev.is_cuda:
        raise ValueError("wave_level_build runs on the card only")
    _check_level_args(out_prev, fuzz, tables)
    return _launch_build(out_prev, fuzz, tables, min_tp, record, build, work)


def wave_plan(tables: WaveTables, device=None, build: Optional[str] = None) -> dict:
    """What the kernel launches with for this table on the current card:
    the build (`package_build`, or `build`), list and queue capacities
    (entries), shared memory bytes of a block, resident blocks per SM, SMs,
    threads per block."""
    n_cols, g = tables.table.shape
    build = build or package_build(tables)
    n_win = 0 if tables.windows is None else tables.windows.shape[0]
    lib = _build.load()
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device or tables.table.device):
        err = lib.wave_level_plan(g, n_cols, tables.n_lights, WAVE_BUILDS[build], n_win, out)
    _raise_on(lib, err, "wave_level plan")
    keys = ("list_cap", "queue_cap", "smem_bytes", "blocks_per_sm", "sms", "threads")
    return dict(build=build, **dict(zip(keys, list(out))))


def wave_level_lane(
    out_prev: torch.Tensor,
    fuzz: Optional[torch.Tensor],
    tables: WaveTables,
    min_tp: float = 0.0,
) -> torch.Tensor:
    """The same level by the one-thread-per-lane schedule
    (csrc/wavefront.cu::wave_level_lane_kernel: every block stages the whole
    table, one thread runs one lane's three stages).  Only for measuring the
    package's kernel against it (chip_smoke.py); CUDA tensors and tables a
    block stages only."""
    if not out_prev.is_cuda:
        raise ValueError("wave_level_lane runs on the card only")
    _check_level_args(out_prev, fuzz, tables)
    out = torch.empty((OUT_ROWS, out_prev.shape[1]), dtype=torch.float32,
                      device=out_prev.device)
    args = _level_args(out_prev, fuzz, tables, min_tp, out)
    if not stages_table(tables):
        raise NotImplementedError("the one-thread-per-lane schedule stages the whole table")
    lib = _build.load()
    with torch.cuda.device(out_prev.device):
        err = lib.wave_level_lane_launch(
            *args, WAVE_THREADS, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "wave_level_lane kernel launch")
    return out


def wave_level(
    out_prev: torch.Tensor,
    fuzz: Optional[torch.Tensor],
    tables: WaveTables,
    min_tp: float = 0.0,
    record: bool = False,
) -> torch.Tensor:
    """One bounce level (see `wave_level_plain` for the operands and the
    record rows).  A CUDA tensor goes through the hand-written kernel or
    raises; only a CPU tensor takes the plain version.
    `wave_level.launches` counts kernel launches, `wave_level.record_launches`
    those of them in record mode."""
    if out_prev.is_cuda:
        _check_level_args(out_prev, fuzz, tables)
        return _launch(out_prev, fuzz, tables, min_tp, record)
    return wave_level_plain(out_prev, fuzz, tables, min_tp, record=record)


wave_level.launches = 0
wave_level.record_launches = 0


class WaveLevelFn(torch.autograd.Function):
    """One differentiable bounce level: the port of the JAX package's custom
    VJP of `wave_level_call`.

    Forward: `wave_level(..., record=True)` (the kernel for a CUDA tensor,
    the plain version for a CPU one) on detached views of the tables.
    Backward: `torch.autograd.grad` of `kernels/wave_ref.py::
    wave_level_ref`, the level rebuilt from the recorded decisions, with
    respect to out_prev, table and lights; fuzz and the static operands get
    no gradient.  The saved tensors are out_prev (the previous level's
    output, saved there already), fuzz, the two tables and this level's
    output, whose record rows the backward reads.

    apply(out_prev, fuzz, table, lights, tables, min_tp): table and lights
    are `tables.table` / `tables.lights` (of `wave_tables(scene,
    differentiable=True)`), passed apart so that autograd sees them."""

    @staticmethod
    def forward(ctx, out_prev, fuzz, table, lights, tables: WaveTables, min_tp: float):
        kt = dataclasses.replace(tables, table=table.detach(), lights=lights.detach())
        out = wave_level(out_prev.detach(), fuzz, kt, min_tp, record=True)
        ctx.save_for_backward(out_prev, fuzz, table, lights, out)
        ctx.static = (tables.ranges, tables.n_lights, tables.glossy, tables.has_tex, min_tp,
                      tables.motion, tables.refraction)
        return out

    @staticmethod
    def backward(ctx, g_out):
        from ray_tracying_tpu_torch.kernels.wave_ref import wave_level_ref

        out_prev, fuzz, table, lights, out = ctx.saved_tensors
        ranges, n_lights, glossy, has_tex, min_tp, motion, refraction = ctx.static
        best_id, vis, texel = split_record(out, n_lights, has_tex)
        wanted = ctx.needs_input_grad
        with spans.span("rtt.level_backward", lanes=out_prev.shape[1]), torch.enable_grad():
            xs = [
                t.detach().requires_grad_(bool(w))
                for t, w in ((out_prev, wanted[0]), (table, wanted[2]), (lights, wanted[3]))
            ]
            with spans.span("rtt.level_backward.recompute"):
                recon = wave_level_ref(
                    xs[0], fuzz, xs[1], xs[2], best_id, vis, texel,
                    kinds=[k for k, _, _ in ranges], n_lights=n_lights,
                    glossy=glossy, min_tp=min_tp, motion=motion, refraction=refraction,
                )
            need = [x for x in xs if x.requires_grad]
            with spans.span("rtt.level_backward.grad"):
                grads = iter(torch.autograd.grad(
                    recon, need, g_out[:OUT_ROWS], allow_unused=True
                ) if need else ())
        g_prev, g_table, g_lights = (next(grads) if x.requires_grad else None for x in xs)
        return g_prev, None, g_table, g_lights, None, None
