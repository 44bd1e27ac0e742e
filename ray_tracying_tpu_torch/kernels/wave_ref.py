"""Differentiable tensor-code reconstruction of one fused bounce level.

The fused level kernel (kernels/wavefront.py, csrc/wavefront.cu) is fast
but opaque to autograd.  `WaveLevelFn` therefore runs the kernel forward in
record mode, which appends the level's discrete decisions (the winner's
geom id, each light's raw visibility, the texel), and its backward rebuilds
the level as this function of (queue, fuzz, table, lights) GIVEN those
decisions, and differentiates the rebuild:

  - hit SELECTION (which geom wins) and shadow visibility are recorded and
    held fixed: they are piecewise constant in every parameter (the
    "closest-hit re-use" scope, the same contract as the general path,
    whose winner search is a kernel and whose pass 2 is tensor code);
  - the winner's hit distance and normal are RECOMPUTED from the winner's
    table row by the same per-kind math the kernels use
    (kernels/closest_hit.py::geom_t), so camera and geometry gradients keep
    their dt/d(origin) terms;
  - shading, attenuation, throughput weights and the continuation spawn
    (glossy fuzz included: the same fuzz rows the kernel consumed) are the
    reference's formulas, as in `wave_level_plain`.

The winner's record is gathered by INDEX (core/segment.py::
gather_columns, an `index_select` on the table's columns), never through a
(R, G) one-hot product; its backward sums each geom's lanes' cotangents
without atomics, the same bits on every run.  Rows of the queue and of the winner's record are
taken apart with `unbind`, whose backward stacks the row gradients once
(a select per row would allocate a zero tensor of the whole operand for
each).  Cost: one O(R * L) elementwise pass, no shadow-ray loops
(visibility is recorded).

Scope: what the fused level takes (`wave_refusal`): spheres, cubes and
rects, point lights, glossy reflection, in-kernel textures; no refraction,
motion or planes.

Port of the JAX package's kernels/wave_ref.py::wave_level_ref.
Reconstructs Code/raytracer.cpp:280-351, differentiated with respect to
materials, lights, and ray/camera parameters.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ray_tracying_tpu_torch.core import constants as C
from ray_tracying_tpu_torch.core.segment import gather_columns
from ray_tracying_tpu_torch.kernels.closest_hit import geom_t
from ray_tracying_tpu_torch.kernels.geom_table import GEOM_COLS

_TINY = 1e-20
# A FINITE miss distance: an inf primal turns the zero cotangent of a
# masked lane into NaN (0 * inf) in the backward of a product.
_MISS_T = 1e30
# Columns of a winner the rebuild reads: the geometry (0..16) and the
# material block up to reflectivity (17..28).
_N_NEED = GEOM_COLS + 12


def safe_sqrt(x2: torch.Tensor) -> torch.Tensor:
    """sqrt with a finite gradient at 0 (dead lanes hold zeros; sqrt'(0) =
    inf times a zero cotangent would poison the backward with NaN).  Values
    equal torch.sqrt(max(x2, 0))."""
    pos = x2 > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x2, 1.0)), 0.0)


class _Rays:
    """The ray attributes geom_t reads, from rows 0..6 of a queue (a
    sequence of (R,) tensors), with a safe |d|."""

    __slots__ = ("ox", "oy", "oz", "dx", "dy", "dz", "tm", "dnorm")

    def __init__(self, q):
        self.ox, self.oy, self.oz = q[0], q[1], q[2]
        self.dx, self.dy, self.dz = q[3], q[4], q[5]
        self.tm = q[6]
        self.dnorm = safe_sqrt(self.dx * self.dx + self.dy * self.dy + self.dz * self.dz)


def winner_rows(table: torch.Tensor, best_id: torch.Tensor) -> torch.Tensor:
    """(R,) int64 table row of each lane's recorded winner id; -1 for none.
    The ids of a packed table (column 16) are a permutation of 0..G-1, so
    the inverse permutation needs no host read."""
    ids = torch.round(table[16].detach()).to(torch.int64)
    g = ids.shape[0]
    row_of = torch.empty_like(ids)
    row_of[ids] = torch.arange(g, device=table.device)
    bid = best_id.detach().to(torch.int64)
    return torch.where(bid >= 0, row_of[torch.clamp(bid, min=0)], -1)


def wave_level_ref(
    out_prev: torch.Tensor,
    fuzz: Optional[torch.Tensor],
    table: torch.Tensor,
    lights: torch.Tensor,
    best_id: torch.Tensor,
    vis: torch.Tensor,
    texel: Optional[torch.Tensor],
    *,
    kinds: Sequence[int],
    n_lights: int,
    glossy: bool,
    min_tp: float = 0.0,
) -> torch.Tensor:
    """Rebuild rows 0..12 of a level's output from its recorded decisions.

    out_prev: (rows >= 9, R) the level's input (queue in rows 0..8).
    fuzz: (>= 3, R) the glossy fuzz rows the kernel consumed, or None.
    table: (n_cols, G) shaded table as the kernel got it (transposed).
    lights: (8, L) light table.  best_id: (R,) recorded winner geom id (-1
    none); vis: (L, R) recorded visibility; texel: (3, R) recorded texel
    (textured scenes) or None.  All three are held fixed.  kinds: the geom
    kinds of the table's ranges.  Returns (13, R)."""
    q = out_prev[:9].unbind(0)
    rb = _Rays(q)
    act = q[7].detach() > 0.0
    tp = q[8]
    zero = torch.zeros_like(tp)
    best_id = best_id.detach()
    vis = vis.detach()
    won = best_id >= 0.0
    hit_f = won & act

    # --- the winner's record, gathered by index; no winner -> all zero.
    rows = winner_rows(table, best_id)
    win = gather_columns(table[:_N_NEED], torch.clamp(rows, min=0))
    win = torch.where((rows >= 0)[None, :], win, 0.0).unbind(0)
    dr, dg, db, sr, sg, sb, ka, kd, ks, shin, rough, refl = win[GEOM_COLS:]

    # --- the winner's distance and unnormalized normal by its kind's test.
    kind = win[15].detach()
    best_t = torch.full_like(tp, _MISS_T)
    bnx = bny = bnz = zero
    for k in kinds:
        t_k, (nx_k, ny_k, nz_k) = geom_t(win, rb, k, want_normal=True, miss_t=_MISS_T)
        sel = kind == float(k)
        best_t = torch.where(sel, t_k, best_t)
        bnx = torch.where(sel, nx_k, bnx)
        bny = torch.where(sel, ny_k, bny)
        bnz = torch.where(sel, nz_k, bnz)
    ln = safe_sqrt(bnx * bnx + bny * bny + bnz * bnz)
    inv_n = 1.0 / torch.clamp(ln, min=_TINY)
    nx, ny, nz = bnx * inv_n, bny * inv_n, bnz * inv_n

    t_fin = torch.where(hit_f & (best_t < 1e29), best_t, zero)
    px = rb.ox + t_fin * rb.dx
    py = rb.oy + t_fin * rb.dy
    pz = rb.oz + t_fin * rb.dz
    vx, vy, vz = -rb.dx, -rb.dy, -rb.dz

    w_miss = torch.where(act & ~won, tp, zero)
    w_local = torch.where(hit_f, tp * torch.clamp(1.0 - refl, min=0.0), zero)
    amb = ka * w_local
    d_r, d_g, d_b = dr * amb, dg * amb, db * amb
    s_r = w_miss * C.BACKGROUND_RGB[0]
    s_g = w_miss * C.BACKGROUND_RGB[1]
    s_b = w_miss * C.BACKGROUND_RGB[2]

    # --- Blinn-Phong from the light center (Code/raytracer.cpp:244-262),
    # visibility recorded.
    for li in range(n_lights):
        lpx, lpy, lpz = lights[0, li], lights[1, li], lights[2, li]
        lr, lg, lb = lights[3, li], lights[4, li], lights[5, li]
        lvx, lvy, lvz = lpx - px, lpy - py, lpz - pz
        d2 = lvx * lvx + lvy * lvy + lvz * lvz
        dist = torch.sqrt(torch.clamp(d2, min=_TINY))
        inv_d = 1.0 / torch.clamp(dist, min=_TINY)
        lcx, lcy, lcz = lvx * inv_d, lvy * inv_d, lvz * inv_d
        ndotl = torch.clamp(nx * lcx + ny * lcy + nz * lcz, min=0.0)
        hx, hy, hz = lcx + vx, lcy + vy, lcz + vz
        inv_h = 1.0 / torch.clamp(safe_sqrt(hx * hx + hy * hy + hz * hz), min=_TINY)
        ndoth = torch.clamp(nx * hx * inv_h + ny * hy * inv_h + nz * hz * inv_h, min=0.0)
        spec_i = torch.where(
            ndoth > 0.0, torch.exp(shin * torch.log(torch.clamp(ndoth, min=1e-12))), zero
        )
        atten = C.ATTEN_NUM * lights[6, li] / (
            C.ATTEN_C0 + C.ATTEN_C1 * dist + C.ATTEN_C2 * d2
        )
        scale = atten * w_local
        dif = kd * ndotl * scale * vis[li]
        spc = ks * spec_i * scale * vis[li]
        d_r = d_r + lr * dr * dif
        d_g = d_g + lg * dg * dif
        d_b = d_b + lb * db * dif
        s_r = s_r + lr * sr * spc
        s_g = s_g + lg * sg * spc
        s_b = s_b + lb * sb * spc

    if texel is not None:
        tex = texel.detach()
        c_r, c_g, c_b = d_r * tex[0] + s_r, d_g * tex[1] + s_g, d_b * tex[2] + s_b
    else:
        c_r, c_g, c_b = d_r + s_r, d_g + s_g, d_b + s_b

    # --- reflection continuation (Code/raytracer.cpp:307-333), the fuzz
    # rows the kernel consumed.
    sox = px + nx * C.EPS_NORMAL_OFFSET
    soy = py + ny * C.EPS_NORMAL_OFFSET
    soz = pz + nz * C.EPS_NORMAL_OFFSET
    ddn = rb.dx * nx + rb.dy * ny + rb.dz * nz
    rdx = rb.dx - 2.0 * ddn * nx
    rdy = rb.dy - 2.0 * ddn * ny
    rdz = rb.dz - 2.0 * ddn * nz
    if glossy:
        gx = rdx + rough * fuzz[0]
        gy = rdy + rough * fuzz[1]
        gz = rdz + rough * fuzz[2]
        inv_g = 1.0 / torch.clamp(safe_sqrt(gx * gx + gy * gy + gz * gz), min=_TINY)
        gx, gy, gz = gx * inv_g, gy * inv_g, gz * inv_g
        below = (gx * nx + gy * ny + gz * nz).detach() < 0.0
        isg = rough.detach() > 0.0
        rdx = torch.where(isg, torch.where(below, zero, gx), rdx)
        rdy = torch.where(isg, torch.where(below, zero, gy), rdy)
        rdz = torch.where(isg, torch.where(below, zero, gz), rdz)
    rd2 = (rdx * rdx + rdy * rdy + rdz * rdz).detach()
    tp2 = tp * refl
    ok = hit_f & (refl.detach() > 0.0) & (rd2 > C.EPS_GLOSSY_DIR2)
    if min_tp > 0.0:
        ok = ok & (tp2.detach() > min_tp)

    return torch.stack(
        [
            sox, soy, soz, rdx, rdy, rdz,
            zero,
            torch.where(ok, 1.0, 0.0),
            torch.where(ok, tp2, zero),
            c_r, c_g, c_b,
            torch.where(hit_f, 1.0, 0.0),
        ]
    )

