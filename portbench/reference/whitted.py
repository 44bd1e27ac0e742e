"""The benchmark's plain reference renderer: recursive Whitted shading of a
scene.json dict, in plain PyTorch, lane by lane.

It follows the reference C++ renderer (EricZhang12138/Ray_Tracying,
Code/raytracer.cpp, Code/shapes.cpp, Code/camera.cpp, Code/material.hpp)
as the renderer under test documents it: a pinhole camera with stratified
jitter, closest hits by brute force over every primitive, Blinn-Phong
shading from point lights with hard shadows, nearest-texel textures, and
one reflection continuation a hit (glossy: the mirror direction plus
roughness times a point of the unit ball), eleven levels deep.  It parses
the scene dict itself and shares no code and no data with the renderer
under test.

Scope: spheres without motion, cubes and rectangles; point lights; opaque
materials.  A scene with anything else (legacy planes, area lights, motion,
refraction, a thin lens) raises, so that a configuration that needs more
brings a reference of its own.

The closest-hit search runs without gradients; the winner's distance,
normal, shading and continuation are recomputed from its parameters with
plain tensor operations, so that autograd gives the derivative of the
image with the hit selection and the shadow visibility held fixed.

`tf32=True` is the benchmark's control: every world-to-object
transform of a ray is computed from operands rounded to TF32's ten mantissa
bits, as a 3x4 contraction on the matrix unit with TF32 enabled would.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

SPHERE, CUBE, RECT = 0, 1, 2
LEVELS = 11
BACKGROUND = 0.1
GAMMA = 1.1
QUANT_SCALE = 255.999
EPS_NORMAL = 1e-4
EPS_T = 1e-3
EPS_PARALLEL = 1e-6
EPS_GLOSSY_DIR2 = 1e-3
ATTEN = (10.0, 25.0, 10.0, 150.0)
_TINY = 1e-20
# elements of a (rays, primitives) block of the brute-force search
BLOCK_ELEMS = 1 << 23


def read_ppm(path: str) -> np.ndarray:
    """ASCII (P3) or binary (P6) PPM -> (H, W, 3) uint8; '#' comments."""
    with open(path, "rb") as f:
        raw = f.read()
    tokens, pos = [], 0
    while len(tokens) < 4:
        while raw[pos:pos + 1].isspace():
            pos += 1
        if raw[pos:pos + 1] == b"#":
            pos = raw.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(raw) and not raw[end:end + 1].isspace():
            end += 1
        tokens.append(raw[pos:end])
        pos = end
    magic, w, h, maxv = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if magic == b"P6":
        data = np.frombuffer(raw[pos + 1:pos + 1 + w * h * 3], np.uint8)
    elif magic == b"P3":
        body = b"\n".join(ln.split(b"#")[0] for ln in raw[pos:].split(b"\n"))
        data = np.array(body.split()[: w * h * 3], np.int64)
    else:
        raise ValueError(f"{path}: not a P3 or P6 PPM")
    data = np.clip(data.astype(np.float64) * (255.0 / maxv), 0, 255)
    return data.astype(np.uint8).reshape(h, w, 3)


def _euler_xyz(r: np.ndarray) -> np.ndarray:
    """Rz @ Ry @ Rx (Code/shapes.cpp:100-110); r (N, 3) -> (N, 3, 3)."""
    cx, sx = np.cos(r[:, 0]), np.sin(r[:, 0])
    cy, sy = np.cos(r[:, 1]), np.sin(r[:, 1])
    cz, sz = np.cos(r[:, 2]), np.sin(r[:, 2])
    return np.stack([
        np.stack([cy * cz, sx * sy * cz - cx * sz, cx * sy * cz + sx * sz], -1),
        np.stack([cy * sz, sx * sy * sz + cx * cz, cx * sy * sz - sx * cz], -1),
        np.stack([-sy, sx * cy, cx * cy], -1),
    ], axis=-2).astype(np.float32)


def _material(m: Optional[dict]) -> list:
    """[diffuse rgb, specular rgb, ka, kd, ks, shininess, roughness,
    reflectivity, transparency] with the loader's two sets of defaults
    (Code/material.hpp:52-70 without a block, Code/json_loader.cpp:45-69
    inside one)."""
    if m is None:
        return [0.8, 0.8, 0.8, 1.0, 1.0, 1.0, 0.1, 0.9, 0.3, 20.0, 0.0, 0.0, 0.0]
    rough_shin = float(m.get("roughness", 0.001))
    rc = min(max(rough_shin, 0.001), 1.0)
    return [*m.get("diffuse_color", (0.8, 0.8, 0.8)), *m.get("specular_color", (1.0, 1.0, 1.0)),
            float(m.get("k_ambient", 0.1)), float(m.get("k_diffuse", 0.6)),
            float(m.get("k_specular", 0.6)), 5.0 / (rc * rc), float(m.get("roughness", 0.0)),
            float(m.get("reflectivity", 0.0)), float(m.get("transparency", 0.0))]


class RefScene:
    """The scene dict's primitives, materials, lights and camera as tensors.

    Primitive order is the reference loader's: spheres, cubes, rectangles.
    Each primitive carries its world->object (`w2o`) 3x4 as 12 columns."""

    def __init__(self, data: dict, textures_dir: Optional[str], device):
        kinds, trs, mats, tex_of, textures = [], [], [], [], []
        tex_index = {}
        for key, kind in (("spheres", SPHERE), ("cubes", CUBE), ("rectangles", RECT)):
            for p in data.get(key, []) or []:
                if kind == SPHERE:
                    if any(p.get("velocity", (0, 0, 0))):
                        raise NotImplementedError("moving spheres")
                    r = float(p.get("radius", 1.0))
                    trs.append((p["location"], p.get("rotation", (0, 0, 0)), p.get("scale", (r, r, r))))
                else:
                    sc = p.get("scale", 1.0)
                    trs.append((p["translation"], p["rotation"],
                                sc if isinstance(sc, (list, tuple)) else (sc, sc, sc)))
                kinds.append(kind)
                m = p.get("material")
                mats.append(_material(m))
                tid = -1
                tf = (m or {}).get("texture_file", "")
                if tf and textures_dir is not None:
                    name = tf[:-3] + "ppm"
                    if name not in tex_index:
                        path = os.path.join(textures_dir, name)
                        tex_index[name] = len(textures) if os.path.exists(path) else -1
                        if os.path.exists(path):
                            textures.append(read_ppm(path))
                    tid = tex_index[name]
                tex_of.append(tid)
        if data.get("planes"):
            raise NotImplementedError("legacy planes")
        mats_np = np.array(mats, np.float32)
        if (mats_np[:, 12] > 0).any():
            raise NotImplementedError("refraction")
        t = np.array([x[0] for x in trs], np.float32)
        rot = _euler_xyz(np.array([x[1] for x in trs], np.float32))
        s = np.array([x[2] for x in trs], np.float32)
        lin_inv = np.swapaxes(rot, -1, -2) / s[:, :, None]
        t_inv = -np.einsum("nij,nj->ni", lin_inv, t)
        w2o = np.concatenate([lin_inv, t_inv[:, :, None]], -1).reshape(-1, 12)

        f = dict(device=device, dtype=torch.float32)
        self.device = torch.device(device)
        self.kind = torch.tensor(kinds, device=device)
        self.w2o = torch.tensor(w2o, **f)
        self.kind_ids = {k: torch.nonzero(self.kind == k).flatten() for k in (SPHERE, CUBE, RECT)}
        self.diffuse = torch.tensor(mats_np[:, 0:3], **f)
        self.specular = torch.tensor(mats_np[:, 3:6], **f)
        (self.ka, self.kd, self.ks, self.shininess, self.roughness,
         self.reflectivity) = (torch.tensor(mats_np[:, i], **f) for i in range(6, 12))
        self.tex_id = torch.tensor(tex_of, device=device)
        if textures:
            hh = max(x.shape[0] for x in textures)
            ww = max(x.shape[1] for x in textures)
            atlas = np.zeros((len(textures), hh, ww, 3), np.float32)
            for i, x in enumerate(textures):
                atlas[i, : x.shape[0], : x.shape[1]] = x / 255.0
            self.atlas = torch.tensor(atlas, **f)
            self.tex_wh = torch.tensor([[x.shape[1], x.shape[0]] for x in textures], device=device)
        else:
            self.atlas = self.tex_wh = None

        lights = [lj for lj in data.get("lights", []) or [] if float(lj["intensity"]) > 0]
        if any(float(lj.get("radius", 0.0)) > 0 for lj in lights):
            raise NotImplementedError("area lights")
        self.light_pos = torch.tensor([lj["location"] for lj in lights], **f).reshape(-1, 3)
        self.light_color = torch.tensor([lj["color"] for lj in lights], **f).reshape(-1, 3)
        self.light_intensity = torch.tensor([float(lj["intensity"]) for lj in lights], **f)

        cam = data["cameras"][0]
        if float(cam.get("aperture", 0.0)) > 0:
            raise NotImplementedError("thin lens")
        self.cam_location = torch.tensor(cam["location"], **f)
        self.cam_gaze = torch.tensor(cam["gaze_vector"], **f)
        self.cam_up = torch.tensor(cam["up_vector"], **f)
        self.focal = float(np.float32(cam["focal_length"]))
        self.sensor = (float(np.float32(cam["sensor_width"])), float(np.float32(cam["sensor_height"])))
        self.resolution = (int(data["render"]["resolution_x"]), int(data["render"]["resolution_y"]))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, round to nearest)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _normalize(x, y, z):
    inv = 1.0 / torch.sqrt(torch.clamp(x * x + y * y + z * z, min=_TINY))
    return x * inv, y * inv, z * inv


def camera_rays(sc: RefScene, px: torch.Tensor, py: torch.Tensor):
    """Pinhole rays through pixel positions (Code/camera.cpp:98-140):
    NDC flips both axes, basis z = |gaze|, x = |up x z|, y = |z x x|."""
    g, u = sc.cam_gaze, sc.cam_up
    zx, zy, zz = _normalize(g[0], g[1], g[2])
    xx, xy, xz = _normalize(u[1] * zz - u[2] * zy, u[2] * zx - u[0] * zz, u[0] * zy - u[1] * zx)
    yx, yy, yz = _normalize(zy * xz - zz * xy, zz * xx - zx * xz, zx * xy - zy * xx)
    w, h = sc.resolution
    nx = (1.0 - (px / float(w)) * 2.0) * (sc.sensor[0] / 2.0)
    ny = (1.0 - (py / float(h)) * 2.0) * (sc.sensor[1] / 2.0)
    dx, dy, dz = _normalize(nx * xx + ny * yx + sc.focal * zx,
                            nx * xy + ny * yy + sc.focal * zy,
                            nx * xz + ny * yz + sc.focal * zz)
    loc = sc.cam_location
    return [loc[0].expand_as(dx), loc[1].expand_as(dx), loc[2].expand_as(dx)], [dx, dy, dz]


def _local(m, o, d, tf32: bool):
    """World -> object space of rays o, d (lists of tensors) by 3x4 rows m
    (a list of 12 tensors broadcasting against them)."""
    if tf32:
        m, o, d = [_tf32(v) for v in m], [_tf32(v) for v in o], [_tf32(v) for v in d]
    ol = [o[0] * m[4 * i] + o[1] * m[4 * i + 1] + o[2] * m[4 * i + 2] + m[4 * i + 3] for i in range(3)]
    dl = [d[0] * m[4 * i] + d[1] * m[4 * i + 1] + d[2] * m[4 * i + 2] for i in range(3)]
    return ol, dl


def _kind_t(kind: int, ol, dl, inf: float = math.inf):
    """Object-space distance of each kind's test (Code/shapes.cpp): the unit
    sphere (t > 1e-3, near root first), the unit cube (t > 0, the entry
    face's t or else the exit's) and the unit square on z = 0 (t >= 1e-3).
    Returns (t, per-axis entry t, per-axis entry sign) — the last two for
    cubes only."""
    if kind == SPHERE:
        a = dl[0] * dl[0] + dl[1] * dl[1] + dl[2] * dl[2]
        b = 2.0 * (ol[0] * dl[0] + ol[1] * dl[1] + ol[2] * dl[2])
        c = ol[0] * ol[0] + ol[1] * ol[1] + ol[2] * ol[2] - 1.0
        disc = b * b - 4.0 * a * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        a2 = 2.0 * torch.where(a > 0, a, torch.ones_like(a))
        t1, t2 = (-b - sq) / a2, (-b + sq) / a2
        t = torch.where(t1 > EPS_T, t1, torch.where(t2 > EPS_T, t2, inf))
        return torch.where((disc >= 0) & (a > 0), t, inf), None, None
    if kind == CUBE:
        ents, sgns, exits, miss = [], [], [], None
        for o, d in zip(ol, dl):
            par = torch.abs(d) < EPS_PARALLEL
            dd = torch.where(par, torch.ones_like(d), d)
            s1, s2 = (-0.5 - o) / dd, (0.5 - o) / dd
            ents.append(torch.where(par, -inf, torch.minimum(s1, s2)))
            exits.append(torch.where(par, inf, torch.maximum(s1, s2)))
            sgns.append(torch.where(s1 < s2, -1.0, 1.0))
            out = par & ((o < -0.5) | (o > 0.5))
            miss = out if miss is None else miss | out
        near = torch.maximum(torch.maximum(ents[0], ents[1]), ents[2])
        far = torch.minimum(torch.minimum(exits[0], exits[1]), exits[2])
        t = torch.where(near > 0, near, far)
        return torch.where(miss | (near > far) | (far < 0) | (t < 0), inf, t), ents, sgns
    par = torch.abs(dl[2]) < EPS_PARALLEL
    t = -ol[2] / torch.where(par, torch.ones_like(dl[2]), dl[2])
    hx, hy = ol[0] + t * dl[0], ol[1] + t * dl[1]
    ok = ~par & (t >= EPS_T) & (hx >= -0.5) & (hx <= 0.5) & (hy >= -0.5) & (hy <= 0.5)
    return torch.where(ok, t, inf), None, None


@torch.no_grad()
def closest(sc: RefScene, o, d, tf32: bool = False):
    """Brute-force closest hit of every ray against every primitive ->
    (t (R,), primitive id (R,), -1 for a miss); distances are Euclidean
    (object t times |d|), ties go to the lower id."""
    r = o[0].shape[0]
    best_t = torch.full((r,), math.inf, device=sc.device)
    best_id = torch.full((r,), -1, device=sc.device, dtype=torch.int64)
    dnorm = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    for kind in (SPHERE, CUBE, RECT):
        ids = sc.kind_ids[kind]
        if ids.numel() == 0:
            continue
        m = [c[None, :] for c in sc.w2o[ids].unbind(1)]
        step = max(1, BLOCK_ELEMS // ids.numel())
        for a in range(0, r, step):
            sl = slice(a, min(r, a + step))
            ol, dl = _local(m, [x[sl, None] for x in o], [x[sl, None] for x in d], tf32)
            t = _kind_t(kind, ol, dl)[0] * dnorm[sl, None]
            tmin, arg = torch.min(t, dim=1)
            better = tmin < best_t[sl]
            best_t[sl] = torch.where(better, tmin, best_t[sl])
            best_id[sl] = torch.where(better, ids[arg], best_id[sl])
    return best_t, torch.where(torch.isfinite(best_t), best_id, -1)


@torch.no_grad()
def occluded(sc: RefScene, o, d, maxt, tf32: bool = False):
    """(R,) bool: some primitive lies on the ray at a distance <= maxt."""
    t, _ = closest(sc, o, d, tf32)
    return t <= maxt


def _hit_record(sc: RefScene, gid, o, d, tf32: bool):
    """The winner's distance, world unit normal and (u, v), recomputed from
    its own parameters (differentiable in them and in the ray)."""
    m = list(sc.w2o[gid].unbind(1))
    ol, dl = _local(m, o, d, tf32)
    kind = sc.kind[gid]
    zero = torch.zeros_like(ol[0])
    dnorm = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    t_loc, nl, uv = zero, [zero, zero, zero], [zero, zero]
    for k in (SPHERE, CUBE, RECT):
        if sc.kind_ids[k].numel() == 0:
            continue
        sel = kind == k
        tk, ents, sgns = _kind_t(k, ol, dl, inf=0.0)
        pl = [ol[i] + tk * dl[i] for i in range(3)]
        if k == SPHERE:
            nk = pl
            uk = [0.5 + torch.atan2(pl[2], pl[0]) / (2.0 * math.pi),
                  0.5 - torch.asin(torch.clamp(pl[1], -1.0, 1.0)) / math.pi]
        elif k == CUBE:
            # the entry face: first of equal maxima (Code/shapes.cpp:392-402)
            w1 = ents[1] > ents[0]
            w2 = ents[2] > torch.where(w1, ents[1], ents[0])
            ax = torch.where(w2, 2, torch.where(w1, 1, 0))
            sgn = torch.where(w2, sgns[2], torch.where(w1, sgns[1], sgns[0]))
            nk = [torch.where(ax == i, sgn, zero) for i in range(3)]
            uc, vc, wc = pl[0] + 0.5, pl[1] + 0.5, pl[2] + 0.5
            pos = sgn > 0
            uk = [torch.where(ax == 0, torch.where(pos, wc, 1.0 - wc),
                              torch.where(ax == 1, uc, torch.where(pos, uc, 1.0 - uc))),
                  torch.where(ax == 0, vc, torch.where(ax == 1, torch.where(pos, wc, 1.0 - wc), vc))]
        else:
            nk = [zero, zero, torch.ones_like(zero)]
            uk = [pl[0] + 0.5, pl[1] + 0.5]
        t_loc = torch.where(sel, tk, t_loc)
        nl = [torch.where(sel, a, b) for a, b in zip(nk, nl)]
        uv = [torch.where(sel, a, b) for a, b in zip(uk, uv)]
    # world normal = w2o^T n_local, normalized (Code/shapes.cpp:178-187)
    nw = [m[i] * nl[0] + m[4 + i] * nl[1] + m[8 + i] * nl[2] for i in range(3)]
    return t_loc * dnorm, _normalize(*nw), uv


def _diffuse(sc: RefScene, gid, uv):
    """Base diffuse times the nearest texel, v flipped (Code/material.hpp:99-134)."""
    base = sc.diffuse[gid]
    if sc.atlas is None:
        return base
    tid = sc.tex_id[gid]
    ts = torch.clamp(tid, min=0)
    w = sc.tex_wh[ts, 0].float()
    h = sc.tex_wh[ts, 1].float()
    x = torch.minimum(torch.clamp(torch.floor(uv[0] * (w - 1.0)), min=0.0), w - 1.0).long()
    y = torch.minimum(torch.clamp(torch.floor((1.0 - uv[1]) * (h - 1.0)), min=0.0), h - 1.0).long()
    tex = sc.atlas[ts, y, x]
    return torch.where((tid >= 0)[:, None], tex * base, base)


def unit_ball(gen: torch.Generator, n: int, device):
    """(n, 3) uniform in the unit ball: a normal direction times U^(1/3)."""
    g = torch.randn((n, 3), generator=gen, device=device)
    u = torch.rand((n, 1), generator=gen, device=device)
    return g / torch.clamp(g.norm(dim=1, keepdim=True), min=1e-12) * u.pow(1.0 / 3.0)


def trace(sc: RefScene, o, d, gen: torch.Generator, tf32: bool = False) -> torch.Tensor:
    """Linear radiance (R, 3) of rays o, d (lists of three (R,) tensors):
    eleven levels, a level's continuation at the last level dropped
    (Code/raytracer.cpp:280-351)."""
    r = o[0].shape[0]
    out = torch.zeros((r, 3), device=sc.device)
    lane = torch.arange(r, device=sc.device)
    tp = torch.ones((r,), device=sc.device)
    for level in range(LEVELS):
        if lane.numel() == 0:
            break
        _, gid = closest(sc, o, d, tf32)
        hit = gid >= 0
        miss_c = torch.where(hit, 0.0, tp * BACKGROUND)
        out = out.index_add(0, lane, miss_c[:, None].expand(-1, 3))
        keep = torch.nonzero(hit).flatten()
        lane, gid, tp = lane[keep], gid[keep], tp[keep]
        o, d = [x[keep] for x in o], [x[keep] for x in d]
        if lane.numel() == 0:
            break
        t, n, uv = _hit_record(sc, gid, o, d, tf32)
        p = [o[i] + t * d[i] for i in range(3)]
        v = [-d[0], -d[1], -d[2]]
        refl = sc.reflectivity[gid]
        w_local = tp * torch.clamp(1.0 - refl, min=0.0)
        diff = _diffuse(sc, gid, uv)
        col = diff * sc.ka[gid][:, None]
        so = [p[i] + n[i] * EPS_NORMAL for i in range(3)]
        for li in range(sc.light_pos.shape[0]):
            lp = sc.light_pos[li]
            lv = [lp[i] - p[i] for i in range(3)]
            d2 = lv[0] * lv[0] + lv[1] * lv[1] + lv[2] * lv[2]
            dist = torch.sqrt(torch.clamp(d2, min=_TINY))
            lc = [x / dist for x in lv]
            ndotl = torch.clamp(n[0] * lc[0] + n[1] * lc[1] + n[2] * lc[2], min=0.0)
            hv = _normalize(lc[0] + v[0], lc[1] + v[1], lc[2] + v[2])
            ndoth = torch.clamp(n[0] * hv[0] + n[1] * hv[1] + n[2] * hv[2], min=0.0)
            spec = torch.where(ndoth > 0, torch.pow(torch.clamp(ndoth, min=1e-12), sc.shininess[gid]), 0.0)
            atten = ATTEN[0] * sc.light_intensity[li] / (ATTEN[1] + ATTEN[2] * dist + ATTEN[3] * d2)
            contrib = sc.light_color[li] * (diff * (sc.kd[gid] * ndotl)[:, None]
                                            + sc.specular[gid] * (sc.ks[gid] * spec)[:, None]) * atten[:, None]
            blocked = occluded(sc, so, lc, dist, tf32)
            col = col + torch.where(blocked[:, None], 0.0, contrib)
        out = out.index_add(0, lane, col * w_local[:, None])
        if level == LEVELS - 1:
            break
        # reflection continuation (Code/raytracer.cpp:307-333)
        ddn = d[0] * n[0] + d[1] * n[1] + d[2] * n[2]
        rd = [d[i] - 2.0 * ddn * n[i] for i in range(3)]
        rough = sc.roughness[gid]
        glossy = rough > 0
        if bool(glossy.any()):
            fz = unit_ball(gen, lane.numel(), sc.device)
            g = _normalize(*[rd[i] + rough * fz[:, i] for i in range(3)])
            below = (g[0] * n[0] + g[1] * n[1] + g[2] * n[2]) < 0
            rd = [torch.where(glossy, torch.where(below, 0.0, g[i]), rd[i]) for i in range(3)]
        rd2 = rd[0] * rd[0] + rd[1] * rd[1] + rd[2] * rd[2]
        go = torch.nonzero((refl > 0) & (rd2 > EPS_GLOSSY_DIR2)).flatten()
        lane, tp = lane[go], (tp * refl)[go]
        o, d = [x[go] for x in so], [x[go] for x in rd]
    return out


def to_srgb_u8(linear: torch.Tensor) -> torch.Tensor:
    """Gamma 1.1, clamp, * 255.999, truncated (Code/raytracer.cpp:446-457)."""
    c = torch.pow(torch.clamp(linear, min=0.0), 1.0 / GAMMA)
    return (torch.clamp(c, 0.0, 1.0) * QUANT_SCALE).to(torch.uint8)


def sample_positions(px: torch.Tensor, py: torch.Tensor, samples_sqrt: int, copies: int,
                     gen: torch.Generator):
    """Stratified sample positions of pixels (x, y) (Code/raytracer.cpp:46-66):
    `copies` independent sets of n x n jittered strata a pixel ->
    (P, copies, spp) positions; one centered sample when n <= 1."""
    p = px.shape[0]
    dev = px.device
    if samples_sqrt <= 1:
        x = px[:, None, None].float() + torch.full((p, copies, 1), 0.5, device=dev)
        y = py[:, None, None].float() + torch.full((p, copies, 1), 0.5, device=dev)
        return x, y
    n = samples_sqrt
    idx = torch.arange(n, device=dev, dtype=torch.float32)
    sx = idx[None, :].expand(n, n).reshape(-1)
    sy = idx[:, None].expand(n, n).reshape(-1)
    j = torch.rand((p, copies, n * n, 2), generator=gen, device=dev)
    x = px[:, None, None].float() + (sx + j[..., 0]) / n
    y = py[:, None, None].float() + (sy + j[..., 1]) / n
    return x, y


@torch.no_grad()
def render_pixels(sc: RefScene, px: torch.Tensor, py: torch.Tensor, samples_sqrt: int,
                  copies: int, gen: torch.Generator, tf32: bool = False,
                  max_rays: int = 1 << 21) -> torch.Tensor:
    """`copies` independent renders of pixels (px, py) at samples_sqrt^2
    samples each, quantized as a frame is -> (copies, P, 3) uint8."""
    x, y = sample_positions(px, py, samples_sqrt, copies, gen)
    p, c, s = x.shape
    x, y = x.reshape(-1), y.reshape(-1)
    lin = torch.empty((p * c * s, 3), device=sc.device)
    for a in range(0, x.shape[0], max_rays):
        sl = slice(a, a + max_rays)
        o, d = camera_rays(sc, x[sl], y[sl])
        lin[sl] = trace(sc, o, d, gen, tf32)
    mean = lin.reshape(p, c, s, 3).mean(dim=2)
    return to_srgb_u8(mean).permute(1, 0, 2)


# --- differentiable rendering and Adam, for the fit mix -------------------

# The renderer's parameter paths (its diff/params.py names) and the
# RefScene tensors they name.
PARAMS = {
    "materials.diffuse": "diffuse", "materials.specular": "specular",
    "materials.k_ambient": "ka", "materials.k_diffuse": "kd", "materials.k_specular": "ks",
    "materials.roughness": "roughness", "materials.reflectivity": "reflectivity",
    "lights.position": "light_pos", "lights.color": "light_color",
    "lights.intensity": "light_intensity", "camera.location": "cam_location",
}


def leaves(sc: RefScene, paths) -> dict:
    """{path: the scene's tensor there, made a leaf that requires grad};
    the scene renders with them."""
    out = {}
    for p in paths:
        t = getattr(sc, PARAMS[p]).detach().clone().requires_grad_(True)
        setattr(sc, PARAMS[p], t)
        out[p] = t
    return out


def pixel_grid(sc: RefScene, rows: slice):
    """Pixel (x, y) of every pixel of image rows `rows`, row-major."""
    w, _ = sc.resolution
    ys = torch.arange(rows.start, rows.stop, device=sc.device)
    y = ys[:, None].expand(-1, w).reshape(-1)
    x = torch.arange(w, device=sc.device)[None, :].expand(ys.numel(), -1).reshape(-1)
    return x, y


def render_linear(sc: RefScene, samples_sqrt: int, gen: torch.Generator, tf32: bool = False,
                  rows_per_pass: int = 256) -> torch.Tensor:
    """The whole image, (H, W, 3) linear radiance, without gradients."""
    w, h = sc.resolution
    out = []
    with torch.no_grad():
        for a in range(0, h, rows_per_pass):
            x, y = pixel_grid(sc, slice(a, min(h, a + rows_per_pass)))
            sx, sy = sample_positions(x, y, samples_sqrt, 1, gen)
            o, d = camera_rays(sc, sx.reshape(-1), sy.reshape(-1))
            out.append(trace(sc, o, d, gen, tf32).reshape(x.numel(), -1, 3).mean(dim=1))
    return torch.cat(out).reshape(h, w, 3)


def mse_backward(sc: RefScene, target: torch.Tensor, samples_sqrt: int, gen: torch.Generator,
                 tf32: bool = False, rows_per_pass: int = 128) -> float:
    """The mean squared error of the image against `target` (H, W, 3);
    its gradient is added into the leaves' .grad, a block of rows at a time."""
    w, h = sc.resolution
    total = 0.0
    for a in range(0, h, rows_per_pass):
        rows = slice(a, min(h, a + rows_per_pass))
        x, y = pixel_grid(sc, rows)
        sx, sy = sample_positions(x, y, samples_sqrt, 1, gen)
        o, d = camera_rays(sc, sx.reshape(-1), sy.reshape(-1))
        img = trace(sc, o, d, gen, tf32).reshape(x.numel(), -1, 3).mean(dim=1)
        term = ((img - target[rows].reshape(-1, 3)) ** 2).sum() / float(w * h * 3)
        if term.requires_grad:  # rows that see only the background have no gradient
            term.backward()
        total += float(term.detach())
    return total


class Adam:
    """Adam (Kingma and Ba): m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
    p -= lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)."""

    def __init__(self, params: dict, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps, self.t = params, lr, b1, b2, eps, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self):
        self.t += 1
        for k, p in self.params.items():
            g = p.grad
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            mhat = self.m[k] / (1 - self.b1 ** self.t)
            vhat = self.v[k] / (1 - self.b2 ** self.t)
            p.sub_(self.lr * mhat / (vhat.sqrt() + self.eps))
            p.grad = None
