"""The differentiable raytracing pipeline in eager torch.

The counterpart of `reversible_raytracer_tpu.ops.pipeline`, restricted to
what the port covers: pinhole and orthographic cameras, spheres and rects
with solid or checker materials, nearest hit by a first-wins ``where``
chain, hard shadow rays, and the phong, depth and normal shaders with spp 1
or 4. `shade_from_attrs` also takes a soft occlusion in [0, 1], which the
soft renderer (`pipeline_vec.shade_soft`, ``soft_tau > 0``) feeds it.
Textures, environment maps, mirror reflections and the soft checker
(``checker_tau > 0``) raise `NotImplementedError`.

This is the plain version of the CUDA kernels (`ops.kernels.fused`): on
the CPU it is the renderer, and on the card it is what the kernels are held
against. Its gradients come from torch autograd.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import vecmath as vm
from .vecmath import Vec3

# Sentinel for "no hit". Big but finite: keeps t arithmetic NaN-free.
BIG = 1e10
# Minimum ray parameter for a valid hit (avoids self-intersection re-hits).
T_EPS = 1e-3
# Offset of shadow-ray origins along the surface normal.
SHADOW_EPS = 1e-3


@dataclass(frozen=True)
class RenderConfig:
    """Static render options (the JAX package's RenderConfig, same fields
    and defaults)."""

    height: int
    width: int
    shadows: bool = True
    clip: bool = True
    shader: str = "phong"  # "phong" | "depth" | "normal"
    projection: str = "perspective"  # "perspective" | "orthographic"
    spp: int = 1  # 1 | 4
    soft_tau: float = 0.0
    reflections: int = 0
    checker_tau: float = 0.0

    @property
    def shape(self):
        return (self.height, self.width)


def _require_hard(scene, cfg: RenderConfig) -> None:
    """Raise for what no eager renderer covers. ``soft_tau > 0`` passes: the
    shader that `render_tile` is given decides (`shade` and
    `pipeline_vec.shade_vec` refuse it, `pipeline_vec.shade_soft` needs it)."""
    if cfg.checker_tau > 0.0:
        raise NotImplementedError("checker_tau (soft checker) rendering is not ported yet")
    if cfg.reflections and cfg.shader == "phong":
        raise NotImplementedError("mirror reflections are not ported yet")
    if scene.env_mapped:
        raise NotImplementedError("environment maps are not ported yet")
    if scene.spheres.textured or scene.rects.textured:
        raise NotImplementedError("object textures are not ported yet")


def require_hard_visibility(cfg: RenderConfig) -> None:
    """The hard shaders' refusal of ``soft_tau > 0``, which the soft shader
    (`pipeline_vec.shade_soft`) renders."""
    if cfg.soft_tau > 0.0:
        raise NotImplementedError(
            "soft_tau > 0 renders through pipeline_vec.shade_soft (render_eager_vec)")


# ---------------------------------------------------------------------------
# Camera
# ---------------------------------------------------------------------------


def camera_basis(cam) -> tuple[Vec3, Vec3, Vec3]:
    """Orthonormal (right, up, forward) from eye/look_at/up."""
    eye = vm.splat(cam.eye)
    fwd = vm.vnormalize(vm.vsub(vm.splat(cam.look_at), eye))
    right = vm.vnormalize(vm.vcross(fwd, vm.splat(cam.up)))
    up = vm.vcross(right, fwd)
    return right, up, fwd


def camera_rays(cam, ii, jj, H: int, W: int, projection: str = "perspective"):
    """Per-pixel ray (origin, unit direction) for pixel rows ``ii`` and
    columns ``jj`` (float tensors)."""
    right, up, fwd = camera_basis(cam)
    tanf = torch.tan(cam.fov_deg * (math.pi / 180.0) * 0.5)
    aspect = W / H
    sx = ((jj + 0.5) * (2.0 / W) - 1.0) * tanf * aspect
    sy = (1.0 - (ii + 0.5) * (2.0 / H)) * tanf
    if projection == "orthographic":
        eye = vm.splat(cam.eye)
        dist = vm.vnorm(vm.vsub(vm.splat(cam.look_at), eye))
        o = vm.vadd(eye, vm.vadd(vm.vscale(right, sx * dist), vm.vscale(up, sy * dist)))
        return o, fwd
    d = vm.vnormalize(vm.vadd(fwd, vm.vadd(vm.vscale(right, sx), vm.vscale(up, sy))))
    return vm.splat(cam.eye), d


def primary_rays(scene, cfg: "RenderConfig"):
    """Pixel-center rays (origin, direction) of the whole image, each
    component an (H, W) tensor."""
    H, W = cfg.height, cfg.width
    like = dict(device=scene.device, dtype=scene.ambient.dtype)
    ii = torch.arange(H, **like)[:, None].expand(H, W)
    jj = torch.arange(W, **like)[None, :].expand(H, W)
    o, d = camera_rays(scene.camera, ii, jj, H, W, cfg.projection)
    return vm.vbroadcast(o, (H, W)), vm.vbroadcast(d, (H, W))


# ---------------------------------------------------------------------------
# Intersection
# ---------------------------------------------------------------------------


def intersect_sphere(o: Vec3, d: Vec3, center, radius):
    """Nearest positive ray-sphere t (unit ``d``), BIG on a miss."""
    oc = vm.vsub(o, vm.splat(center))
    b = vm.vdot(oc, d)
    c = vm.vdot(oc, oc) - radius * radius
    disc = b * b - c
    t = -b - vm.safe_sqrt(disc)
    valid = (disc > 0.0) & (t > T_EPS)
    return torch.where(valid, t, BIG)


def intersect_rect(o: Vec3, d: Vec3, origin, edge_u, edge_v):
    """Ray-parallelogram hit: (t, a, b, n) with (a, b) the in-face
    coordinates and n the unnormalized face normal; t = BIG off the patch."""
    p0 = vm.splat(origin)
    eu = vm.splat(edge_u)
    ev = vm.splat(edge_v)
    n = vm.vcross(eu, ev)
    denom = vm.vdot(d, n)
    grazing = torch.abs(denom) > 1e-9
    t = vm.vdot(vm.vsub(p0, o), n) / torch.where(grazing, denom, 1.0)
    rel = vm.vsub(vm.vadd(o, vm.vscale(d, t)), p0)
    a = vm.vdot(rel, eu) * (1.0 / vm.vdot(eu, eu))
    b = vm.vdot(rel, ev) * (1.0 / vm.vdot(ev, ev))
    valid = grazing & (t > T_EPS) & (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0)
    return torch.where(valid, t, BIG), a, b, n


# ---------------------------------------------------------------------------
# Materials and the attributes of a hit
# ---------------------------------------------------------------------------


def _xyz(v) -> Vec3:
    """The last axis of a (..., 3) tensor as a Vec3."""
    return (v[..., 0], v[..., 1], v[..., 2])


def material_rows(mat, pick) -> dict:
    """The material parameters of the objects ``pick`` selects: ``pick`` maps
    a stacked (K, ...) leaf to one object's row (``lambda x: x[k]``) or to
    each pixel's winner's row (a per-pixel gather)."""
    return dict(color=_xyz(pick(mat.color)), color2=_xyz(pick(mat.color2)),
                checker=pick(mat.checker), scale=pick(mat.checker_scale), ka=pick(mat.ka),
                kd=pick(mat.kd), ks=pick(mat.ks), shin=pick(mat.shininess))


def _checker_select(m, parity) -> Vec3:
    """color2 where the checker parity is odd, else color (a step: no
    gradient to positions)."""
    return vm.vwhere(m["checker"] * parity > 0.5, m["color2"], m["color"])


def miss_color(scene, d: Vec3, shape) -> Vec3:
    if scene.env_mapped:
        raise NotImplementedError("environment maps are not ported yet")
    return vm.vbroadcast(vm.splat(scene.background), shape)


def sphere_hit(o: Vec3, d: Vec3, center: Vec3, radius, m, t=None):
    """(t, normal, base colour) of a sphere with material rows ``m``. A
    given ``t`` (a soft layer's rank t, which may be a near miss's closest
    approach) replaces the intersection; the normal (p - c) / r is then not
    a unit vector, as in the JAX package's `_gather_layer`."""
    if t is None:
        t = intersect_sphere(o, d, center, radius)
    p_local = vm.vsub(vm.vadd(o, vm.vscale(d, t)), center)
    n_unit = vm.vscale(p_local, 1.0 / radius)
    s = m["scale"]
    parity = torch.remainder(
        torch.floor(p_local[0] * s) + torch.floor(p_local[1] * s)
        + torch.floor(p_local[2] * s), 2.0,
    )
    return t, n_unit, _checker_select(m, parity)


def rect_hit(o: Vec3, d: Vec3, origin: Vec3, edge_u: Vec3, edge_v: Vec3, m):
    """(t, unit normal facing the ray, base colour) of a rect."""
    t, a, b, n = intersect_rect(o, d, origin, edge_u, edge_v)
    n_unit = vm.vnormalize(n)
    # Two-sided shading: flip the normal toward the incoming ray. The sign
    # takes the scene's dtype: a 0-d normal times a float32 (H, W) sign would
    # round a float64 normal to float32.
    facing = torch.where(vm.vdot(n_unit, d) < 0.0, 1.0, -1.0).to(t.dtype)
    s = m["scale"]
    parity = torch.remainder(torch.floor(a * s) + torch.floor(b * s), 2.0)
    return t, vm.vscale(n_unit, facing), _checker_select(m, parity)


# ---------------------------------------------------------------------------
# Nearest hit: the first-wins where chain (strict <, spheres then rects)
# ---------------------------------------------------------------------------

_ATTRS = ("nx", "ny", "nz", "cr", "cg", "cb", "ka", "kd", "ks", "shin")


def init_attrs(shape, like) -> dict:
    """The attributes of a pixel that hits nothing."""
    best = {k: torch.zeros(shape, **like) for k in _ATTRS}
    best["shin"] = torch.ones(shape, **like)
    return best


def merge_attrs(best: dict, mask, n_unit: Vec3, col: Vec3, m) -> dict:
    """``best`` with the attributes of a hit where ``mask`` holds."""
    new = dict(zip(_ATTRS, (*n_unit, *col, m["ka"], m["kd"], m["ks"], m["shin"])))
    return {key: torch.where(mask, new[key], best[key]) for key in best}


def trace_nearest(scene, o: Vec3, d: Vec3, shape):
    """Closest hit over all spheres, then all rects. Returns (t, hit, attrs)
    with per-pixel unit normal, base color and material scalars."""
    if scene.spheres.textured or scene.rects.textured:
        raise NotImplementedError("object textures are not ported yet")
    like = dict(device=scene.device, dtype=scene.ambient.dtype)
    t_best = torch.full(shape, BIG, **like)
    best = init_attrs(shape, like)
    sp, rc = scene.spheres, scene.rects
    for k in range(sp.count):
        m = material_rows(sp.material, lambda x: x[k])
        t, n_unit, col = sphere_hit(o, d, _xyz(sp.center[k]), sp.radius[k], m)
        closer = t < t_best
        t_best = torch.where(closer, t, t_best)
        best = merge_attrs(best, closer, n_unit, col, m)
    for k in range(rc.count):
        m = material_rows(rc.material, lambda x: x[k])
        t, n_unit, col = rect_hit(o, d, _xyz(rc.origin[k]), _xyz(rc.edge_u[k]),
                                  _xyz(rc.edge_v[k]), m)
        closer = t < t_best
        t_best = torch.where(closer, t, t_best)
        best = merge_attrs(best, closer, n_unit, col, m)
    return t_best, t_best < BIG * 0.5, best


def occluded(scene, o: Vec3, ldir: Vec3, dist):
    """Binary any-hit test toward a light (a step: no gradient)."""
    occ = torch.zeros_like(dist, dtype=torch.bool)
    sp = scene.spheres
    for k in range(sp.count):
        occ = occ | (intersect_sphere(o, ldir, sp.center[k], sp.radius[k]) < dist)
    rc = scene.rects
    for k in range(rc.count):
        t, _, _, _ = intersect_rect(o, ldir, rc.origin[k], rc.edge_u[k], rc.edge_v[k])
        occ = occ | (t < dist)
    return occ


# ---------------------------------------------------------------------------
# Shading
# ---------------------------------------------------------------------------


def shadow_origin(o: Vec3, d: Vec3, t, n) -> Vec3:
    """Hit point offset along the normal."""
    return vm.vadd(vm.vadd(o, vm.vscale(d, t)), vm.vscale(n, SHADOW_EPS))


def light_geometry(lights, li: int, shadow_o: Vec3):
    """(ldir, dist) from the shadow origin to light ``li``."""
    lvec = vm.vsub(vm.splat(lights.position[li]), shadow_o)
    dist = vm.safe_sqrt(vm.vdot(lvec, lvec))
    ldir = vm.vscale(lvec, 1.0 / torch.where(dist > 1e-9, dist, 1.0))
    return ldir, dist


def shade_from_attrs(scene, o: Vec3, d: Vec3, cfg: RenderConfig, shape,
                     t, hit, at, return_vis: bool = False, occluded_fn=occluded):
    """Shade nearest-hit results: ambient + per light (shadow, Lambertian +
    Phong), background on a miss, optional [0, 1] clip.
    ``occluded_fn(scene, o, ldir, dist)`` is the shadow test: a boolean
    any-hit (hard, no gradient) or a float occlusion in [0, 1] (soft), whose
    visibility 1 - occ carries gradient to the occluders."""
    if cfg.shader == "depth":
        z = torch.where(hit, 1.0 / (1.0 + t), 0.0)
        return ((z, z, z), ()) if return_vis else (z, z, z)
    if cfg.shader == "normal":
        col = tuple(torch.where(hit, at[k] * 0.5 + 0.5, 0.0) for k in ("nx", "ny", "nz"))
        return (col, ()) if return_vis else col

    n = (at["nx"], at["ny"], at["nz"])
    base = (at["cr"], at["cg"], at["cb"])
    col = vm.vscale(vm.vmul(base, vm.splat(scene.ambient)), at["ka"])
    view = vm.vneg(d)
    lights = scene.lights
    vis_out = []
    shadow_o = shadow_origin(o, d, t, n)
    for li in range(lights.count):
        lcol = vm.splat(lights.color[li])
        ldir, dist = light_geometry(lights, li, shadow_o)
        if cfg.shadows:
            occ = occluded_fn(scene, shadow_o, ldir, dist)
            vis = torch.where(occ, 0.0, 1.0) if occ.dtype == torch.bool else 1.0 - occ
        else:
            vis = torch.ones(shape, device=scene.device, dtype=scene.ambient.dtype)
        vis_out.append(vis)
        ndotl = vm.vmax0(vm.vdot(n, ldir))
        refl = vm.vsub(vm.vscale(n, 2.0 * ndotl), ldir)
        rdotv = vm.vmax0(vm.vdot(refl, view))
        spec = at["ks"] * vm.safe_pow(rdotv, at["shin"])
        col = vm.vadd(col, tuple(vis * (at["kd"] * ndotl * base[c] + spec) * lcol[c]
                                 for c in range(3)))

    col = vm.vwhere(hit, col, miss_color(scene, d, shape))
    if cfg.clip:
        col = tuple(vm.clip01(c) for c in col)
    if return_vis:
        return col, tuple(vis_out)
    return col


def shade(scene, o: Vec3, d: Vec3, cfg: RenderConfig, shape, return_vis: bool = False):
    """Trace + shade with no mirror bounces."""
    require_hard_visibility(cfg)
    if cfg.reflections and cfg.shader == "phong":
        raise NotImplementedError("mirror reflections are not ported yet")
    t, hit, at = trace_nearest(scene, o, d, shape)
    return shade_from_attrs(scene, o, d, cfg, shape, t, hit, at, return_vis=return_vis)


def n_vis_planes(scene_like, cfg: RenderConfig) -> int:
    """Shadow-visibility planes `render_tile` emits with ``return_vis``: one
    per (subsample, bounce, light), subsample-major then bounce-major."""
    if not (cfg.shadows and cfg.shader == "phong"):
        return 0
    return scene_like.lights.count * cfg.spp * (1 + cfg.reflections)


SPP_OFFSETS = {1: [(0.0, 0.0)],
               4: [(-0.25, -0.25), (-0.25, 0.25), (0.25, -0.25), (0.25, 0.25)]}


def render_tile(scene, cfg: RenderConfig, row0, col0, bh: int, bw: int,
                return_vis: bool = False, shade_fn=shade):
    """Render the (bh, bw) tile whose top-left pixel is (row0, col0).
    Returns SoA (r, g, b), plus the visibility planes with ``return_vis``.
    ``shade_fn`` traces and shades one subsample's rays: `shade` (the
    where chain) or `pipeline_vec.shade_vec` (objects on a leading axis)."""
    _require_hard(scene, cfg)
    if cfg.spp not in SPP_OFFSETS:
        raise ValueError(f"spp must be 1 or 4, got {cfg.spp}")
    like = dict(device=scene.device, dtype=scene.ambient.dtype)
    ii = torch.arange(bh, **like)[:, None] + row0
    jj = torch.arange(bw, **like)[None, :] + col0
    ii, jj = torch.broadcast_to(ii, (bh, bw)), torch.broadcast_to(jj, (bh, bw))
    offsets = SPP_OFFSETS[cfg.spp]
    acc = None
    vis_all = []
    for oi, oj in offsets:
        o, d = camera_rays(scene.camera, ii + oi, jj + oj, cfg.height, cfg.width,
                           cfg.projection)
        o = vm.vbroadcast(o, (bh, bw))
        d = vm.vbroadcast(d, (bh, bw))
        out = shade_fn(scene, o, d, cfg, (bh, bw), return_vis=return_vis)
        col, vis = out if return_vis else (out, ())
        acc = col if acc is None else vm.vadd(acc, col)
        vis_all.extend(vis)
    col = vm.vscale(acc, 1.0 / len(offsets))
    if return_vis:
        return col, tuple(vis_all)
    return col
