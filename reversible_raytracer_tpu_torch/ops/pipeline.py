"""The differentiable raytracing pipeline in eager torch.

The counterpart of `reversible_raytracer_tpu.ops.pipeline`, restricted to
what the port covers: pinhole and orthographic cameras, spheres and rects
with solid or checker materials, nearest hit by a first-wins ``where``
chain, hard shadow rays, and the phong, depth and normal shaders with spp 1
or 4. `shade_from_attrs` also takes a soft occlusion in [0, 1], which the
soft renderer (`pipeline_vec.shade_soft`, ``soft_tau > 0``) feeds it.
`sphere_hit` and `rect_hit` also take the soft checker (``checker_tau >
0``, `soft_checker_q`), which only the object-vectorized renderer
(`pipeline_vec`) passes them: the where chain (`shade`) refuses it, as the
JAX package's hard family does. Mirror reflections (``cfg.reflections``
bounces, each object's ``mirror`` coefficient) follow the JAX package's
reflective `shade`: each level shaded unclipped, the reflected colour
blended in deepest level first, one clip at the top; they take hard
semantics only (``soft_tau`` and ``checker_tau`` 0). Object textures and
the environment map (JAX pipeline.py:258-316, :392-459) are sampled by the
4-corner bilinear gather (`sample_texture`) at a rect's (a, b) or at the
lat-long coordinates of a sphere's normal or a missed ray's direction
(`sphere_uv`, through the JAX package's polynomial `atan2`/`asin`); the
where chain (`shade`) and both object-vectorized shaders take both.

This is the plain version of the CUDA kernels (`ops.kernels.fused`): on
the CPU it is the renderer, and on the card it is what the kernels are held
against. Its gradients come from torch autograd.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from types import SimpleNamespace

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

    @property
    def row0(self) -> int:
        """The image row of the first row rendered: 0 (a `BandConfig`'s own)."""
        return 0

    @property
    def image_height(self) -> int:
        """The height of the image the camera sees: ``height`` (a
        `BandConfig` renders ``height`` rows of a taller image)."""
        return self.height


@dataclass(frozen=True)
class BandConfig(RenderConfig):
    """A row band of an image: ``height`` whole rows from image row ``row0``
    of an image ``image_height`` rows high (the JAX package's ``row0`` and
    ``out_height``). Every image, visibility plane, target and cotangent of
    a band is the band's (``shape``); the camera still sees the whole image,
    so a pixel of the band is the same pixel of the whole image and its ray
    the same ray to the bit. Made by `band_config`."""

    row0: int = 0
    image_height: int = 0


def band_config(cfg: RenderConfig, row0=0, out_height: int | None = None) -> RenderConfig:
    """``cfg`` restricted to ``out_height`` rows (None: the rest of the
    image) from image row ``row0`` (an int, or a float of integer value as
    the JAX package passes it): ``cfg`` itself for the whole image or where
    no band is asked (``row0`` 0, ``out_height`` None; so a `BandConfig`
    passes through), else a `BandConfig`. A band of a band is refused."""
    if row0 == 0 and out_height is None:
        return cfg
    H = cfg.image_height
    r0 = int(row0)
    if r0 != row0:
        raise ValueError(f"row0 must be a whole row, got {row0!r}")
    rows = H - r0 if out_height is None else int(out_height)
    if r0 == cfg.row0 and rows == cfg.height:
        return cfg
    if cfg.height != H:
        raise ValueError("a band of a band is not taken: pass the whole image's configuration")
    if rows < 1 or r0 < 0 or r0 + rows > H:
        raise ValueError(f"the band of {rows} rows from row {r0} does not fit an image of "
                         f"{H} rows")
    fields = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    return BandConfig(**{**fields, "height": rows}, row0=r0, image_height=H)


def _require_hard(scene, cfg: RenderConfig, where_chain: bool = True) -> None:
    """Raise for what the eager renderer does not cover. ``soft_tau > 0``
    passes: the shader that `render_tile` is given decides (`shade` and
    `pipeline_vec.shade_vec` refuse it, `pipeline_vec.shade_soft` needs it).
    ``checker_tau > 0`` passes only for the object-vectorized shaders, which
    take the soft checker; the where chain (``where_chain``) refuses it (the
    JAX package's pipeline.py:99-101). Object textures and the environment
    map pass for every shader."""
    if cfg.reflections and (cfg.soft_tau > 0.0 or cfg.checker_tau > 0.0):
        raise NotImplementedError(
            "mirror reflections require hard semantics (reflections=0 when soft_tau/checker_tau "
            "> 0; anneal to hard, then polish with reflections on)")
    if cfg.checker_tau > 0.0 and where_chain:
        raise NotImplementedError(
            "checker_tau > 0 (the soft checker) renders through pipeline_vec (render_eager_vec)")


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


def primary_rays(scene, cfg: "RenderConfig", off=(0.0, 0.0)):
    """The rays (origin, direction) of the image (of a `BandConfig`'s band)
    at the subsample offset ``off`` (rows, columns; `SPP_OFFSETS`) from the
    pixel centres, each component an (H, W) tensor."""
    H, W = cfg.height, cfg.width
    like = dict(device=scene.device, dtype=scene.ambient.dtype)
    ii = (torch.arange(H, **like) + cfg.row0)[:, None].expand(H, W) + off[0]
    jj = torch.arange(W, **like)[None, :].expand(H, W) + off[1]
    o, d = camera_rays(scene.camera, ii, jj, cfg.image_height, W, cfg.projection)
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
                kd=pick(mat.kd), ks=pick(mat.ks), shin=pick(mat.shininess),
                mir=pick(mat.mirror))


def _checker_select(m, parity) -> Vec3:
    """color2 where the checker parity is odd, else color (a step: no
    gradient to positions)."""
    return vm.vwhere(m["checker"] * parity > 0.5, m["color2"], m["color"])


def soft_checker_q(parts, tau):
    """The smooth parity sign q in [-1, 1] of the soft checker (JAX
    pipeline.py:229-254): per axis tri(x) = 2 |mod(x - 0.5, 2) - 1| - 1, the
    wave that is (-1)^floor(x) at cell centres and 0 at integers, squashed
    to tri / (|tri| + tau + 1e-6), and q the product over the axes; sign(q)
    is the hard parity as tau -> 0. The 1e-6 guard keeps q and its gradient
    finite where tri is 0 even at tau = 0. ``torch.remainder`` is floored,
    as ``jnp.mod`` is (and as the kernels' `mod2`)."""
    q = 1.0
    for p in parts:
        tri = 2.0 * torch.abs(torch.remainder(p - 0.5, 2.0) - 1.0) - 1.0
        q = q * (tri / (torch.abs(tri) + tau + 1e-6))
    return q


def _checker_base(m, parts, checker_tau) -> Vec3:
    """The base colour of a hit at checker coordinates ``parts`` (the hit's
    local position times the checker scale): the hard select at
    ``checker_tau == 0``; above it the blend color + u (color2 - color), u =
    checker (0.5 - 0.5 q), which carries gradient to the hit position."""
    if checker_tau > 0.0:
        u = m["checker"] * (0.5 - 0.5 * soft_checker_q(parts, checker_tau))
        return tuple(c1 + u * (c2 - c1) for c1, c2 in zip(m["color"], m["color2"]))
    parity = torch.remainder(sum(torch.floor(p) for p in parts), 2.0)
    return _checker_select(m, parity)


def texture_weights(a, b, ka: int, kb: int, wrap_a: bool = False):
    """Bilinear corner indices and weights of uv (a, b) over a (ka, kb) grid
    (JAX pipeline.py:258-286): (i0, i1, j0, j1, fi, fj). The b axis clamps
    at its edges; the a axis clamps too, or with ``wrap_a`` wraps (the
    lat-long azimuth seam: i1 is 0 where i0 is ka - 1). The clamps' ties
    split the gradient as ``jnp.clip``'s do; the indices carry none."""
    u = a * ka - 0.5
    v = b * kb - 0.5
    if wrap_a:
        i0f = torch.floor(u)
        fi = u - i0f
        i0 = torch.remainder(i0f.long(), ka)
        i1 = torch.remainder(i0 + 1, ka)
    else:
        i0f = torch.clamp(torch.floor(u), 0.0, ka - 1)
        fi = vm.clip01(u - i0f)
        i0 = i0f.long()
        i1 = torch.clamp_max(i0 + 1, ka - 1)
    j0f = torch.clamp(torch.floor(v), 0.0, kb - 1)
    fj = vm.clip01(v - j0f)
    j0 = j0f.long()
    j1 = torch.clamp_max(j0 + 1, kb - 1)
    return i0, i1, j0, j1, fi, fj


def sample_grid(grids, k, a, b, wrap_a: bool = False):
    """Bilinear sample of grid ``k`` (an index, or one per pixel) of the
    stacked (n, ka, kb, 3) texel ``grids`` at uv (a, b), a indexing the first
    axis (`texture_weights`): the 4-corner gather of JAX pipeline.py:289-316,
    per channel (1 - fi) ((1 - fj) t00 + fj t01) + fi ((1 - fj) t10 + fj t11).
    Its gradient reaches the four texels and, through the weights, the
    coordinates. Returns the colour (``col``) with what the kernels' adjoint
    twin reads (`kernels.fused.grid_adjoint`): the corners' rows of the
    flattened grids (``idx``: (i0, j0), (i0, j1), (i1, j0), (i1, j1)), their
    texels (``t``), the weights ``fi``, ``fj`` and their derivatives in a and
    b (``dfi``, ``dfj``; a clamp's ties split as ``jnp.clip``'s)."""
    ka, kb = grids.shape[1], grids.shape[2]
    i0, i1, j0, j1, fi, fj = texture_weights(a, b, ka, kb, wrap_a)
    rows = grids.reshape(-1, 3)
    base = k * (ka * kb)
    idx = tuple(base + i * kb + j for i, j in ((i0, j0), (i0, j1), (i1, j0), (i1, j1)))
    t = tuple(rows[ix] for ix in idx)
    col = tuple((1.0 - fi) * ((1.0 - fj) * t[0][..., c] + fj * t[1][..., c])
                + fi * ((1.0 - fj) * t[2][..., c] + fj * t[3][..., c]) for c in range(3))
    dfi = ka if wrap_a else ka * vm.clip01_grad(a * ka - 0.5 - i0.to(a.dtype))
    dfj = kb * vm.clip01_grad(b * kb - 0.5 - j0.to(b.dtype))
    return SimpleNamespace(col=col, idx=idx, t=t, fi=fi, fj=fj, dfi=dfi, dfj=dfj)


def sample_texture(tex, a, b, wrap_a: bool = False) -> Vec3:
    """`sample_grid` of one (ka, kb, 3) texel grid: its colour."""
    return sample_grid(tex[None], 0, a, b, wrap_a).col


def sphere_uv(n_unit: Vec3):
    """Lat-long coordinates of a unit direction, y up (JAX pipeline.py:392):
    u = atan2(z, x) / (2 pi) + 0.5 (the azimuth, wrapping at the seam), v =
    0.5 - asin(clip(y, -1 + 1e-6, 1 - 1e-6)) / pi (0 at +y), through the
    polynomial `vecmath.atan2`/`asin` and with their guards, so that no ray
    puts NaN into a gradient."""
    nx, ny, nz = n_unit
    u = vm.atan2(nz, nx) * (0.5 / math.pi) + 0.5
    v = 0.5 - vm.asin(vm.clip(ny, -1.0 + 1e-6, 1.0 - 1e-6)) / math.pi
    return u, v


def miss_color(scene, d: Vec3, shape) -> Vec3:
    """What a ray that hits nothing sees: the environment map's sample at
    `sphere_uv` of its (unit) direction, azimuth wrapped, where the scene has
    one; else the flat background."""
    if scene.env_mapped:
        u, v = sphere_uv(d)
        return vm.vbroadcast(sample_texture(scene.env, u, v, wrap_a=True), shape)
    return vm.vbroadcast(vm.splat(scene.background), shape)


def sphere_hit(o: Vec3, d: Vec3, center: Vec3, radius, m, t=None, checker_tau=0.0, tex=None):
    """(t, normal, base colour) of a sphere with material rows ``m``. A
    given ``t`` (a soft layer's rank t, which may be a near miss's closest
    approach) replaces the intersection; the normal (p - c) / r is then not
    a unit vector, as in the JAX package's `_gather_layer`. The checker is
    the hard select, or at ``checker_tau > 0`` the soft blend
    (`_checker_base`); a texel grid ``tex`` replaces it, sampled at
    `sphere_uv` of the normal with the azimuth wrapped."""
    if t is None:
        t = intersect_sphere(o, d, center, radius)
    p_local = vm.vsub(vm.vadd(o, vm.vscale(d, t)), center)
    n_unit = vm.vscale(p_local, 1.0 / radius)
    if tex is not None:
        u, v = sphere_uv(n_unit)
        return t, n_unit, sample_texture(tex, u, v, wrap_a=True)
    s = m["scale"]
    return t, n_unit, _checker_base(m, tuple(x * s for x in p_local), checker_tau)


def rect_hit(o: Vec3, d: Vec3, origin: Vec3, edge_u: Vec3, edge_v: Vec3, m, checker_tau=0.0,
             tex=None):
    """(t, unit normal facing the ray, base colour) of a rect; the checker
    as `sphere_hit`'s, at the in-face coordinates (a, b), or the texel grid
    ``tex`` sampled there."""
    t, a, b, n = intersect_rect(o, d, origin, edge_u, edge_v)
    n_unit = vm.vnormalize(n)
    # Two-sided shading: flip the normal toward the incoming ray. The sign
    # takes the scene's dtype: a 0-d normal times a float32 (H, W) sign would
    # round a float64 normal to float32.
    facing = torch.where(vm.vdot(n_unit, d) < 0.0, 1.0, -1.0).to(t.dtype)
    if tex is not None:
        return t, vm.vscale(n_unit, facing), sample_texture(tex, a, b)
    s = m["scale"]
    return t, vm.vscale(n_unit, facing), _checker_base(m, (a * s, b * s), checker_tau)


# ---------------------------------------------------------------------------
# Nearest hit: the first-wins where chain (strict <, spheres then rects)
# ---------------------------------------------------------------------------

_ATTRS = ("nx", "ny", "nz", "cr", "cg", "cb", "ka", "kd", "ks", "shin")


def init_attrs(shape, like, with_mirror: bool = False) -> dict:
    """The attributes of a pixel that hits nothing; ``with_mirror`` adds the
    mirror coefficient ("mir", 0), which only a level that blends in a
    reflection reads."""
    best = {k: torch.zeros(shape, **like) for k in _ATTRS}
    best["shin"] = torch.ones(shape, **like)
    if with_mirror:
        best["mir"] = torch.zeros(shape, **like)
    return best


def merge_attrs(best: dict, mask, n_unit: Vec3, col: Vec3, m) -> dict:
    """``best`` with the attributes of a hit where ``mask`` holds."""
    new = dict(zip(_ATTRS, (*n_unit, *col, m["ka"], m["kd"], m["ks"], m["shin"])), mir=m["mir"])
    return {key: torch.where(mask, new[key], best[key]) for key in best}


def trace_nearest(scene, o: Vec3, d: Vec3, shape, with_mirror: bool = False):
    """Closest hit over all spheres, then all rects. Returns (t, hit, attrs)
    with per-pixel unit normal, base color and material scalars, and with
    ``with_mirror`` the mirror coefficient ("mir"). A textured group's base
    colour is its texture's sample (`sphere_hit`, `rect_hit`)."""
    like = dict(device=scene.device, dtype=scene.ambient.dtype)
    t_best = torch.full(shape, BIG, **like)
    best = init_attrs(shape, like, with_mirror)
    sp, rc = scene.spheres, scene.rects
    for k in range(sp.count):
        m = material_rows(sp.material, lambda x: x[k])
        t, n_unit, col = sphere_hit(o, d, _xyz(sp.center[k]), sp.radius[k], m,
                                    tex=sp.texture[k] if sp.textured else None)
        closer = t < t_best
        t_best = torch.where(closer, t, t_best)
        best = merge_attrs(best, closer, n_unit, col, m)
    for k in range(rc.count):
        m = material_rows(rc.material, lambda x: x[k])
        t, n_unit, col = rect_hit(o, d, _xyz(rc.origin[k]), _xyz(rc.edge_u[k]),
                                  _xyz(rc.edge_v[k]), m,
                                  tex=rc.texture[k] if rc.textured else None)
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


def reflect_dir(d: Vec3, n: Vec3) -> Vec3:
    """Specular reflection of (unit) ``d`` about (unit) ``n``: d - 2 (d . n) n,
    the JAX package's primitive sequence (and the kernels')."""
    return vm.vsub(d, vm.vscale(n, 2.0 * vm.vdot(d, n)))


def shade_levels(scene, o: Vec3, d: Vec3, cfg: RenderConfig, shape, trace_fn,
                 return_vis: bool = False, occluded_fn=occluded):
    """Trace + shade plus ``cfg.reflections`` mirror bounces (the phong
    shader only), through ``trace_fn(scene, o, d, shape, with_mirror) ->
    (t, hit, attrs)``. Each level's colour is unclipped; a level that blends
    (every one above the deepest) traces the reflected ray from its shadow
    origin along `reflect_dir`, and composes col + m (rcol - col) with m =
    where(hit, mirror, 0), deepest level first; one clip at the top. The
    visibility planes go level by level (level 0's L lights first)."""
    bounces = cfg.reflections if cfg.shader == "phong" else 0
    if bounces == 0:
        t, hit, at = trace_fn(scene, o, d, shape, False)
        return shade_from_attrs(scene, o, d, cfg, shape, t, hit, at, return_vis=return_vis,
                                occluded_fn=occluded_fn)
    cfg_level = dataclasses.replace(cfg, clip=False)
    vis_out = []

    def level(o_l, d_l, depth):
        t, hit, at = trace_fn(scene, o_l, d_l, shape, depth < bounces)
        out = shade_from_attrs(scene, o_l, d_l, cfg_level, shape, t, hit, at,
                               return_vis=return_vis, occluded_fn=occluded_fn)
        col, vis = out if return_vis else (out, ())
        vis_out.extend(vis)
        if depth < bounces:
            n = (at["nx"], at["ny"], at["nz"])
            rcol = level(shadow_origin(o_l, d_l, t, n), reflect_dir(d_l, n), depth + 1)
            m = torch.where(hit, at["mir"], 0.0)
            col = tuple(c + m * (rc - c) for c, rc in zip(col, rcol))
        return col

    col = level(o, d, 0)
    if cfg.clip:
        col = tuple(vm.clip01(c) for c in col)
    return (col, tuple(vis_out)) if return_vis else col


def shade(scene, o: Vec3, d: Vec3, cfg: RenderConfig, shape, return_vis: bool = False):
    """Trace (the where chain) + shade, with ``cfg.reflections`` mirror
    bounces (`shade_levels`)."""
    require_hard_visibility(cfg)
    return shade_levels(scene, o, d, cfg, shape, trace_nearest, return_vis=return_vis)


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
    """Render the (bh, bw) tile whose top-left pixel is (row0, col0) of the
    image the camera sees (``cfg.image_height`` rows; a `BandConfig`'s
    caller passes its ``row0``). Returns SoA (r, g, b), plus the visibility
    planes with ``return_vis``.
    ``shade_fn`` traces and shades one subsample's rays: `shade` (the
    where chain) or `pipeline_vec.shade_vec` (objects on a leading axis)."""
    _require_hard(scene, cfg, where_chain=shade_fn is shade)
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
        o, d = camera_rays(scene.camera, ii + oi, jj + oj, cfg.image_height, cfg.width,
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
