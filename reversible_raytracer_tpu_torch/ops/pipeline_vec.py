"""Object-vectorized renderer in eager torch, hard and soft.

The counterpart of `reversible_raytracer_tpu.ops.pipeline_vec`. Hard: the
objects of a scene lie on a
leading axis (`t_all: (N + M, H, W)`), the nearest hit is an argmin over
that axis with first-wins ties (spheres first, then rects), and the shadow
test is an any-hit over it. Only the winning object's intersection and
attributes are then evaluated per pixel, so the gradient reaches the winner
alone, as it does through the JAX package's ``take_along_axis``.

The arithmetic of every pixel is that of `pipeline.shade` (same operations
in the same order), so on any scene `render_eager_vec` gives the bits of
`render.render_eager`. It is the plain version of the object-chunked CUDA
kernels (`kernels.fused_vec`), and through autograd the plain version of
their training step.

Soft (``soft_tau > 0``, `shade_soft`): the JAX package's `_render_soft`.
Spheres rank by a soft t (the hit t, or a near miss's closest approach
where its sigmoid coverage exceeds 1e-3), the two nearest layers are
shaded with a soft shadow product and alpha-composited over the
background. The ranking has no gradient; the two layers' winners, their
coverage and the shadow products do. This is the plain version of the
soft kernels (`kernels.fused_vec_soft`).

Both take the soft checker (``checker_tau > 0``, the JAX package's
`_gather_layer` branch): each winner's base colour blends color and color2
by the smooth parity `pipeline.soft_checker_q` of its hit position, which
gives the hit positions, and through them the camera, a gradient. With
``checker_tau == 0`` the checker is the hard select, bit for bit. The hard
shader takes mirror reflections (``cfg.reflections`` levels, as
`pipeline.shade_levels` composes them, with the winner's mirror coefficient
gathered per level: the JAX package's `_render_hard_once` levels); the soft
one and the soft checker refuse them, as the JAX package's `render_jnp_vec`
does. Both take the environment map (a missed ray's colour at either hard
level is its sample, `pipeline.miss_color`; the soft composite's blend target
is the sample of the primary ray at every pixel) and object texel grids (the
JAX package's `_gather_layer` texture branches: each winner's grid sampled
at the lat-long coordinates of its normal, the azimuth wrapped, or at a
rect's (a, b), by the 4-corner gather `pipeline.sample_grid` over every
pixel's winner, as the where chain samples one grid: `render_eager`'s bits).
Each soft layer samples its own winner's grid; a sphere layer's normal (p -
c) / r at its rank t is not renormalised at a near miss, so `sphere_uv`'s
clamp of its y is part of the result, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from . import vecmath as vm
from .pipeline import (
    BIG,
    T_EPS,
    RenderConfig,
    _xyz,
    band_config,
    init_attrs,
    intersect_rect,
    intersect_sphere,
    material_rows,
    merge_attrs,
    miss_color,
    rect_hit,
    render_tile,
    require_hard_visibility,
    sample_grid,
    shade_from_attrs,
    shade_levels,
    sphere_hit,
    sphere_uv,
)

# pipeline_vec.py:101 SPP4_OFFSETS and :104 spp_average are
# `pipeline.SPP_OFFSETS` and the subsample loop of `pipeline.render_tile`:
# the same offsets, each subsample clipped before the average.


def _lead(o: tuple) -> tuple:
    """A Vec3 of (H, W) pixel tensors -> (1, H, W), against the object axis."""
    return tuple(x[None] for x in o)


def sphere_ts(spheres, o, d):
    """t of every sphere for every ray: (N, H, W), BIG on a miss."""
    return intersect_sphere(_lead(o), _lead(d), _xyz(spheres.center[:, None, None]),
                            spheres.radius[:, None, None])


def rect_ts(rects, o, d):
    """t of every rect for every ray: (M, H, W), BIG off the patch."""
    t, _, _, _ = intersect_rect(_lead(o), _lead(d), _xyz(rects.origin[:, None, None]),
                                _xyz(rects.edge_u[:, None, None]),
                                _xyz(rects.edge_v[:, None, None]))
    return t


def occluded_any(scene, o, ldir, dist, keep=None):
    """Any-hit shadow test over all objects at once (a step: no gradient).
    ``keep`` (N, H, W) bool, if given, limits each ray's spheres to those it
    marks (the kernels' culled walk)."""
    with torch.no_grad():
        occ = torch.zeros_like(dist, dtype=torch.bool)
        if scene.spheres.count:
            hits = sphere_ts(scene.spheres, o, ldir) < dist
            occ = occ | (hits if keep is None else hits & keep).any(dim=0)
        if scene.rects.count:
            occ = occ | (rect_ts(scene.rects, o, ldir) < dist).any(dim=0)
    return occ


def nearest_vec(scene, o, d, keep=None):
    """(t, k) of every ray's nearest hit: spheres are 0..N-1 and rects
    N..N+M-1 in k, a miss is k = -1 with t = BIG. Argmin over the stacked t
    with first-wins ties (strict <, as the where chain); no gradient.
    ``keep`` (N, H, W) bool, if given, limits each ray's spheres to those it
    marks (the kernels' culled walk)."""
    with torch.no_grad():
        parts = []
        if scene.spheres.count:
            ts = sphere_ts(scene.spheres, o, d)
            parts.append(ts if keep is None else torch.where(keep, ts, BIG))
        if scene.rects.count:
            parts.append(rect_ts(scene.rects, o, d))
        t_all = torch.cat(parts)
        k = torch.argmin(t_all, dim=0)
        t = torch.gather(t_all, 0, k[None])[0]
        return t, torch.where(t < BIG * 0.5, k, -1)


def _take(rows, idx):
    """``rows[idx]`` for per-pixel indices, through index_select (whose
    backward is one index_add, much faster on the card than the sort that
    advanced indexing's backward runs)."""
    out = torch.index_select(rows, 0, idx.reshape(-1))
    return out.reshape(*idx.shape, *rows.shape[1:])


def trace_nearest_vec(scene, o, d, shape, checker_tau=0.0, with_mirror=False):
    """`pipeline.trace_nearest` with the objects on a leading axis: (t, hit,
    attrs), where only the winner's intersection and attributes are
    evaluated (with gradient) per pixel; the checker soft at
    ``checker_tau > 0``; with ``with_mirror`` the winner's mirror
    coefficient ("mir") too. A textured group's base colour is its winner's
    grid sampled at the hit (`pipeline.sample_grid`), in place of the
    checker, as the JAX package's `_gather_layer` overrides it."""
    like = dict(device=scene.device, dtype=scene.ambient.dtype)
    sp, rc = scene.spheres, scene.rects
    N, M = sp.count, rc.count
    _, k = nearest_vec(scene, o, d)
    t = torch.full(shape, BIG, **like)
    best = init_attrs(shape, like, with_mirror)
    if N:
        ks = k.clamp(0, N - 1)
        pick = lambda x: _take(x, ks)
        m = material_rows(sp.material, pick)
        t_s, n_unit, col = sphere_hit(o, d, _xyz(pick(sp.center)), pick(sp.radius), m,
                                      checker_tau=checker_tau)
        if sp.textured:
            col = sample_grid(sp.texture, ks, *sphere_uv(n_unit), wrap_a=True).col
        is_sph = (k >= 0) & (k < N)
        t = torch.where(is_sph, t_s, t)
        best = merge_attrs(best, is_sph, n_unit, col, m)
    if M:
        kr = (k - N).clamp(0, M - 1)
        pick = lambda x: _take(x, kr)
        m = material_rows(rc.material, pick)
        p0, eu, ev = _xyz(pick(rc.origin)), _xyz(pick(rc.edge_u)), _xyz(pick(rc.edge_v))
        t_r, n_unit, col = rect_hit(o, d, p0, eu, ev, m, checker_tau=checker_tau)
        if rc.textured:
            _, a, b, _ = intersect_rect(o, d, p0, eu, ev)
            col = sample_grid(rc.texture, kr, a, b).col
        t = torch.where(k >= N, t_r, t)
        best = merge_attrs(best, k >= N, n_unit, col, m)
    return t, t < BIG * 0.5, best


def shade_vec(scene, o, d, cfg: RenderConfig, shape, return_vis: bool = False):
    """`pipeline.shade` through the object-vectorized trace and any-hit,
    with its mirror bounces (`pipeline.shade_levels`) and, where the scene
    has one, the environment map at every level's misses."""
    require_hard_visibility(cfg)
    trace = lambda sc, o_l, d_l, sh, mir: trace_nearest_vec(sc, o_l, d_l, sh, cfg.checker_tau,
                                                            mir)
    return shade_levels(scene, o, d, cfg, shape, trace, return_vis=return_vis,
                        occluded_fn=occluded_any)


# ---------------------------------------------------------------------------
# Soft visibility (soft_tau > 0): pipeline_vec.py:387-532 of the JAX package
# ---------------------------------------------------------------------------


def sphere_soft(center, radius, o, d, tau):
    """(t_rank, alpha) of spheres for rays, elementwise (`_sphere_soft`):
    alpha = sigmoid(disc / (tau r^2)) for rays that hit or point at the
    sphere; t_rank is the hit t, the closest-approach t -b of a near miss
    whose alpha exceeds 1e-3, else BIG."""
    oc = vm.vsub(o, center)
    b = vm.vdot(oc, d)
    cc = vm.vdot(oc, oc) - radius * radius
    disc = b * b - cc
    t = -b - vm.safe_sqrt(disc)
    hit = (disc > 0.0) & (t > T_EPS)
    ahead = hit | (-b > T_EPS)
    alpha = torch.where(ahead, torch.sigmoid(disc / (tau * radius * radius)), 0.0)
    near = alpha > 1e-3
    t_rank = torch.where(hit, t, torch.where(near & (-b > T_EPS), -b, BIG))
    return t_rank, alpha


def sphere_shadow_alpha(center, radius, so, ld, dist, tau):
    """Soft coverage of a shadow ray by spheres, elementwise (the sphere
    branch of `_occluded_soft`): the sigmoid where the sphere is hit, or
    passed closest, between the surface and the light."""
    oc = vm.vsub(so, center)
    b = vm.vdot(oc, ld)
    cc = vm.vdot(oc, oc) - radius * radius
    disc = b * b - cc
    t = -b - vm.safe_sqrt(disc)
    between = (((disc > 0.0) & (t > T_EPS) & (t < dist))
               | ((-b > T_EPS) & (-b < dist)))
    return torch.where(between, torch.sigmoid(disc / (tau * radius * radius)), 0.0)


def sphere_axis(spheres):
    """Sphere centers and radii shaped (N, 1, 1) against (1, H, W) rays."""
    return _xyz(spheres.center[:, None, None]), spheres.radius[:, None, None]


def occluded_soft(scene, so, ld, dist, tau):
    """Soft occlusion 1 - prod_k (1 - alpha_k) over the sphere occluders
    (soft, with gradient) and the rect occluders (hard 0/1 factors)."""
    factors = []
    if scene.spheres.count:
        c, r = sphere_axis(scene.spheres)
        factors.append(1.0 - sphere_shadow_alpha(c, r, _lead(so), _lead(ld), dist[None], tau))
    if scene.rects.count:
        with torch.no_grad():
            factors.append(torch.where(rect_ts(scene.rects, so, ld) < dist, 0.0, 1.0))
    if not factors:
        return torch.zeros_like(dist)
    return 1.0 - torch.prod(torch.cat(factors), dim=0)


def two_layers(scene, o, d, tau, keep=None):
    """[(t1, k1), (t2, k2)]: the nearest and next-nearest soft layers by
    t_rank (argmin with first-wins ties, then the winner-masked re-argmin,
    so the later of a tied pair is layer 2). k numbers spheres 0..N-1 and
    rects N..N+M-1; a dead layer has k = -1 and t = BIG. No gradient.
    ``keep`` (N, H, W) bool, if given, limits each ray's spheres to those it
    marks (the soft forward kernel's culled ranking)."""
    with torch.no_grad():
        parts = []
        if scene.spheres.count:
            c, r = sphere_axis(scene.spheres)
            ts = sphere_soft(c, r, _lead(o), _lead(d), tau)[0]
            parts.append(ts if keep is None else torch.where(keep, ts, BIG))
        if scene.rects.count:
            parts.append(rect_ts(scene.rects, o, d))
        t_all = torch.cat(parts)
        layers = []
        for _ in range(2):
            k = torch.argmin(t_all, dim=0)
            t = torch.gather(t_all, 0, k[None])[0]
            layers.append((t, torch.where(t < BIG * 0.5, k, -1)))
            t_all = t_all.scatter(0, k[None], BIG)
        return layers


def soft_layer(scene, o, d, k, tau, shape, checker_tau=0.0):
    """(t, live, attrs, alpha) of one layer's winners ``k`` (per pixel),
    with gradient: a sphere's soft t_rank and coverage, its normal (p - c)/r
    and checker at that t, a rect's hit with coverage 1; t = BIG and alpha
    0 where the layer is dead. A textured group's base colour is its
    winner's grid sampled at `sphere_uv` of that normal (the azimuth wrapped)
    or at the rect's (a, b), in place of the checker."""
    like = dict(device=scene.device, dtype=scene.ambient.dtype)
    sp, rc = scene.spheres, scene.rects
    N, M = sp.count, rc.count
    t = torch.full(shape, BIG, **like)
    alpha = torch.zeros(shape, **like)
    best = init_attrs(shape, like)
    if N:
        ks = k.clamp(0, N - 1)
        pick = lambda x: _take(x, ks)
        c, r = _xyz(pick(sp.center)), pick(sp.radius)
        t_s, a_s = sphere_soft(c, r, o, d, tau)
        m = material_rows(sp.material, pick)
        _, n, col = sphere_hit(o, d, c, r, m, t=t_s, checker_tau=checker_tau)
        if sp.textured:  # at the unnormalised (p - c) / r of the rank t
            col = sample_grid(sp.texture, ks, *sphere_uv(n), wrap_a=True).col
        is_sph = (k >= 0) & (k < N)
        t = torch.where(is_sph, t_s, t)
        alpha = torch.where(is_sph, a_s, alpha)
        best = merge_attrs(best, is_sph, n, col, m)
    if M:
        kr = (k - N).clamp(0, M - 1)
        pick = lambda x: _take(x, kr)
        m = material_rows(rc.material, pick)
        p0, eu, ev = _xyz(pick(rc.origin)), _xyz(pick(rc.edge_u)), _xyz(pick(rc.edge_v))
        t_r, n, col = rect_hit(o, d, p0, eu, ev, m, checker_tau=checker_tau)
        if rc.textured:
            _, a, b, _ = intersect_rect(o, d, p0, eu, ev)
            col = sample_grid(rc.texture, kr, a, b).col
        t = torch.where(k >= N, t_r, t)
        alpha = torch.where(k >= N, 1.0, alpha)
        best = merge_attrs(best, k >= N, n, col, m)
    return t, k >= 0, best, alpha


def shade_soft(scene, o, d, cfg: RenderConfig, shape, return_vis: bool = False):
    """Two-layer soft compositing (`_render_soft`): each layer shaded
    unclipped with the soft shadow product, then a1 c1 + (1 - a1) (a2 c2 +
    (1 - a2) bg), clipped; bg is `pipeline.miss_color` of the primary ray
    (the environment map's sample where the scene has one)."""
    if return_vis:
        raise NotImplementedError("the soft renderer writes no visibility planes")
    if cfg.reflections:
        raise NotImplementedError("mirror reflections require hard semantics (soft_tau = 0)")
    tau = cfg.soft_tau
    cfg_layer = dataclasses.replace(cfg, clip=False, soft_tau=0.0)
    occ = lambda sc, so, ld, dist: occluded_soft(sc, so, ld, dist, tau)
    layers = []
    for _, k in two_layers(scene, o, d, tau):
        t, live, at, alpha = soft_layer(scene, o, d, k, tau, shape, cfg.checker_tau)
        col = shade_from_attrs(scene, o, d, cfg_layer, shape, t, live, at, occluded_fn=occ)
        layers.append((torch.where(live, alpha, 0.0), col))
    (a1, c1), (a2, c2) = layers
    bg = miss_color(scene, d, shape)
    out = []
    for ch in range(3):
        behind = a2 * c2[ch] + (1.0 - a2) * bg[ch]
        comp = a1 * c1[ch] + (1.0 - a1) * behind
        out.append(vm.clip01(comp) if cfg.clip else comp)
    return tuple(out)


def render_eager_vec(scene, cfg: RenderConfig, row0=0, out_height: int | None = None):
    """Render the image, or its band of ``out_height`` rows from ``row0``
    (`band_config`; the JAX package's ``row0`` / ``height``), with the
    objects on a leading axis (the twin of `render_jnp_vec`), soft when
    ``cfg.soft_tau > 0``, with the soft checker when ``cfg.checker_tau >
    0``. Returns (rows, W, 3) in the scene's dtype."""
    cfg = band_config(cfg, row0, out_height)
    shade_fn = shade_soft if cfg.soft_tau > 0.0 else shade_vec
    r, g, b = render_tile(scene, cfg, cfg.row0, 0, cfg.height, cfg.width, shade_fn=shade_fn)
    return torch.stack([r, g, b], dim=-1)
