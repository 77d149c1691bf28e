"""Object-vectorized renderer (hard semantics) in eager torch.

The counterpart of `reversible_raytracer_tpu.ops.pipeline_vec` for the
hard, untextured, bounce-free branch: the objects of a scene lie on a
leading axis (`t_all: (N + M, H, W)`), the nearest hit is an argmin over
that axis with first-wins ties (spheres first, then rects), and the shadow
test is an any-hit over it. Only the winning object's intersection and
attributes are then evaluated per pixel, so the gradient reaches the winner
alone, as it does through the JAX package's ``take_along_axis``.

The arithmetic of every pixel is that of `pipeline.shade` (same operations
in the same order), so on any scene `render_eager_vec` gives the bits of
`render.render_eager`. It is the plain version of the object-chunked CUDA
kernels (`kernels.fused_vec`), and through autograd the plain version of
their training step. Soft visibility, textures, environment maps and mirror
reflections raise `NotImplementedError`.
"""

from __future__ import annotations

import torch

from .pipeline import (
    BIG,
    RenderConfig,
    _xyz,
    init_attrs,
    intersect_rect,
    intersect_sphere,
    material_rows,
    merge_attrs,
    rect_hit,
    render_tile,
    shade_from_attrs,
    sphere_hit,
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


def occluded_any(scene, o, ldir, dist):
    """Any-hit shadow test over all objects at once (a step: no gradient)."""
    with torch.no_grad():
        occ = torch.zeros_like(dist, dtype=torch.bool)
        if scene.spheres.count:
            occ = occ | (sphere_ts(scene.spheres, o, ldir) < dist).any(dim=0)
        if scene.rects.count:
            occ = occ | (rect_ts(scene.rects, o, ldir) < dist).any(dim=0)
    return occ


def nearest_vec(scene, o, d):
    """(t, k) of every ray's nearest hit: spheres are 0..N-1 and rects
    N..N+M-1 in k, a miss is k = -1 with t = BIG. Argmin over the stacked t
    with first-wins ties (strict <, as the where chain); no gradient."""
    with torch.no_grad():
        parts = []
        if scene.spheres.count:
            parts.append(sphere_ts(scene.spheres, o, d))
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


def trace_nearest_vec(scene, o, d, shape):
    """`pipeline.trace_nearest` with the objects on a leading axis: (t, hit,
    attrs), where only the winner's intersection and attributes are
    evaluated (with gradient) per pixel."""
    if scene.spheres.textured or scene.rects.textured:
        raise NotImplementedError("object textures are not ported yet")
    like = dict(device=scene.device, dtype=scene.ambient.dtype)
    sp, rc = scene.spheres, scene.rects
    N, M = sp.count, rc.count
    _, k = nearest_vec(scene, o, d)
    t = torch.full(shape, BIG, **like)
    best = init_attrs(shape, like)
    if N:
        ks = k.clamp(0, N - 1)
        pick = lambda x: _take(x, ks)
        m = material_rows(sp.material, pick)
        t_s, n_unit, col = sphere_hit(o, d, _xyz(pick(sp.center)), pick(sp.radius), m)
        is_sph = (k >= 0) & (k < N)
        t = torch.where(is_sph, t_s, t)
        best = merge_attrs(best, is_sph, n_unit, col, m)
    if M:
        kr = (k - N).clamp(0, M - 1)
        pick = lambda x: _take(x, kr)
        m = material_rows(rc.material, pick)
        t_r, n_unit, col = rect_hit(o, d, _xyz(pick(rc.origin)), _xyz(pick(rc.edge_u)),
                                    _xyz(pick(rc.edge_v)), m)
        t = torch.where(k >= N, t_r, t)
        best = merge_attrs(best, k >= N, n_unit, col, m)
    return t, t < BIG * 0.5, best


def shade_vec(scene, o, d, cfg: RenderConfig, shape, return_vis: bool = False):
    """`pipeline.shade` through the object-vectorized trace and any-hit."""
    if cfg.reflections and cfg.shader == "phong":
        raise NotImplementedError("mirror reflections are not ported yet")
    t, hit, at = trace_nearest_vec(scene, o, d, shape)
    return shade_from_attrs(scene, o, d, cfg, shape, t, hit, at, return_vis=return_vis,
                            occluded_fn=occluded_any)


def render_eager_vec(scene, cfg: RenderConfig):
    """Render the full image with the objects on a leading axis (the twin
    of `render_jnp_vec`). Returns (H, W, 3) in the scene's dtype."""
    r, g, b = render_tile(scene, cfg, 0, 0, cfg.height, cfg.width, shade_fn=shade_vec)
    return torch.stack([r, g, b], dim=-1)
