"""The per-warp culls of the vec step and vec render backward, on the CPU.

The two kernels (csrc/vec_step.cuh) walk, for each warp of 32 pixels of a
row, only the spheres that a conservative test of the warp keeps: for the
primary rays a cone about the eye (`cull.primary_candidates`), for the
step's shadow rays toward each light a ball of the hit pixels' shadow
origins (`cull.warp_candidates` at tau = 0, the soft step's test). A
dropped sphere must miss every ray of the warp, so that winners, t and
visibility are those of the walk over every sphere, bit for bit. Held here
on config 5 cut to 25 spheres at 48x64 (two warps a row), seeds 0-2,
float32:

- (a) every (pixel, sphere) pair whose float32 intersection is a hit lies
  in its warp's primary candidates, and every pair whose shadow test gives
  t < dist lies in its warp's shadow candidates; the same with a sphere
  added just inside a warp's bound, which a ray of the warp hits;
- (a') the same of a bounce's reflected rays and `cull.bounce_candidates`
  (a ball of the warp's origins and a cone of its directions), which the
  bounds of rows 4-6 with a bounce count level 1's walk by: every hit pair
  of a reflected ray lies in its warp's candidates, on the config-5 cut
  and on config 10 at 64x64, and the candidates drop some pairs;
- (b) the eager twins of the step and of the render backward, which walk
  the culled candidates, against the same twins with the culls keeping
  every sphere: nearest hit (so the image), visibility, loss and every
  gradient leaf bit-equal.

Nothing here imports JAX; the file runs in a few seconds, on one torch
thread.
"""

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.models.scene import Spheres, leaf_paths, tree_leaves
from reversible_raytracer_tpu_torch.ops import pipeline as pl
from reversible_raytracer_tpu_torch.ops.kernels import cull, fused, fused_vec
from reversible_raytracer_tpu_torch.ops.pipeline import BIG, RenderConfig
from reversible_raytracer_tpu_torch.ops.pipeline_vec import (
    nearest_vec,
    occluded_any,
    render_eager_vec,
    sphere_ts,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six test
    processes at once, and torch's default of a thread per core slows this
    file and the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene(seed, size=(48, 64)):
    scene, spec, _ = configs.config5_many_spheres(size=64, n_spheres=25, device="cpu")
    start = configs.perturb(scene, spec, scale=0.05, seed=seed)
    return scene, start, RenderConfig(height=size[0], width=size[1], shadows=True)


def _forward(scene, cfg):
    """The twin's primary rays, nearest hit and shadow origins."""
    ray = fused.primary_ray_terms(scene, cfg)
    t, k = nearest_vec(scene, ray.o, ray.d)
    zero = torch.zeros((cfg.height, cfg.width))
    w = fused.winner_surface(scene, fused.winner_geometry(scene, k, zero), ray.o, ray.d, t, zero)
    so = pl.shadow_origin(ray.o, ray.d, t, w.n)
    return ray, k >= 0, so


def _uncovered(scene, cfg):
    """(primary, shadow) hit pairs outside their warp's candidates, and the
    candidate fractions of all pairs."""
    ray, hit, so = _forward(scene, cfg)
    sp = scene.spheres
    prim = cull.primary_candidates(sp, scene.camera.eye, ray.d)
    hits = sphere_ts(sp, ray.o, ray.d) < BIG
    missed_p = int((hits & ~cull.per_pixel(prim, cfg.width)).sum())
    missed_s, shadow_frac = 0, []
    for li in range(scene.lights.count):
        ldir, dist = pl.light_geometry(scene.lights, li, so)
        cand = cull.warp_candidates(sp, so, hit, scene.lights.position[li], 0.0)
        occ = (sphere_ts(sp, so, ldir) < dist[None]) & hit[None]
        missed_s += int((occ & ~cull.per_pixel(cand, cfg.width)).sum())
        shadow_frac.append(float(cand.float().mean()))
    return missed_p, missed_s, float(prim.float().mean()), shadow_frac


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_candidates_hold_every_hit_pair(seed):
    _, start, cfg = _scene(seed)
    missed_p, missed_s, prim, shadow = _uncovered(start, cfg)
    assert missed_p == 0 and missed_s == 0
    assert 0.0 < prim < 1.0 and all(0.0 < f < 1.0 for f in shadow), (prim, shadow)


def _bounce_uncovered(scene, cfg):
    """Reflected-ray hit pairs outside their warp's bounce candidates, and
    the share of (ray, sphere) pairs the candidates keep."""
    ray, hit, so = _forward(scene, cfg)
    _, _, at = pl.trace_nearest(scene, ray.o, ray.d, cfg.shape)
    d1 = pl.reflect_dir(ray.d, (at["nx"], at["ny"], at["nz"]))
    cand = cull.bounce_candidates(scene.spheres, so, d1, hit)
    hits = (sphere_ts(scene.spheres, so, d1) < BIG) & hit[None]
    kept = float((cand.sum(-1) * cull.runs(hit, False).sum(-1)).sum())
    return (int((hits & ~cull.per_pixel(cand, cfg.width)).sum()), int(hits.sum()),
            kept / (int(hit.sum()) * scene.spheres.count))


@pytest.mark.parametrize("config, seed", [(5, 0), (5, 1), (5, 2), (10, 0)])
def test_bounce_candidates_hold_every_hit_pair(config, seed):
    if config == 5:
        _, start, cfg = _scene(seed)
    else:
        start, _, cfg = configs.CONFIGS[10](size=64, device="cpu")
    missed, hits, kept = _bounce_uncovered(start, cfg)
    assert missed == 0 and hits > 0
    assert 0.0 < kept < 1.0, kept


def _with_sphere(scene, centre, radius):
    """The scene with one more sphere (sphere 0's material) at the end."""
    sp = scene.spheres
    more = lambda x: torch.cat([x, x[:1]])  # noqa: E731
    mat = dataclasses.replace(sp.material, **{f.name: more(getattr(sp.material, f.name))
                                              for f in dataclasses.fields(sp.material)})
    return dataclasses.replace(scene, spheres=Spheres(
        center=torch.cat([sp.center, centre[None]]),
        radius=torch.cat([sp.radius, torch.tensor([radius])]),
        material=mat, texture=more(sp.texture)))


def _cone_sphere(scene, cfg, row, run, radius=0.3, dist=8.0):
    """A sphere just inside a warp's cone bound: seen from the eye at the
    angle theta + 0.999 beta from the warp's axis, beyond its widest ray
    (theta from the axis, in the plane of the two), so that this ray passes
    at 0.999 r from the centre. Returns the scene with it and that angle over
    theta + beta (the bound without its allowance)."""
    ray, _, _ = _forward(scene, cfg)
    cols = slice(32 * run, 32 * run + 32)
    d = torch.stack([x[row, cols] for x in ray.d], dim=-1).double()
    a = d.sum(0) / torch.linalg.norm(d.sum(0))
    ang = torch.arccos(torch.clamp(d @ a, -1.0, 1.0))
    far = d[torch.argmax(ang)]
    theta = float(ang.max())
    u = far - a * torch.dot(far, a)
    u = u / torch.linalg.norm(u)
    beta = math.asin(radius / dist)
    gamma = theta + 0.999 * beta
    e = a * math.cos(gamma) + u * math.sin(gamma)
    centre = (scene.camera.eye.double() + dist * e).float()
    return _with_sphere(scene, centre, radius), gamma / (theta + beta)


def _ball_sphere(scene, cfg, row, run, radius=0.05):
    """A sphere just inside a warp's shadow bound: placed off the shadow
    segment of the warp's hit pixel farthest from the ball's centre, on the
    far side, at 0.999 r from that segment, so that this pixel's shadow ray
    hits it while its centre lies close to r + rho of the warp's segment [c_w,
    light]. Returns the scene with it and its distance over r + rho."""
    _, hit, so = _forward(scene, cfg)
    cols = slice(32 * run, 32 * run + 32)
    o = torch.stack([x[row, cols] for x in so], dim=-1)[hit[row, cols]]
    cw = (o.amin(0) + o.amax(0)) * 0.5
    far = o[torch.argmax(((o - cw) ** 2).sum(-1))]
    rho = float(torch.sqrt(((o - cw) ** 2).sum(-1).max()))
    lpos = scene.lights.position[0]
    seg = lpos - far
    u = seg / torch.linalg.norm(seg)
    away = (far - cw) - u * torch.dot(far - cw, u)
    away = away / torch.linalg.norm(away)
    centre = far + seg * 0.05 + away * (radius * 0.999)
    w, v = centre - cw, lpos - cw
    q = w - v * torch.clamp(torch.dot(w, v) / torch.dot(v, v), 0.0, 1.0)
    return _with_sphere(scene, centre, radius), float(torch.linalg.norm(q)) / (radius + rho)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_candidates_hold_a_sphere_at_the_bound(seed):
    _, start, cfg = _scene(seed)
    row, run = 20, 1
    added, ratio = _cone_sphere(start, cfg, row, run)
    assert 0.9 < ratio < 1.0, ratio
    ray, _, _ = _forward(added, cfg)
    t = sphere_ts(added.spheres, ray.o, ray.d)[-1]
    assert bool((t[row, 32 * run:32 * run + 32] < BIG).any())  # the widest ray hits it
    assert _uncovered(added, cfg)[:2] == (0, 0)

    added, ratio = _ball_sphere(start, cfg, row=30, run=1)
    assert 0.8 < ratio < 1.0, ratio
    _, hit, so = _forward(added, cfg)
    ldir, dist = pl.light_geometry(added.lights, 0, so)
    occ = (sphere_ts(added.spheres, so, ldir)[-1] < dist) & hit
    assert bool(occ[30, 32:64].any())  # a shadow ray of that warp hits it
    assert _uncovered(added, cfg)[:2] == (0, 0)


def _keep_all(monkeypatch):
    """The culls of the twins keeping every sphere."""
    for name in ("primary_candidates", "warp_candidates"):
        real = getattr(fused_vec, name)
        monkeypatch.setattr(fused_vec, name,
                            lambda *a, real=real: torch.ones_like(real(*a)))


def _same_leaves(a, b):
    for path, x, y in zip(leaf_paths(a), tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y), path


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_culled_twins_are_the_full_walk_bit_for_bit(monkeypatch, seed):
    scene, start, cfg = _scene(seed)
    target = render_eager_vec(scene, cfg).detach()
    g_img = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(cfg.height, cfg.width, 3)).astype(np.float32))
    vis = fused_vec.render_vec_plain(start, cfg)[1]
    ray, hit, so = _forward(start, cfg)
    ldir, dist = pl.light_geometry(start.lights, 0, so)
    f = SimpleNamespace(ldir=ldir, dist=dist)
    zero = torch.zeros((cfg.height, cfg.width))

    def run():
        with torch.no_grad():
            near = fused_vec.culled_nearest(start, ray.o, ray.d)
            v = fused_vec.culled_visibility(start, cfg)(0, so, f, zero, hit)
        return (near, v, fused_vec.loss_grad_vec_adjoint_eager(start, cfg, target),
                fused_vec.render_vec_bwd_adjoint_eager(start, cfg, g_img, vis))

    (t_c, k_c), vis_c, (l_c, g_c), b_c = run()
    _keep_all(monkeypatch)
    (t_f, k_f), vis_f, (l_f, g_f), b_f = run()
    assert torch.equal(t_c, t_f) and torch.equal(k_c, k_f)
    assert torch.equal(vis_c[hit], vis_f[hit])
    full = torch.where(occluded_any(start, so, ldir, dist), 0.0, 1.0)
    assert torch.equal(vis_f[hit], full[hit])  # keeping every sphere is the full walk
    assert torch.equal(l_c, l_f)
    _same_leaves(g_f, g_c)
    _same_leaves(b_f, b_c)
