"""The shadow cull of the soft step and soft render backward, on the CPU.

The soft kernels drop a (pixel, sphere) pair of a shadow ray whose
coverage x = disc / (tau r^2) lies below -SOFT_CULL, or whose sphere is not
between the surface and the light: its factor 1 - sigmoid(x) is exactly 1,
so the product keeps its bits, and its adjoint is under 2^-25 of its
cotangent. A warp visits only the spheres that its conservative test
(`fused_vec_soft.warp_candidates`) keeps. Held here:

- (a) over a dense grid of x in [-100, 0], in float32 and float64,
  x < -SOFT_CULL[dtype] gives 1 - sigmoid(x) == 1 exactly, for torch's
  sigmoid and for the kernels' 1 / (1 + exp(-x)) in float32;
- (b) on config 5 cut to 25 spheres at 48x64 (two warps a row), seeds 0-2,
  tau 0.08 and 0.01, float32: every (pixel, sphere) pair that the
  per-pixel rule keeps, on either live layer, lies in its run's
  candidates; and the same with a sphere added just inside a run's bound;
- (c) the eager twin of the step in float32, at the seeds and taus of (b),
  with the cull and with it switched off (SOFT_CULL at infinity): its sum
  of squared residuals and its per-layer visibilities bit-equal, its
  gradient within 2e-6 of each leaf's scale. The dropped terms are each
  under 2^-25 of their cotangent; what moves is float32 rounding of the
  per-pixel sums, largest on `camera.eye`, a small net of cancelling
  per-pixel terms (1.06e-6 of its scale at seed 1, tau 0.08; every other
  leaf and case under 7e-7).

Nothing here imports JAX; the file runs in a few seconds, on one torch
thread.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.models.scene import Spheres, leaf_paths, tree_leaves
from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec_soft
from reversible_raytracer_tpu_torch.ops.pipeline import RenderConfig
from reversible_raytracer_tpu_torch.ops.pipeline_vec import render_eager_vec, sphere_axis


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six test
    processes at once, and torch's default of a thread per core made this
    file take 171 s there against 4 s alone, slowing the others too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_culled_factor_is_exactly_one(dtype):
    thr = fused_vec_soft.SOFT_CULL[dtype]
    x = torch.linspace(-100.0, 0.0, 200001, dtype=torch.float64).to(dtype)
    culled = x < -thr
    assert int(culled.sum()) > 1000
    assert bool((1.0 - torch.sigmoid(x[culled]) == 1.0).all())
    # just past the threshold the factor is below 1: the threshold is not loose by much
    assert float(1.0 - torch.sigmoid(torch.tensor(-thr + 3.0, dtype=dtype))) < 1.0
    if dtype == torch.float32:  # the kernels' sigmoid, 1 / (1 + expf(-x))
        xs = x[culled].numpy()
        with np.errstate(over="ignore"):
            s = np.float32(1.0) / (np.float32(1.0) + np.exp(-xs))
        assert s.dtype == np.float32
        assert bool((np.float32(1.0) - s == np.float32(1.0)).all())


def _scene(seed, tau, size=(48, 64)):
    scene, spec, _ = configs.config5_many_spheres(size=64, n_spheres=25, device="cpu")
    start = configs.perturb(scene, spec, scale=0.05, seed=seed)
    cfg = RenderConfig(height=size[0], width=size[1], shadows=True, soft_tau=tau)
    return scene, start, cfg


def _layers(scene, cfg):
    """The twin's two soft layers (shadow origins, live pixels, light terms)."""
    tau = cfg.soft_tau
    zero = torch.zeros((cfg.height, cfg.width))
    ray = fused.primary_ray_terms(scene, cfg)
    return [fused_vec_soft._layer(scene, cfg, ray, k, tau, zero)
            for _, k in fused_vec_soft.two_layers(scene, ray.o, ray.d, tau)]


def _uncovered(scene, cfg):
    """Kept (pixel, sphere) pairs outside their run's candidates, and the
    kept and candidate fractions, over both layers and every light."""
    tau = cfg.soft_tau
    c, r = sphere_axis(scene.spheres)
    missed, kept_n, cand_n, pairs = 0, 0, 0, 0
    for y in _layers(scene, cfg):
        for li, f in enumerate(y.lights):
            so = tuple(x[None] for x in y.so)
            kept = fused_vec_soft.shadow_kept(c, r, so, tuple(x[None] for x in f.ldir),
                                              f.dist[None], tau) & y.hit[None]
            cand = fused_vec_soft.warp_candidates(scene.spheres, y.so, y.hit,
                                                  scene.lights.position[li], tau)
            per_px = cand.repeat_interleave(32, dim=1)[:, :cfg.width].permute(2, 0, 1)
            missed += int((kept & ~per_px).sum())
            kept_n += int(kept.sum())
            cand_n += int((per_px & y.hit[None]).sum())
            pairs += int(y.hit.sum()) * scene.spheres.count
    return missed, kept_n / pairs, cand_n / pairs


@pytest.mark.parametrize("tau", [0.08, 0.01])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warp_candidates_hold_every_kept_pair(seed, tau):
    _, start, cfg = _scene(seed, tau)
    missed, kept, cand = _uncovered(start, cfg)
    assert missed == 0
    assert 0.0 < kept <= cand < 1.0, (kept, cand)  # the test culls, and keeps something
    print(f"kept {kept:.4f}, candidates {cand:.4f} of the live pairs")


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


def _edge_sphere(scene, cfg, row, run):
    """A sphere near a run's bound: placed off the shadow segment of the
    run's live pixel farthest from the run's centre, on the far side, so
    that the pixel keeps it while its centre lies close to R + rho of the
    run's segment [c_w, light]. Returns the scene with it and its distance
    over R + rho."""
    tau = cfg.soft_tau
    y = _layers(scene, cfg)[0]
    cols = slice(32 * run, 32 * run + 32)
    live = y.hit[row, cols]
    so = torch.stack([x[row, cols] for x in y.so], dim=-1)[live]
    cw = (so.amin(0) + so.amax(0)) * 0.5
    far = so[torch.argmax(((so - cw) ** 2).sum(-1))]
    rho = float(torch.sqrt(((so - cw) ** 2).sum(-1).max()))
    lpos = scene.lights.position[0]
    seg = lpos - far
    u = seg / torch.linalg.norm(seg)
    away = (far - cw) - u * torch.dot(far - cw, u)
    away = away / torch.linalg.norm(away)
    radius = 0.05
    R = radius * math.sqrt(1.0 + fused_vec_soft.SOFT_CULL[torch.float32] * tau)
    centre = far + seg * 0.05 + away * (R * 0.999)
    added = _with_sphere(scene, centre, radius)
    w, v = centre - cw, lpos - cw
    q = w - v * torch.clamp(torch.dot(w, v) / torch.dot(v, v), 0.0, 1.0)
    return added, float(torch.linalg.norm(q)) / (R + rho)


@pytest.mark.parametrize("tau", [0.08, 0.01])
def test_warp_candidates_hold_a_sphere_at_the_bound(tau):
    _, start, cfg = _scene(0, tau)
    added, ratio = _edge_sphere(start, cfg, row=30, run=1)
    assert 0.8 < ratio < 1.0, ratio
    missed, kept, _ = _uncovered(added, cfg)
    assert missed == 0
    # the added sphere is kept by at least one pixel of that run
    y = _layers(added, cfg)[0]
    c, r = sphere_axis(added.spheres)
    f = y.lights[0]
    k = fused_vec_soft.shadow_kept(c, r, tuple(x[None] for x in y.so),
                                   tuple(x[None] for x in f.ldir), f.dist[None], tau)
    assert bool((k[-1] & y.hit)[30, 32:64].any())


@pytest.mark.parametrize("tau", [0.08, 0.01])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twin_cull_keeps_the_forward_bits(monkeypatch, seed, tau):
    scene, start, cfg = _scene(seed, tau)
    target = render_eager_vec(scene, cfg).detach()
    culled = fused_vec_soft.loss_grad_vec_soft_adjoint_eager(start, cfg, target)
    vis = [f.vis for y in _layers(start, cfg) for f in y.lights]
    monkeypatch.setitem(fused_vec_soft.SOFT_CULL, torch.float32, math.inf)
    full = fused_vec_soft.loss_grad_vec_soft_adjoint_eager(start, cfg, target)
    vis_full = [f.vis for y in _layers(start, cfg) for f in y.lights]
    assert torch.equal(culled[0], full[0])
    assert all(torch.equal(a, b) for a, b in zip(vis, vis_full))
    for path, a, b in zip(leaf_paths(full[1]), tree_leaves(full[1]), tree_leaves(culled[1])):
        if a.numel():
            scale = max(float(a.abs().max()), 1e-6)
            assert float((a - b).abs().max()) <= 2e-6 * scale, path
