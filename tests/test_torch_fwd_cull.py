"""The per-warp culls of the two forwards (rows 4 and 7), on the CPU.

The vec forward (csrc/fused_vec_render.cu) walks, per warp of 32 pixels of
a row, the spheres of the warp's cone of primary rays and, per light, those
near the segment from a ball of its hit pixels' shadow origins to the light
(`cull.primary_candidates`, `cull.warp_candidates` at tau = 0), as rows 5-6
do. The soft forward (csrc/fused_vec_soft_render.cu) ranks only the spheres
of the cone widened to the soft ranking's reach, r sqrt(1 + SOFT_CULL tau)
(`cull.primary_candidates` at tau), and takes each shadow product over the
warp's candidates by the per-pixel rule of rows 8-9. A sphere that is culled
ranks BIG, misses, or has a shadow factor of exactly 1 for every ray of the
warp, so both images keep the bits of the walks over every sphere. Held here
on config 5 cut to 25 spheres at 40x48 (a run of 32 and a ragged run of 16
a row), seeds 0-2, float32:

- (a) at tau 0.08 and 0.01, every (pixel, sphere) pair whose soft rank is
  below BIG lies in its warp's primary candidates at tau;
- (b) the two layers ranked over those candidates equal the ranking over
  every sphere, bit for bit;
- (c) the soft forward's eager twin (`render_vec_soft_culled`: the culled
  ranking, each shadow product over the warp's candidates by the per-pixel
  rule) gives `render_vec_soft_plain`'s image bit for bit;
- (d) at tau 0 `primary_candidates` gives the masks of the test before it
  took tau (rows 5-6 keep their bits);
- (e) the vec forward's eager twin (`render_vec_culled`: `culled_nearest`
  and `culled_visibility` through the forward's shading) gives
  `render_vec_plain`'s image, and its planes on hit pixels, bit for bit, and
  0 on the planes where the ray hits nothing.

Nothing here imports JAX; the file runs in a few seconds, on one torch
thread.
"""

import dataclasses

import pytest
import torch

from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.ops import pipeline as pl
from reversible_raytracer_tpu_torch.ops.kernels import cull, fused_vec, fused_vec_soft
from reversible_raytracer_tpu_torch.ops.pipeline import BIG, RenderConfig
from reversible_raytracer_tpu_torch.ops.pipeline_vec import (
    _lead,
    nearest_vec,
    sphere_axis,
    sphere_soft,
    two_layers,
)

SEEDS = [0, 1, 2]
TAUS = [0.08, 0.01]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six test
    processes at once, and torch's default of a thread per core slows this
    file and the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene(seed, tau=0.0, size=(40, 48)):
    scene, spec, _ = configs.config5_many_spheres(size=64, n_spheres=25, device="cpu")
    start = configs.perturb(scene, spec, scale=0.05, seed=seed)
    return start, RenderConfig(height=size[0], width=size[1], shadows=True, soft_tau=tau)


def _primary_keep(scene, cfg, d):
    """(N, H, W): each pixel's spheres, its warp's primary candidates at the
    configuration's tau."""
    cand = cull.primary_candidates(scene.spheres, scene.camera.eye, d, cfg.soft_tau)
    return cull.per_pixel(cand, cfg.width), cand


@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("seed", SEEDS)
def test_widened_cone_holds_every_ranked_pair(seed, tau):
    scene, cfg = _scene(seed, tau)
    o, d = pl.primary_rays(scene, cfg)
    c, r = sphere_axis(scene.spheres)
    ranked = sphere_soft(c, r, _lead(o), _lead(d), tau)[0] < BIG
    keep, cand = _primary_keep(scene, cfg, d)
    assert int(ranked.sum()) > 0
    assert int((ranked & ~keep).sum()) == 0
    assert 0.0 < float(cand.float().mean()) < 1.0  # the cone drops spheres


@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("seed", SEEDS)
def test_culled_ranking_is_the_full_ranking(seed, tau):
    scene, cfg = _scene(seed, tau)
    o, d = pl.primary_rays(scene, cfg)
    keep, _ = _primary_keep(scene, cfg, d)
    for (t_c, k_c), (t_f, k_f) in zip(two_layers(scene, o, d, tau, keep),
                                      two_layers(scene, o, d, tau)):
        assert torch.equal(t_c, t_f) and torch.equal(k_c, k_f)
    assert bool((k_f >= 0).any())  # a second layer lives somewhere


@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("seed", SEEDS)
def test_culled_soft_forward_is_the_plain_image(seed, tau):
    scene, cfg = _scene(seed, tau)
    assert torch.equal(fused_vec_soft.render_vec_soft_culled(scene, cfg),
                       fused_vec_soft.render_vec_soft_plain(scene, cfg))


def _cone_before_tau(spheres, eye, d):
    """`cull.primary_candidates` as it was before it took tau."""
    lv = cull.runs(torch.ones_like(d[0], dtype=torch.bool), False)
    dd = torch.stack([cull.runs(x, 0.0) for x in d], dim=-1)
    s = torch.where(lv[..., None], dd, 0.0).sum(2)
    a = s * torch.rsqrt((s * s).sum(-1, keepdim=True))
    cmin = torch.where(lv, (dd * a[:, :, None]).sum(-1), 1.0).amin(2)
    x = torch.linalg.cross(dd, a[:, :, None].expand_as(dd), dim=-1)
    smax = torch.sqrt(torch.where(lv, (x * x).sum(-1), 0.0).amax(2))
    wc = spheres.center - eye
    D2 = (wc * wc).sum(-1)
    D = torch.sqrt(D2)
    r = spheres.radius * (1.0 + cull.CULL_REL) + cull.CULL_ABS * D
    reach = cmin[..., None] * torch.sqrt(torch.clamp(D2 - r * r, min=0.0)) - smax[..., None] * r
    return ((~(cmin > 0.0))[..., None] | (r >= D)
            | ((a[:, :, None] * wc).sum(-1) >= reach))


@pytest.mark.parametrize("seed", SEEDS)
def test_hard_cone_keeps_its_masks(seed):
    scene, cfg = _scene(seed)
    d = pl.primary_rays(scene, cfg)[1]
    got = cull.primary_candidates(scene.spheres, scene.camera.eye, d, 0.0)
    assert torch.equal(got, _cone_before_tau(scene.spheres, scene.camera.eye, d))
    assert torch.equal(got, cull.primary_candidates(scene.spheres, scene.camera.eye, d))
    wide = cull.primary_candidates(scene.spheres, scene.camera.eye, d, 0.08)
    assert bool((wide & ~got).any()) and not bool((got & ~wide).any())  # widening adds only


@pytest.mark.parametrize("seed", SEEDS)
def test_culled_vec_forward_is_the_plain_render(seed):
    scene, cfg = _scene(seed)
    img_c, vis_c = fused_vec.render_vec_culled(scene, cfg)
    img_p, vis_p = fused_vec.render_vec_plain(scene, cfg)
    o, d = pl.primary_rays(scene, cfg)
    hit = nearest_vec(scene, o, d)[1] >= 0
    assert torch.equal(img_c, img_p)
    assert vis_c.shape == vis_p.shape == (1, cfg.height, cfg.width)
    assert torch.equal(vis_c[:, hit], vis_p[:, hit])
    assert bool((~hit).any()) and not bool(vis_c[:, ~hit].any())
    assert bool((vis_c[:, hit] == 0.0).any())  # some hit pixel is in shadow
    no_shadows = dataclasses.replace(cfg, shadows=False)
    img_n, vis_n = fused_vec.render_vec_culled(scene, no_shadows)
    assert torch.equal(img_n, fused_vec.render_vec_plain(scene, no_shadows)[0])
    assert vis_n.shape == (0, cfg.height, cfg.width)
