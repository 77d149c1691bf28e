"""2x2 supersampling (spp 4) on the textured, sky-lit and mirrored scenes
of the port, on the CPU, against the JAX package's float64 numpy oracle.

The subsample offsets are +-0.25 of a pixel, so subsample (i +- 0.25, j +-
0.25) of an H x W image is pixel (2i or 2i + 1, 2j or 2j + 1) of a 2H x 2W
image with the same camera: spp 4 at H x W is the 2x2 box mean of the
oracle's clipped 2H x 2W render (`_oracle_spp4`).

- the eager renders (`render_eager` / `render_eager_vec`, by the CPU's
  dispatch) at spp 4 on configs 6-10, on config 8 with a bounce and on four
  textured globes (`chip_smoke.globes_case` cut to 4 spheres) with and
  without one, against that box mean: max below 1e-3, mean below 1e-5;
- the plain versions of rows 2 and 4 (`render_fused_plain` where the
  unrolled family takes the pair, `render_vec_plain`, and row 4's culled
  twin `render_vec_culled`) at spp 4 with a bounce: their images within 1e-6
  of the eager render, their planes in `fused.subsample_planes`' layout (4
  (1 + R) L) the same on each subsample's and level's hit pixels
  (`fused_vec.level_hits` at its offset), the culled twin's 0 elsewhere;
- the eager twins of rows 1 and 3 (configs 7 and 9) and of rows 6 and 5
  (config 10, config 8 with a bounce) at spp 4 against torch autograd of
  the eager render in float64: every leaf within 1e-5 of its scale;
- the same twins (configs 7 and 9, config 8 with a bounce) against central
  differences of the oracle's spp-4 loss and of its image's product with a
  cotangent, on the texel grids' and the mirror coefficients' largest
  entries: within 1e-5 of each leaf's scale;
- the soft render of config 8 at tau 0.08 and spp 4: the average of the
  four offset renders, and its autograd gradient finite and not 0 on the
  texels;
- the kernels' checks take these pairs at spp 4 and still refuse, by name,
  two bounces, the soft step (row 9) at spp 4 and the soft checker beside a
  texel grid.

The oracle is loaded from its file, so that this file imports no JAX (the
JAX package's __init__ does); the kernels are held to these plain versions
on a card in tests/test_torch_kernels.py and chip_smoke.py (phases
spp4_texels, spp4_texels_main).
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.models.scene import (
    leaf_paths,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from reversible_raytracer_tpu_torch.ops import pipeline as pl
from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec, fused_vec_soft
from reversible_raytracer_tpu_torch.ops.pipeline_vec import render_eager_vec, shade_soft
from reversible_raytracer_tpu_torch.ops.render import render, render_eager, resolve_impl

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "_reference_np", ROOT / "reversible_raytracer_tpu" / "oracle" / "reference_np.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

SIZE = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six test
    processes at once, and torch's default of a thread per core slows this
    file and the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _globes(refl, n=4):
    """`chip_smoke.globes_case` cut to ``n`` spheres at SIZE^2: config 5's
    spheres with 16 x 16 grids from default_rng(7) (with a bounce, mirror
    coefficients from the same generator)."""
    scene, _, cfg = configs.config5_many_spheres(SIZE, n_spheres=n, device="cpu")
    sp = scene.spheres
    rng = np.random.default_rng(7)
    tex = torch.tensor(rng.uniform(0.1, 0.9, (sp.count, 16, 16, 3)), dtype=torch.float32)
    sp = dataclasses.replace(sp, texture=tex)
    if refl:
        mir = torch.tensor(rng.uniform(0.2, 0.8, (sp.count,)), dtype=torch.float32)
        sp = dataclasses.replace(sp, material=dataclasses.replace(sp.material, mirror=mir))
    return dataclasses.replace(scene, spheres=sp), dataclasses.replace(cfg, reflections=refl)


def _case(name):
    """(scene, spp-4 cfg) of a case at SIZE^2 on the CPU."""
    if name.startswith("globes"):
        scene, cfg = _globes(int(name[-1]))
    else:
        num, refl = int(name.split("_")[0][6:]), None
        if name.endswith("_r1"):
            refl = 1
        scene, _, cfg = configs.CONFIGS[num](size=SIZE, device="cpu")
        if refl is not None:
            cfg = dataclasses.replace(cfg, reflections=refl)
    return scene, dataclasses.replace(cfg, spp=4)


def _oracle_spp4(scene, cfg):
    """The 2x2 box mean of the oracle's (2H, 2W) render: spp 4 at (H, W)."""
    big = ref.render(scene, 2 * cfg.height, 2 * cfg.width, reflections=cfg.reflections)
    return big.reshape(cfg.height, 2, cfg.width, 2, 3).mean(axis=(1, 3))


# (case, the CPU's eager family)
RENDER_CASES = [("config6", "eager"), ("config7", "eager"), ("config8", "eager"),
                ("config9", "eager"), ("config10", "eager_vec"), ("config8_r1", "eager_vec"),
                ("globes_r0", "eager"), ("globes_r1", "eager_vec")]


@pytest.mark.parametrize("name, impl", RENDER_CASES)
def test_spp4_eager_render_matches_f64_oracle(name, impl):
    scene, cfg = _case(name)
    assert resolve_impl(scene, cfg) == impl
    imgs = [render(scene, cfg)]
    if name == "globes_r0":  # the 64 globes' family past 24 objects: rows 4-6's twin too
        imgs.append(render_eager_vec(scene, cfg))
    want = _oracle_spp4(scene, cfg)
    for img in imgs:
        err = np.abs(img.numpy() - want)
        assert err.max() < 1e-3 and err.mean() < 1e-5


@pytest.mark.parametrize("name", ["config6", "config9", "config10", "config8_r1"])
def test_spp4_plain_forwards_and_their_planes(name):
    """Rows 2 and 4's plain versions at spp 4 with a bounce (and the env or
    object texels): the eager image, and each subsample's planes of both
    levels where that level's ray hit."""
    scene, cfg = _case(name)
    want = render(scene, cfg)
    plain = fused_vec.render_vec_plain(scene, cfg)  # every sphere walked, no cull
    outs = [plain, fused_vec.render_vec_culled(scene, cfg)]
    if resolve_impl(scene, cfg) == "eager":  # the unrolled family takes the pair
        outs.append(fused.render_fused_plain(scene, cfg))
    L = scene.lights.count
    cfg1 = dataclasses.replace(cfg, spp=1)
    zero = torch.zeros((SIZE, SIZE))
    for img, vis in outs:
        assert tuple(vis.shape) == (4 * 2 * L, SIZE, SIZE)
        assert float((img - want).abs().max()) <= 1e-6
    planes = [fused.subsample_planes(scene, cfg, vis) for _, vis in outs]
    for q, off in enumerate(pl.SPP_OFFSETS[4]):
        hits = fused_vec.level_hits(scene, cfg1, off)
        assert bool(hits[0].any()) and bool(hits[1].any())
        for lv, hit in enumerate(hits):
            for li in range(L):
                ref_plane, *others = (at(q)(li, None, None, zero, None, level=lv)
                                      for at in planes)
                for other in others:
                    assert torch.equal(ref_plane[hit], other[hit])
                assert not others[0][~hit].any()  # the culled twin writes 0 off the hits


def _f64(scene):
    return tree_map(lambda x: x.to(torch.float64), scene)


def _start(scene, name):
    """A float64 start: the texels (or, on config 10, the mirrors and the
    sky) and the camera moved, from seed 3."""
    g = torch.Generator().manual_seed(3)
    s = _f64(scene)
    sp, rc = s.spheres, s.rects
    if sp.textured:
        sp = dataclasses.replace(sp, texture=(sp.texture + 0.1 * torch.randn(
            sp.texture.shape, generator=g, dtype=torch.float64)).clamp(0.0, 1.0))
    if rc.textured:
        rc = dataclasses.replace(rc, texture=(rc.texture + 0.1 * torch.randn(
            rc.texture.shape, generator=g, dtype=torch.float64)).clamp(0.0, 1.0))
    if name == "config10":
        sp = dataclasses.replace(sp, material=dataclasses.replace(
            sp.material, mirror=(sp.material.mirror + 0.1 * torch.rand(
                sp.count, generator=g, dtype=torch.float64)).clamp(0.0, 1.0)))
    cam = dataclasses.replace(s.camera, eye=s.camera.eye + 0.02 * torch.randn(
        3, generator=g, dtype=torch.float64))
    env = s.env
    if s.env_mapped:
        env = (env + 0.1 * torch.randn(env.shape, generator=g, dtype=torch.float64)).clamp(0, 1)
    return dataclasses.replace(s, spheres=sp, rects=rc, camera=cam, env=env)


def _close(ref_grads, got, tol=1e-5):
    for path, a, b in zip(leaf_paths(ref_grads), tree_leaves(ref_grads), tree_leaves(got)):
        if a.numel():
            scale = max(float(a.abs().max()), 1e-12)
            assert float((a - b).abs().max()) <= tol * scale, path


@pytest.mark.parametrize("name, family", [("config7", "fused"), ("config9", "fused"),
                                          ("config10", "vec"), ("config8_r1", "vec")])
def test_spp4_twins_match_autograd(name, family):
    """The step's and the render backward's twins (rows 1 and 3, or 6 and
    5) at spp 4 against torch autograd of the eager render, float64."""
    scene, cfg = _case(name)
    truth, start = _f64(scene), _start(scene, name)
    g = torch.randn((SIZE, SIZE, 3), generator=torch.Generator().manual_seed(5),
                    dtype=torch.float64)
    if family == "fused":
        target = render_eager(truth, cfg)
        step, twin = fused.loss_grad_fused_plain, fused.loss_grad_adjoint_eager
        vis = fused.render_fused_plain(start, cfg)[1]
        bwd_ref = fused.render_fused_bwd_plain(start, cfg, g)
        bwd = fused.render_bwd_adjoint_eager(start, cfg, g, vis)
    else:
        target = render_eager_vec(truth, cfg)
        step, twin = fused_vec.loss_grad_vec_plain, fused_vec.loss_grad_vec_adjoint_eager
        vis = fused_vec.render_vec_culled(start, cfg)[1]
        bwd_ref = fused_vec.render_vec_bwd_plain(start, cfg, g)
        bwd = fused_vec.render_vec_bwd_adjoint_eager(start, cfg, g, vis)
    l_r, g_r = step(start, cfg, target)
    l_t, g_t = twin(start, cfg, target)
    assert float(l_r) > 0.0 and abs(float(l_t) - float(l_r)) <= 1e-9 * float(l_r)
    _close(g_r, g_t)
    _close(bwd_ref, bwd)
    texels = [leaf for leaf in (g_t.spheres.texture, g_t.rects.texture, g_t.env) if leaf.numel()]
    assert texels and all(bool(t.abs().sum() > 0) for t in texels)


# The leaves held to the oracle's central differences: texel grids and mirror
# coefficients, on which the render is smooth away from the clip.
FD_LEAVES = ("spheres.texture", "rects.texture", "env", "spheres.material.mirror",
             "rects.material.mirror")


@pytest.mark.parametrize("name, family", [("config7", "fused"), ("config9", "fused"),
                                          ("config8_r1", "vec")])
def test_spp4_twins_match_oracle_differences(name, family):
    """The step's and the render backward's twins at spp 4 against central
    differences (step 1e-5) of the f64 oracle's spp 4: of its mse against
    the truth's oracle image, and of its image's sum against a cotangent,
    on the three largest entries of each texel and mirror leaf."""
    scene, cfg = _case(name)
    start = _start(scene, name)
    target = _oracle_spp4(_f64(scene), cfg)
    g = torch.randn((SIZE, SIZE, 3), generator=torch.Generator().manual_seed(5),
                    dtype=torch.float64)
    if family == "fused":
        g_step = fused.loss_grad_adjoint_eager(start, cfg, torch.from_numpy(target))[1]
        g_bwd = fused.render_bwd_adjoint_eager(start, cfg, g,
                                               fused.render_fused_plain(start, cfg)[1])
    else:
        g_step = fused_vec.loss_grad_vec_adjoint_eager(start, cfg, torch.from_numpy(target))[1]
        g_bwd = fused_vec.render_vec_bwd_adjoint_eager(start, cfg, g,
                                                       fused_vec.render_vec_culled(start, cfg)[1])
    funcs = ((g_step, lambda img: float(((img - target) ** 2).mean())),
             (g_bwd, lambda img: float((img * g.numpy()).sum())))
    leaves, h, checked = tree_leaves(start), 1e-5, 0
    for k, path in enumerate(leaf_paths(start)):
        if path not in FD_LEAVES or not leaves[k].numel():
            continue
        for grads, f in funcs:
            want = tree_leaves(grads)[k].reshape(-1)
            scale = float(want.abs().max())
            if scale == 0.0:  # a mirror without a bounce
                continue
            for i in torch.argsort(want.abs(), descending=True)[:3].tolist():
                vals = []
                for sign in (1.0, -1.0):
                    moved = leaves[k].clone().reshape(-1)
                    moved[i] += sign * h
                    scene_i = tree_unflatten(start, [*leaves[:k], moved.reshape(leaves[k].shape),
                                                     *leaves[k + 1:]])
                    vals.append(f(_oracle_spp4(scene_i, cfg)))
                fd = (vals[0] - vals[1]) / (2.0 * h)
                assert abs(fd - float(want[i])) <= 1e-5 * scale, (path, i)
                checked += 1
    assert checked >= 6  # a texel grid or the env, both functions, at least


def test_spp4_soft_render_of_config8():
    """The soft render at spp 4 is the average of its four offset renders
    (each as the soft render of one subsample), and differentiable in the
    texels."""
    scene, _, cfg = configs.config8_globe(SIZE, device="cpu")
    cfg = dataclasses.replace(cfg, spp=4, soft_tau=0.08)
    fused_vec_soft.check_soft_kernel_config(scene, cfg)
    img = fused_vec_soft.render_vec_soft(scene, cfg)
    cfg1 = dataclasses.replace(cfg, spp=1)
    subs = [torch.stack(shade_soft(scene, *pl.primary_rays(scene, cfg1, off), cfg1,
                                   (SIZE, SIZE)), dim=-1) for off in pl.SPP_OFFSETS[4]]
    assert torch.equal(img, fused.subsample_average(subs))
    assert not torch.equal(img, subs[0])
    tex = scene.spheres.texture.clone().requires_grad_(True)
    moved = dataclasses.replace(scene, spheres=dataclasses.replace(scene.spheres, texture=tex))
    (fused_vec_soft.render_vec_soft(moved, cfg) ** 2).mean().backward()
    assert bool(torch.isfinite(tex.grad).all()) and float(tex.grad.abs().sum()) > 0.0


@pytest.mark.parametrize("name", ["config6", "config7", "config8", "config9", "config10",
                                  "config8_r1", "globes_r1"])
def test_spp4_checks_cover_and_refuse_by_name(name):
    """The kernels' checks at spp 4: the family the card takes covers the
    pair and two or three bounces; four stay refused in both hard families;
    the soft render takes a texel grid at spp 4, the soft step does not; the
    soft checker beside a texel grid stays refused."""
    scene, cfg = _case(name)
    n = scene.spheres.count + scene.rects.count
    if n <= fused.MAX_OBJECTS and not (cfg.reflections and fused_vec.object_textured(scene)):
        fused.check_kernel_config(scene, cfg)
    fused_vec.check_vec_kernel_config(scene, cfg)
    for refl in (2, 3):  # two and three bounces: where one is covered
        more = dataclasses.replace(cfg, reflections=refl)
        if n <= fused.MAX_OBJECTS and not fused_vec.object_textured(scene):
            fused.check_kernel_config(scene, more)
        fused_vec.check_vec_kernel_config(scene, more)
    two = dataclasses.replace(cfg, reflections=4)
    with pytest.raises(NotImplementedError, match="reflections > 3"):
        fused.check_kernel_config(scene, two)
    with pytest.raises(NotImplementedError, match="reflections > 3"):
        fused_vec.check_vec_kernel_config(scene, two)
    soft = dataclasses.replace(cfg, soft_tau=0.08, reflections=0)
    if fused.scene_textured(scene):
        fused_vec_soft.check_soft_kernel_config(scene, soft)
        with pytest.raises(NotImplementedError, match="spp=4 in the soft step"):
            fused_vec_soft.check_soft_kernel_config(scene, soft, step=True)
        with pytest.raises(NotImplementedError, match="the soft checker"):
            fused_vec_soft.check_soft_kernel_config(
                scene, dataclasses.replace(soft, checker_tau=0.5))
