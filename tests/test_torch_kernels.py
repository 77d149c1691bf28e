"""The CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one. Nothing here imports
JAX: on the card run them with
``python -m pytest --noconftest tests/test_torch_kernels.py``, which skips
the JAX set-up that tests/conftest.py does for the other test files.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.models.scene import leaf_paths, tree_leaves
from reversible_raytracer_tpu_torch.models.scene import tree_map, tree_unflatten
from reversible_raytracer_tpu_torch.ops import pipeline
from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec, fused_vec_soft
from reversible_raytracer_tpu_torch.ops.pipeline import RenderConfig
from reversible_raytracer_tpu_torch.ops.pipeline_vec import nearest_vec
from reversible_raytracer_tpu_torch.ops.render import loss_and_grad_fn, render, resolve_impl


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six test
    processes at once, and torch's default of a thread per core slows this
    file and the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _hit(scene, cfg):
    o, d = pipeline.primary_rays(scene, cfg)
    return pipeline.trace_nearest(scene, o, d, cfg.shape)[1]


def _render_bit_identical(scene, cfg):
    """Row 2 against `render_fused_plain`: the image bit for bit, the planes
    on hit pixels bit for bit and 0 where the ray hits nothing (the plain
    version's planes hold the shadow test of a ray from the BIG sentinel
    there, which nothing reads); one launch a call, three calls the same
    bits. Returns the kernel's planes."""
    before = fused.FUSED_RENDER.launches
    runs = [fused.render_fused(scene, cfg) for _ in range(3)]
    assert fused.FUSED_RENDER.launches == before + 3
    assert all(torch.equal(runs[0][0], r[0]) and torch.equal(runs[0][1], r[1]) for r in runs[1:])
    img_k, vis_k = runs[0]
    img_p, vis_p = fused.render_fused_plain(scene, cfg)
    assert vis_k.shape == vis_p.shape == (pipeline.n_vis_planes(scene, cfg), cfg.height,
                                          cfg.width)
    assert torch.equal(img_k, img_p)
    hit = _hit(scene, cfg)
    assert torch.equal(vis_k[:, hit], vis_p[:, hit])
    assert not vis_k[:, ~hit].any()
    return vis_k


@pytest.mark.cuda
@pytest.mark.parametrize("num, H, W", [(1, 64, 64), (2, 128, 160), (3, 96, 72)])
def test_render_kernel_matches_plain(cuda, num, H, W):
    """Row 2 against its plain version at small sizes of configs 1-3 (config
    1 without shadows, so without planes): the image bit for bit, the planes
    on hit pixels bit for bit and 0 on a miss (`_render_bit_identical`)."""
    scene, _, _ = configs.CONFIGS[num](device=cuda)
    cfg = RenderConfig(height=H, width=W, shadows=num != 1)
    _render_bit_identical(scene, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("num, loss", [(1, "sum"), (2, "mse"), (3, "mse")])
def test_step_kernel_matches_adjoint(cuda, num, loss):
    """Loss within 1e-4 relative, every leaf within 1e-2 of its scale,
    against the eager hand-written adjoint and against autograd."""
    scene, spec, _ = configs.CONFIGS[num](device=cuda)
    cfg = RenderConfig(height=96, width=120, shadows=num != 1)
    start = configs.perturb(scene, spec, scale=0.1, seed=4)
    target = fused.render_fused_plain(scene, cfg)[0]
    before = fused.FUSED_STEP.launches
    l_k, g_k = fused.loss_grad_fused(start, cfg, target, loss)
    assert fused.FUSED_STEP.launches == before + 1
    for ref in (fused.loss_grad_adjoint_eager, fused.loss_grad_fused_plain):
        l_r, g_r = ref(start, cfg, target, loss)
        assert abs(float(l_k) - float(l_r)) <= 1e-4 * float(l_r)
        for path, a, b in zip(leaf_paths(g_r), tree_leaves(g_r), tree_leaves(g_k)):
            if a.numel():
                a, b = a.cpu().numpy(), b.cpu().numpy()
                scale = max(np.abs(a).max(), 1e-6)
                np.testing.assert_allclose(b, a, atol=1e-2 * scale, rtol=0, err_msg=path)


@pytest.mark.cuda
def test_step_kernel_is_deterministic(cuda):
    scene, spec, cfg = configs.config2_four_spheres(size=200, device=cuda)
    start = configs.perturb(scene, spec, scale=0.1, seed=1)
    target = fused.render_fused(scene, cfg)[0]
    runs = [fused.loss_grad_fused(start, cfg, target) for _ in range(3)]
    flat = [torch.cat([l.reshape(1), fused.flatten_scene(g)]) for l, g in runs]
    assert all(torch.equal(flat[0], f) for f in flat[1:])


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_cover(cuda):
    scene, _, cfg = configs.config2_four_spheres(size=32, device=cuda)
    with pytest.raises(NotImplementedError, match="spp=2"):
        fused.render_fused(scene, RenderConfig(height=32, width=32, spp=2))
    with pytest.raises(ValueError):
        fused.loss_grad_fused(scene, cfg, torch.zeros((32, 32, 3), device=cuda, dtype=torch.float64))


def _close_leaves(g_ref, g_got, rel=1e-2):
    for path, a, b in zip(leaf_paths(g_ref), tree_leaves(g_ref), tree_leaves(g_got)):
        if a.numel():
            a, b = a.cpu().numpy(), b.cpu().numpy()
            scale = max(np.abs(a).max(), 1e-6)
            np.testing.assert_allclose(b, a, atol=rel * scale, rtol=0, err_msg=path)


@pytest.mark.cuda
@pytest.mark.parametrize("n_spheres, H, W", [(64, 128, 160), (200, 96, 96)])
def test_vec_render_kernel_matches_plain(cuda, n_spheres, H, W):
    """The object-chunked forward kernel against `render_vec_plain`: the
    oracle rule on the image, visibility planes on hit pixels."""
    scene, _, _ = configs.config5_many_spheres(n_spheres=n_spheres, device=cuda)
    cfg = RenderConfig(height=H, width=W, shadows=True)
    before = fused_vec.VEC_RENDER.launches
    img_k, vis_k = fused_vec.render_vec(scene, cfg)
    assert fused_vec.VEC_RENDER.launches == before + 1
    img_p, vis_p = fused_vec.render_vec_plain(scene, cfg)
    err = (img_k - img_p).abs()
    assert float((err > 2e-3).float().mean()) < 1e-3
    assert float(err.mean()) < 1e-4
    assert vis_k.shape == vis_p.shape == (1, H, W)
    o, d = pipeline.primary_rays(scene, cfg)
    hit = nearest_vec(scene, o, d)[1] >= 0
    assert float((vis_k != vis_p)[:, hit].float().mean()) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["mse", "sum"])
def test_vec_step_kernel_matches_adjoint(cuda, loss):
    """Loss within 1e-4 relative, every leaf within 1e-2 of its scale,
    against the eager hand-written adjoint and against autograd; pad rows
    and untrained columns come back as exact zeros."""
    scene, spec, _ = configs.config5_many_spheres(device=cuda)
    cfg = RenderConfig(height=96, width=120, shadows=True)
    start = configs.perturb(scene, spec, scale=0.05, seed=4)
    target = fused_vec.render_vec_plain(scene, cfg)[0]
    before = fused_vec.VEC_STEP.launches
    l_k, g_k = fused_vec.loss_grad_vec(start, cfg, target, loss)
    assert fused_vec.VEC_STEP.launches == before + 1
    for ref in (fused_vec.loss_grad_vec_adjoint_eager, fused_vec.loss_grad_vec_plain):
        l_r, g_r = ref(start, cfg, target, loss)
        assert abs(float(l_k) - float(l_r)) <= 1e-4 * float(l_r)
        _close_leaves(g_r, g_k)
    for leaf in (g_k.spheres.material.checker, g_k.spheres.material.mirror,
                 g_k.rects.material.checker_scale, g_k.rects.material.mirror):
        assert not leaf.any()


@pytest.mark.cuda
def test_vec_step_kernel_is_deterministic(cuda):
    scene, spec, cfg = configs.config5_many_spheres(size=200, device=cuda)
    start = configs.perturb(scene, spec, scale=0.05, seed=1)
    target = fused_vec.render_vec(scene, cfg)[0]
    runs = [fused_vec.loss_grad_vec(start, cfg, target) for _ in range(3)]
    flat = [torch.cat([l.reshape(1), fused.flatten_scene(g)]) for l, g in runs]
    assert all(torch.equal(flat[0], f) for f in flat[1:])


# (family, config number, soft_tau): the three render backward kernels
BWD_CASES = [("fused", 2, 0.0), ("vec", 5, 0.0), ("soft", 5, 0.05)]


def _bwd_case(cuda, num, tau, size=64):
    scene, spec, _ = configs.CONFIGS[num](size=size, device=cuda)
    cfg = RenderConfig(height=size, width=size + 16, shadows=True, soft_tau=tau)
    return scene, configs.perturb(scene, spec, scale=0.05, seed=4), cfg


def _bwd_kernel(family):
    return {"fused": fused.FUSED_RENDER_BWD, "vec": fused_vec.VEC_RENDER_BWD,
            "soft": fused_vec_soft.SOFT_RENDER_BWD}[family]


def _bwd_call(family, scene, cfg, g):
    """The family's backward kernel, reached through autograd of `render`,
    and its plain version for cotangent g."""
    plain = {"fused": fused.render_fused_bwd_plain, "vec": fused_vec.render_vec_bwd_plain,
             "soft": fused_vec_soft.render_vec_soft_bwd_plain}[family]
    return fused.autograd_vjp(render, scene, cfg, g), plain(scene, cfg, g)


@pytest.mark.cuda
@pytest.mark.parametrize("family, num, tau", BWD_CASES)
def test_render_bwd_kernel_matches_plain(cuda, family, num, tau):
    """Each render backward kernel against autograd of its family's eager
    render, for a seeded cotangent: every leaf within 1e-2 of its scale;
    two calls bit-identical."""
    _, start, cfg = _bwd_case(cuda, num, tau)
    g = torch.from_numpy(np.random.default_rng(0).normal(
        size=(cfg.height, cfg.width, 3)).astype(np.float32)).to(cuda)
    kernel = _bwd_kernel(family)
    before = kernel.launches
    got, ref = _bwd_call(family, start, cfg, g)
    assert kernel.launches == before + 1
    _close_leaves(ref, got)
    again = _bwd_call(family, start, cfg, g)[0]
    assert torch.equal(fused.flatten_scene(got), fused.flatten_scene(again))


@pytest.mark.cuda
@pytest.mark.parametrize("family, num, tau", BWD_CASES)
def test_cuda_render_carries_the_gradient(cuda, family, num, tau):
    """`render` of a scene that requires grad is differentiable on the card:
    one backward launch per backward, the mse gradient the step kernel's
    (1e-2 of each leaf's scale), an expanded cotangent (``sum()``) the same
    bits as its contiguous copy, and no gradient work under no_grad."""
    scene, start, cfg = _bwd_case(cuda, num, tau)
    target = render(scene, cfg)
    kernel = _bwd_kernel(family)
    leaves = [l.clone().requires_grad_(True) for l in tree_leaves(start)]
    img = render(tree_unflatten(start, leaves), cfg)
    before = kernel.launches
    ((img - target) ** 2).mean().backward()
    assert kernel.launches == before + 1
    got = tree_unflatten(start, [torch.zeros_like(l) if l.grad is None else l.grad
                                 for l in leaves])
    _close_leaves(loss_and_grad_fn(start, cfg)(start, target)[1], got)
    for l in leaves:
        l.grad = None
    render(tree_unflatten(start, leaves), cfg).sum().backward()
    ones = _bwd_call(family, start, cfg, torch.ones((cfg.height, cfg.width, 3), device=cuda))[0]
    assert torch.equal(torch.cat([l.grad.reshape(-1) for l in leaves]),
                       fused.flatten_scene(ones))
    with torch.no_grad():
        img = render(tree_unflatten(start, leaves), cfg)
    assert img.grad_fn is None
    torch.testing.assert_close(img, render(start, cfg), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_spheres, H, W, tau", [(64, 128, 160, 0.08), (200, 96, 96, 0.01)])
def test_soft_render_kernel_matches_plain(cuda, n_spheres, H, W, tau):
    """The soft forward kernel against `render_vec_soft_plain`, by the
    oracle rule."""
    scene, _, _ = configs.config5_many_spheres(n_spheres=n_spheres, device=cuda)
    cfg = RenderConfig(height=H, width=W, shadows=True, soft_tau=tau)
    before = fused_vec_soft.SOFT_RENDER.launches
    img_k = fused_vec_soft.render_vec_soft(scene, cfg)
    assert fused_vec_soft.SOFT_RENDER.launches == before + 1
    err = (img_k - fused_vec_soft.render_vec_soft_plain(scene, cfg)).abs()
    assert float((err > 2e-3).float().mean()) < 1e-3
    assert float(err.mean()) < 1e-4
    assert resolve_impl(scene, cfg) == "cuda_vec_soft"


@pytest.mark.cuda
@pytest.mark.parametrize("loss, shadows", [("mse", True), ("sum", False)])
def test_soft_step_kernel_matches_adjoint(cuda, loss, shadows):
    """Loss within 1e-4 relative, every leaf within 1e-2 of its scale,
    against the eager hand-written adjoint and against autograd; two calls
    bit-identical; pad rows' and untrained columns' gradients exactly 0."""
    scene, spec, _ = configs.config5_many_spheres(device=cuda)
    cfg = RenderConfig(height=96, width=120, shadows=shadows, soft_tau=0.05)
    start = configs.perturb(scene, spec, scale=0.05, seed=4)
    target = fused_vec_soft.render_vec_soft_plain(scene, cfg)
    before = fused_vec_soft.SOFT_STEP.launches
    l_k, g_k = fused_vec_soft.loss_grad_vec_soft(start, cfg, target, loss)
    assert fused_vec_soft.SOFT_STEP.launches == before + 1
    for ref in (fused_vec_soft.loss_grad_vec_soft_adjoint_eager,
                fused_vec_soft.loss_grad_vec_soft_plain):
        l_r, g_r = ref(start, cfg, target, loss)
        assert abs(float(l_k) - float(l_r)) <= 1e-4 * float(l_r)
        _close_leaves(g_r, g_k)
    l_2, g_2 = fused_vec_soft.loss_grad_vec_soft(start, cfg, target, loss)
    assert torch.equal(fused.flatten_scene(g_k), fused.flatten_scene(g_2))
    for leaf in (g_k.spheres.material.checker, g_k.spheres.material.mirror,
                 g_k.rects.material.checker_scale):
        assert not leaf.any()


@pytest.mark.cuda
def test_soft_kernels_refuse(cuda):
    """The soft step (row 9) refuses spp 4 by name, as the JAX package's
    does; the render (rows 7-8) refuses spp 2, in a render that would need
    the backward."""
    scene, _, _ = configs.config5_many_spheres(size=32, device=cuda)
    spp4 = RenderConfig(height=32, width=32, spp=4, soft_tau=0.05)
    with pytest.raises(NotImplementedError, match="spp=4 in the soft step"):
        fused_vec_soft.loss_grad_vec_soft(scene, spp4, torch.zeros((32, 32, 3), device=cuda))
    leaves = [l.clone().requires_grad_(True) for l in tree_leaves(scene)]
    with pytest.raises(NotImplementedError, match="spp=2"):
        render(tree_unflatten(scene, leaves), dataclasses.replace(spp4, spp=2))


# ---------------------------------------------------------------------------
# The shadow cull of rows 8 and 9 (csrc/soft_step.cuh)
# ---------------------------------------------------------------------------


def _with_spheres(scene, centres, radii):
    """The scene with more spheres (sphere 0's material) at the end."""
    sp = scene.spheres
    k = len(radii)
    more = lambda x: torch.cat([x, x[:1].expand(k, *x.shape[1:])])  # noqa: E731
    mat = dataclasses.replace(sp.material, **{f.name: more(getattr(sp.material, f.name))
                                              for f in dataclasses.fields(sp.material)})
    return dataclasses.replace(scene, spheres=type(sp)(
        center=torch.cat([sp.center, torch.stack(centres)]),
        radius=torch.cat([sp.radius, torch.tensor(radii, device=sp.radius.device)]),
        material=mat, texture=more(sp.texture)))


def _bound_scene(scene, cfg):
    """Config 5 with spheres at the edges of the cull: for several warps (32
    pixels of a row) of the first layer, one sphere of radius 0.1 at (R +
    rho)(1 - 1%) and one at (R + rho)(1 + 1%) from the warp's segment [c_w,
    light] (R = r sqrt(1 + 18 tau), the warp's test), and one at R (1 - 1%)
    and one at R (1 + 1%) from its farthest pixel's shadow segment (the
    per-pixel rule), each placed off the far side of the segment."""
    tau = cfg.soft_tau
    zero = torch.zeros((cfg.height, cfg.width), device=scene.device)
    ray = fused.primary_ray_terms(scene, cfg)
    k = fused_vec_soft.two_layers(scene, ray.o, ray.d, tau)[0][1]
    y = fused_vec_soft._layer(scene, cfg, ray, k, tau, zero)
    lpos = scene.lights.position[0]
    radius = 0.1
    R = radius * math.sqrt(1.0 + fused_vec_soft.SOFT_CULL[torch.float32] * tau)
    centres = []
    for row in range(cfg.height // 8, cfg.height, cfg.height // 4):
        for run in range(cfg.width // 32):
            cols = slice(32 * run, 32 * run + 32)
            live = y.hit[row, cols]
            if int(live.sum()) < 2:
                continue
            so = torch.stack([x[row, cols] for x in y.so], dim=-1)[live]
            cw = (so.amin(0) + so.amax(0)) * 0.5
            dist2 = ((so - cw) ** 2).sum(-1)
            far, rho = so[torch.argmax(dist2)], float(torch.sqrt(dist2.max()))
            for start, reach in ((cw, R + rho), (far, R)):
                seg = lpos - start
                u = seg / torch.linalg.norm(seg)
                away = (far - cw) - u * torch.dot(far - cw, u)
                away = away / max(float(torch.linalg.norm(away)), 1e-12)
                for f in (0.99, 1.01):
                    centres.append(start + seg * 0.3 + away * (reach * f))
    assert len(centres) >= 8
    return _with_spheres(scene, centres, [radius] * len(centres))


@pytest.mark.cuda
@pytest.mark.parametrize("tau, bound_spheres", [(0.05, False), (0.01, False), (0.08, True)])
def test_soft_step_forward_is_the_soft_forward(cuda, tau, bound_spheres):
    """Row 9 against row 7's image of the same scene: a loss of exactly 0 and
    every gradient exactly 0, so the step's culled shadow products are the
    forward's unculled ones to the bit; with ``bound_spheres`` on a scene
    with spheres at the edges of the warp test and of the per-pixel rule,
    where the step is also held to its eager twin (1e-3 of each leaf's
    scale) and row 8 to the twin of the backward."""
    scene, _, _ = configs.config5_many_spheres(device=cuda)
    cfg = RenderConfig(height=64, width=96, shadows=True, soft_tau=tau)
    if bound_spheres:
        scene = _bound_scene(scene, cfg)
    img = fused_vec_soft.render_vec_soft(scene, cfg)
    l_0, g_0 = fused_vec_soft.loss_grad_vec_soft(scene, cfg, img)
    assert float(l_0) == 0.0
    assert not fused.flatten_scene(g_0).any()
    if bound_spheres:
        start = tree_unflatten(scene, [l + 0.01 * torch.sin(torch.arange(l.numel(), device=cuda)
                                                            ).reshape(l.shape)
                                       if l.is_floating_point() else l
                                       for l in tree_leaves(scene)])
        target = fused_vec_soft.render_vec_soft_plain(scene, cfg)
        _close_leaves(fused_vec_soft.loss_grad_vec_soft_adjoint_eager(start, cfg, target)[1],
                      fused_vec_soft.loss_grad_vec_soft(start, cfg, target)[1], rel=1e-3)
        g = torch.from_numpy(np.random.default_rng(0).normal(
            size=(cfg.height, cfg.width, 3)).astype(np.float32)).to(cuda)
        _close_leaves(fused_vec_soft.render_vec_soft_bwd_adjoint_eager(start, cfg, g),
                      fused.autograd_vjp(render, start, cfg, g), rel=1e-3)


@pytest.mark.cuda
def test_soft_kernels_match_the_twins_at_513_objects(cuda):
    """Rows 9 and 8 at bench.py's 513-object shape, 128^2, against their
    eager twins (1e-3 of each leaf's scale), and bit-identical twice."""
    scene, spec, _ = configs.config5_many_spheres(n_spheres=512, device=cuda)
    cfg = RenderConfig(height=128, width=128, shadows=True, soft_tau=0.08)
    start = configs.perturb(scene, spec, scale=0.05, seed=4)
    target = fused_vec_soft.render_vec_soft_plain(scene, cfg)
    l_k, g_k = fused_vec_soft.loss_grad_vec_soft(start, cfg, target)
    l_a, g_a = fused_vec_soft.loss_grad_vec_soft_adjoint_eager(start, cfg, target)
    assert abs(float(l_k) - float(l_a)) <= 1e-4 * float(l_a)
    _close_leaves(g_a, g_k, rel=1e-3)
    assert torch.equal(fused.flatten_scene(g_k),
                       fused.flatten_scene(fused_vec_soft.loss_grad_vec_soft(start, cfg,
                                                                             target)[1]))
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=(cfg.height, cfg.width, 3)).astype(np.float32)).to(cuda)
    _close_leaves(fused_vec_soft.render_vec_soft_bwd_adjoint_eager(start, cfg, g),
                  fused.autograd_vjp(render, start, cfg, g), rel=1e-3)


@pytest.mark.cuda
def test_soft_kernels_at_the_shared_memory_limit(cuda):
    """Rows 9 and 8 at the most spheres a block's shared memory holds, where
    a warp keeps the fewest prefix slots and rebuilds them most: the step
    against row 7's image (a loss of exactly 0, gradients exactly 0), both
    against their eager twins (1e-3 of each leaf's scale), bit-identical
    twice; 16 spheres more are refused with the numbers. With the H100's
    227 KB a block takes at least 784 spheres and a rect."""
    n = fused_vec_soft.most_spheres()
    if fused_vec.VEC_RENDER.lib().rrt_smem_optin() >= 232448:
        assert n >= 784
    scene, spec, _ = configs.config5_many_spheres(n_spheres=n, device=cuda)
    cfg = RenderConfig(height=64, width=96, shadows=True, soft_tau=0.08)
    l_0, g_0 = fused_vec_soft.loss_grad_vec_soft(scene, cfg,
                                                 fused_vec_soft.render_vec_soft(scene, cfg))
    assert float(l_0) == 0.0
    assert not fused.flatten_scene(g_0).any()
    start = configs.perturb(scene, spec, scale=0.05, seed=4)
    target = fused_vec_soft.render_vec_soft_plain(scene, cfg)
    l_k, g_k = fused_vec_soft.loss_grad_vec_soft(start, cfg, target)
    l_a, g_a = fused_vec_soft.loss_grad_vec_soft_adjoint_eager(start, cfg, target)
    assert abs(float(l_k) - float(l_a)) <= 1e-4 * float(l_a)
    _close_leaves(g_a, g_k, rel=1e-3)
    assert torch.equal(fused.flatten_scene(g_k),
                       fused.flatten_scene(fused_vec_soft.loss_grad_vec_soft(start, cfg,
                                                                             target)[1]))
    g = torch.from_numpy(np.random.default_rng(2).normal(
        size=(cfg.height, cfg.width, 3)).astype(np.float32)).to(cuda)
    _close_leaves(fused_vec_soft.render_vec_soft_bwd_adjoint_eager(start, cfg, g),
                  fused.autograd_vjp(render, start, cfg, g), rel=1e-3)
    more, _, _ = configs.config5_many_spheres(n_spheres=n + 16, device=cuda)
    with pytest.raises(NotImplementedError, match="bytes of shared memory"):
        fused_vec_soft.loss_grad_vec_soft(more, cfg, target)


# ---------------------------------------------------------------------------
# The per-warp culls of rows 5 and 6 (csrc/vec_step.cuh, csrc/cull.cuh)
# ---------------------------------------------------------------------------


def _vec_zero_residual(scene, cfg):
    """Row 6 against row 4's image of the same scene: a loss of exactly 0
    and every gradient exactly 0, so the step's culled walks gave every
    pixel row 4's winner, t and visibility, bit for bit."""
    img = fused_vec.render_vec(scene, cfg)[0].detach()
    l_0, g_0 = fused_vec.loss_grad_vec(scene, cfg, img)
    assert float(l_0) == 0.0
    assert not fused.flatten_scene(g_0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [None, 0, 1, 2])
def test_vec_step_forward_is_the_vec_forward_at_a_ragged_size(cuda, seed):
    """At 200x333 the last warp of each row has 13 live lanes and the last
    tile row 0 of 8 dead rows: the true scene and perturb seeds 0-2."""
    scene, spec, _ = configs.config5_many_spheres(device=cuda)
    if seed is not None:
        scene = configs.perturb(scene, spec, scale=0.05, seed=seed)
    _vec_zero_residual(scene, RenderConfig(height=200, width=333, shadows=True))


def _cull_edge_scene(scene, cfg):
    """Config 5 with spheres at the edges of the culls: for pixels on both
    sides of warp boundaries (columns 32 k - 1 and 32 k), one sphere of
    radius 0.15 whose centre lies 0.999 r and one 1.001 r off the pixel's
    primary ray (a grazing limb, straddling two warps), and two the same
    distances off its shadow ray toward the light, a third of the way along
    it."""
    ray = fused.primary_ray_terms(scene, cfg)
    t, k = nearest_vec(scene, ray.o, ray.d)
    zero = torch.zeros((cfg.height, cfg.width), device=scene.device)
    w = fused.winner_surface(scene, fused.winner_geometry(scene, k, zero), ray.o, ray.d, t, zero)
    so = pipeline.shadow_origin(ray.o, ray.d, t, w.n)
    lpos = scene.lights.position[0]
    radius, eye = 0.15, scene.camera.eye
    centres = []
    for i in range(cfg.height // 6, cfg.height, cfg.height // 3):
        for j in range(31, cfg.width - 1, 64):
            for jj in (j, j + 1):
                d = torch.stack([x[i, jj] for x in ray.d])
                off = torch.linalg.cross(d, torch.tensor([0.0, 1.0, 0.0], device=d.device))
                off = off / torch.linalg.norm(off)
                for f in (0.999, 1.001):
                    centres.append(eye + d * 6.0 + off * (radius * f))
                if int(k[i, jj]) >= 0:
                    o = torch.stack([x[i, jj] for x in so])
                    seg = lpos - o
                    u = seg / torch.linalg.norm(seg)
                    side = torch.linalg.cross(u, off)
                    side = side / torch.linalg.norm(side)
                    for f in (0.999, 1.001):
                        centres.append(o + seg / 3.0 + side * (radius * f))
    assert len(centres) >= 16
    return _with_spheres(scene, centres, [radius] * len(centres))


@pytest.mark.cuda
def test_vec_kernels_at_the_edges_of_the_culls(cuda):
    """Spheres straddling warp boundaries and grazing the limb of a pixel's
    primary or shadow ray: row 6 against row 4's image (a loss and gradient
    of exactly 0), and rows 6 and 5 against their eager twins, which walk
    the same candidates (1e-2 of each leaf's scale)."""
    scene, _, _ = configs.config5_many_spheres(device=cuda)
    cfg = RenderConfig(height=96, width=160, shadows=True)
    scene = _cull_edge_scene(scene, cfg)
    _vec_zero_residual(scene, cfg)
    start = tree_unflatten(scene, [l + 0.01 * torch.sin(torch.arange(l.numel(), device=cuda)
                                                        ).reshape(l.shape)
                                   if l.is_floating_point() else l
                                   for l in tree_leaves(scene)])
    target = fused_vec.render_vec_plain(scene, cfg)[0]
    _close_leaves(fused_vec.loss_grad_vec_adjoint_eager(start, cfg, target)[1],
                  fused_vec.loss_grad_vec(start, cfg, target)[1])
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(cfg.height, cfg.width, 3)).astype(np.float32)).to(cuda)
    vis = fused_vec.render_vec(start, cfg)[1]
    _close_leaves(fused_vec.render_vec_bwd_adjoint_eager(start, cfg, g, vis),
                  fused.autograd_vjp(render, start, cfg, g))


@pytest.mark.cuda
def test_vec_kernels_at_the_shared_memory_limit(cuda):
    """Rows 6 and 5 at the most spheres a block's shared memory holds (read
    from the card: at least the 1520 of the layout before the culls, with
    the H100's 227 KB): row 6 against row 4's image (exactly 0), against
    its eager twin (1e-2 of each leaf's scale), bit-identical twice; row 5
    against its plain version; 16 spheres more are refused with the
    numbers."""
    n = fused_vec.most_spheres()
    if fused_vec.VEC_RENDER.lib().rrt_smem_optin() >= 232448:
        assert n >= 1520
    scene, spec, _ = configs.config5_many_spheres(n_spheres=n, device=cuda)
    cfg = RenderConfig(height=64, width=96, shadows=True)
    _vec_zero_residual(scene, cfg)
    start = configs.perturb(scene, spec, scale=0.05, seed=4)
    target = fused_vec.render_vec_plain(scene, cfg)[0]
    l_k, g_k = fused_vec.loss_grad_vec(start, cfg, target)
    l_a, g_a = fused_vec.loss_grad_vec_adjoint_eager(start, cfg, target)
    assert abs(float(l_k) - float(l_a)) <= 1e-4 * float(l_a)
    _close_leaves(g_a, g_k)
    assert torch.equal(fused.flatten_scene(g_k),
                       fused.flatten_scene(fused_vec.loss_grad_vec(start, cfg, target)[1]))
    g = torch.from_numpy(np.random.default_rng(2).normal(
        size=(cfg.height, cfg.width, 3)).astype(np.float32)).to(cuda)
    got, ref = _bwd_call("vec", start, cfg, g)
    _close_leaves(ref, got)
    more, _, _ = configs.config5_many_spheres(n_spheres=n + 16, device=cuda)
    with pytest.raises(NotImplementedError, match="bytes of shared memory"):
        fused_vec.loss_grad_vec(more, cfg, target)


# ---------------------------------------------------------------------------
# Rows 1 and 3 on one cooperative launch (csrc/flat_step.cuh)
# ---------------------------------------------------------------------------


def _seeded(cfg, seed, device):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(cfg.height, cfg.width, 3)).astype(np.float32)).to(device)


def _flat_rows_hold(start, target, cfg, loss="mse", g_seed=0):
    """Row 1 against the eager adjoint and autograd (loss within 1e-4
    relative, every leaf within 1e-2 of its scale), one launch a call, the
    same bits over 3 calls; row 3 for a seeded cotangent against its plain
    version, one launch, the same bits twice; returns row 1's gradient."""
    before = fused.FUSED_STEP.launches
    runs = [fused.loss_grad_fused(start, cfg, target, loss) for _ in range(3)]
    assert fused.FUSED_STEP.launches == before + 3
    flat = [torch.cat([l.reshape(1), fused.flatten_scene(g)]) for l, g in runs]
    assert all(torch.equal(flat[0], f) for f in flat[1:])
    l_k, g_k = runs[0]
    for ref in (fused.loss_grad_adjoint_eager, fused.loss_grad_fused_plain):
        l_r, g_r = ref(start, cfg, target, loss)
        assert abs(float(l_k) - float(l_r)) <= 1e-4 * float(l_r)
        _close_leaves(g_r, g_k)
    g = _seeded(cfg, g_seed, start.device)
    before = fused.FUSED_RENDER_BWD.launches
    got, ref = _bwd_call("fused", start, cfg, g)
    again = _bwd_call("fused", start, cfg, g)[0]
    assert fused.FUSED_RENDER_BWD.launches == before + 2
    _close_leaves(ref, got)
    assert torch.equal(fused.flatten_scene(got), fused.flatten_scene(again))
    return g_k


@pytest.mark.cuda
@pytest.mark.parametrize("H, W", [(24, 40), (200, 333)])
def test_flat_kernels_at_the_grid_edges(cuda, H, W):
    """24x40 has 6 tiles, fewer than the grid's blocks on any card; at
    200x333 the last warp of each row has 13 live lanes and the last tile row
    0 of 8 dead rows. Rows 1 and 3 against their references, and row 3's mse
    gradient, by autograd of `render`, row 1's to the bit."""
    scene, spec, _ = configs.config2_four_spheres(device=cuda)
    cfg = RenderConfig(height=H, width=W, shadows=True)
    start = configs.perturb(scene, spec, scale=0.1, seed=4)
    target = fused.render_fused_plain(scene, cfg)[0]
    g_k = _flat_rows_hold(start, target, cfg)
    leaves = [l.clone().requires_grad_(True) for l in tree_leaves(start)]
    ((render(tree_unflatten(start, leaves), cfg) - target) ** 2).mean().backward()
    by_render = torch.cat([(torch.zeros_like(l) if l.grad is None else l.grad).reshape(-1)
                           for l in leaves])
    assert torch.equal(by_render, fused.flatten_scene(g_k))


def _crowded(scene, n_lights):
    """Config 3 (3 spheres, the ground) with 20 more spheres of radius 0.12
    in a 5x4 grid before it, so 24 objects, and ``n_lights`` lights on a
    ring above (2: config 3's own), every leaf moved off the true scene by
    0.01 sin(index)."""
    centres = [torch.tensor([-1.6 + 0.8 * c, -0.5 + 0.6 * r, 1.4], device=scene.ambient.device)
               for r in range(4) for c in range(5)]
    scene = _with_spheres(scene, centres, [0.12] * len(centres))
    if n_lights != scene.lights.count:
        a = torch.arange(n_lights, device=scene.ambient.device) * (2 * math.pi / n_lights)
        pos = torch.stack([4.0 * torch.cos(a), 4.0 + 0.1 * a, 4.0 * torch.sin(a)], dim=-1)
        scene = dataclasses.replace(scene, lights=type(scene.lights)(
            position=pos, color=torch.full((n_lights, 3), 0.9 / n_lights, device=pos.device)))
    start = tree_unflatten(scene, [l + 0.01 * torch.sin(torch.arange(l.numel(), device=l.device)
                                                        ).reshape(l.shape)
                                   if l.is_floating_point() else l
                                   for l in tree_leaves(scene)])
    return scene, start


@pytest.mark.cuda
@pytest.mark.parametrize("n_lights", [2, fused.MAX_LIGHTS])
def test_flat_kernels_at_the_most_objects(cuda, n_lights):
    """The largest flat scene the dispatch sends, 24 objects, with 2 lights
    and with the 16 that take the most shared memory (the lanes' light
    sums, past the 48 KB a block gets without opting in): rows 1 and 3
    against their references; 25 objects and 17 lights are refused."""
    scene, _, _ = configs.config3_multi_light(device=cuda)
    scene, start = _crowded(scene, n_lights)
    assert scene.spheres.count + scene.rects.count == fused.MAX_OBJECTS
    cfg = RenderConfig(height=72, width=104, shadows=True)
    target = fused.render_fused_plain(scene, cfg)[0]
    _flat_rows_hold(start, target, cfg, g_seed=1)
    more = _with_spheres(scene, [scene.spheres.center[0] * 0.5], [0.1])
    with pytest.raises(NotImplementedError, match="more than 24 objects"):
        fused.loss_grad_fused(more, cfg, target)
    many = dataclasses.replace(scene, lights=type(scene.lights)(
        position=scene.lights.position[:1].expand(fused.MAX_LIGHTS + 1, 3),
        color=scene.lights.color[:1].expand(fused.MAX_LIGHTS + 1, 3)))
    with pytest.raises(NotImplementedError, match="more than 16 lights"):
        fused.loss_grad_fused(many, cfg, target)


@pytest.mark.cuda
def test_flat_kernels_without_shadows_clip_or_mse(cuda):
    """shadows=False (no shadow rays, no planes), clip=False (the clip's
    gradient skipped) and loss 'sum': rows 1 and 3 against their
    references."""
    scene, spec, _ = configs.config3_multi_light(device=cuda)
    cfg = RenderConfig(height=64, width=96, shadows=False, clip=False)
    start = configs.perturb(scene, spec, scale=0.1, seed=2)
    target = fused.render_fused_plain(scene, cfg)[0]
    _flat_rows_hold(start, target, cfg, loss="sum", g_seed=2)


@pytest.mark.cuda
def test_flat_kernels_leave_no_state_in_their_scratch(cuda):
    """Two scenes stepped back to back through one scratch buffer, then the
    first again: the same bits as with a buffer of its own (the grid sync
    keeps nothing between calls, and no slot is read before it is
    written)."""
    scene, spec, _ = configs.config2_four_spheres(device=cuda)
    cfg = RenderConfig(height=120, width=200, shadows=True)
    target = fused.render_fused_plain(scene, cfg)[0]
    flat_a = fused._cuda_flat(configs.perturb(scene, spec, scale=0.1, seed=0), cfg)
    flat_b = fused._cuda_flat(configs.perturb(scene, spec, scale=0.1, seed=1), cfg)
    geom = fused._geometry(scene, cfg)
    stream = torch.cuda.current_stream().cuda_stream

    def step(flat, scratch):
        out = torch.empty((1 + flat.numel(),), device=cuda)
        fused.FUSED_STEP.call("rrt_step", flat.data_ptr(), *geom, target.data_ptr(),
                              1.0 / target.numel(), scratch.data_ptr(), out.data_ptr(), stream)
        return out

    n = fused.FUSED_STEP.lib().rrt_step_scratch_floats(*geom[:5])
    shared = torch.full((n,), float("nan"), device=cuda)
    first, other, again = step(flat_a, shared), step(flat_b, shared), step(flat_a, shared)
    alone = step(flat_a, torch.full((n,), 7.0, device=cuda))
    assert torch.equal(first, again) and torch.equal(first, alone)
    assert not torch.equal(first, other)


# ---------------------------------------------------------------------------
# The per-warp culls of the forwards, rows 4 and 7 (csrc/fused_vec_render.cu,
# csrc/fused_vec_soft_render.cu)
# ---------------------------------------------------------------------------


def _forwards_hold(scene, cfg, tau):
    """Row 4 against `render_vec_plain` (image and hit-pixel planes bit for
    bit, planes 0 on a miss) and row 7 at ``tau`` against
    `render_vec_soft_plain` (the oracle rule), each three calls
    bit-identical; rows 6 and 9 against the forwards' images give a loss
    and every gradient of exactly 0."""
    before = (fused_vec.VEC_RENDER.launches, fused_vec_soft.SOFT_RENDER.launches)
    vec = [fused_vec.render_vec(scene, cfg) for _ in range(3)]
    soft_cfg = dataclasses.replace(cfg, soft_tau=tau)
    soft = [fused_vec_soft.render_vec_soft(scene, soft_cfg) for _ in range(3)]
    assert (fused_vec.VEC_RENDER.launches, fused_vec_soft.SOFT_RENDER.launches) == (
        before[0] + 3, before[1] + 3)
    assert all(torch.equal(vec[0][0], v[0]) and torch.equal(vec[0][1], v[1]) for v in vec[1:])
    assert all(torch.equal(soft[0], s) for s in soft[1:])
    img_k, vis_k = vec[0]
    img_p, vis_p = fused_vec.render_vec_plain(scene, cfg)
    o, d = pipeline.primary_rays(scene, cfg)
    hit = nearest_vec(scene, o, d)[1] >= 0
    assert torch.equal(img_k, img_p)
    assert torch.equal(vis_k[:, hit], vis_p[:, hit])
    assert not vis_k[:, ~hit].any()
    err = (soft[0] - fused_vec_soft.render_vec_soft_plain(scene, soft_cfg)).abs()
    assert float((err > 2e-3).float().mean()) < 1e-3
    assert float(err.mean()) < 1e-4
    l_0, g_0 = fused_vec.loss_grad_vec(scene, cfg, img_k.detach())
    assert float(l_0) == 0.0 and not fused.flatten_scene(g_0).any()
    l_0, g_0 = fused_vec_soft.loss_grad_vec_soft(scene, soft_cfg, soft[0].detach())
    assert float(l_0) == 0.0 and not fused.flatten_scene(g_0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forwards_at_a_ragged_size(cuda, seed):
    """At 203x333 the last warp of each row has 13 live lanes and the last
    tile row 3 live rows of 8: rows 4 and 7 (tau 0.08) from perturb seeds
    0-2, without a hang."""
    scene, spec, _ = configs.config5_many_spheres(device=cuda)
    scene = configs.perturb(scene, spec, scale=0.05, seed=seed)
    _forwards_hold(scene, RenderConfig(height=203, width=333, shadows=True), 0.08)


@pytest.mark.cuda
def test_forwards_at_the_edges_of_the_culls(cuda):
    """Spheres straddling warp boundaries and grazing the limb of a pixel's
    primary or shadow ray (`_cull_edge_scene`): rows 4 and 7 (tau 0.01)."""
    scene, _, _ = configs.config5_many_spheres(device=cuda)
    cfg = RenderConfig(height=96, width=160, shadows=True)
    _forwards_hold(_cull_edge_scene(scene, cfg), cfg, 0.01)


@pytest.mark.cuda
def test_forwards_at_the_shared_memory_limit(cuda):
    """Rows 4 and 7 at the most spheres a block's shared memory holds (read
    from the card: at least the 3392 of the layout before the culls, with
    the H100's 227 KB), on a 64x96 image; 16 spheres more are refused with
    the numbers."""
    n = fused_vec.most_render_spheres()
    assert fused_vec_soft.most_render_spheres() == n  # one layout
    if fused_vec.VEC_RENDER.lib().rrt_smem_optin() >= 232448:
        assert n >= 3392
    scene, spec, _ = configs.config5_many_spheres(n_spheres=n, device=cuda)
    scene = configs.perturb(scene, spec, scale=0.05, seed=4)
    cfg = RenderConfig(height=64, width=96, shadows=True)
    img_k, vis_k = fused_vec.render_vec(scene, cfg)
    img_p, vis_p = fused_vec.render_vec_plain(scene, cfg)
    o, d = pipeline.primary_rays(scene, cfg)
    hit = nearest_vec(scene, o, d)[1] >= 0
    assert torch.equal(img_k, img_p) and torch.equal(vis_k[:, hit], vis_p[:, hit])
    soft_cfg = dataclasses.replace(cfg, soft_tau=0.08)
    err = (fused_vec_soft.render_vec_soft(scene, soft_cfg)
           - fused_vec_soft.render_vec_soft_plain(scene, soft_cfg)).abs()
    assert float((err > 2e-3).float().mean()) < 1e-3 and float(err.mean()) < 1e-4
    more, _, _ = configs.config5_many_spheres(n_spheres=n + 16, device=cuda)
    with torch.no_grad():
        with pytest.raises(NotImplementedError, match="bytes of shared memory"):
            fused_vec.render_vec(more, cfg)
        with pytest.raises(NotImplementedError, match="bytes of shared memory"):
            fused_vec_soft.render_vec_soft(more, soft_cfg)


# ---------------------------------------------------------------------------
# Row 2 redesigned (csrc/fused_render.cu): the camera once a block, no
# shading where the ray missed
# ---------------------------------------------------------------------------


def _row2_case(cuda, case):
    """(scene, cfg) of a row-2 case: config 2 or 3 from perturb(seed=4), the
    24-object `_crowded` scene with 2 or 16 lights, or 23 spheres of config
    5 and the ground."""
    name, H, W = case
    if name.startswith("crowded"):
        scene, _, _ = configs.config3_multi_light(device=cuda)
        scene = _crowded(scene, int(name[len("crowded"):]))[1]
    elif name == "many23":
        scene, spec, _ = configs.config5_many_spheres(n_spheres=23, device=cuda)
        scene = configs.perturb(scene, spec, scale=0.05, seed=4)
    else:
        scene, spec, _ = configs.CONFIGS[int(name[-1])](device=cuda)
        scene = configs.perturb(scene, spec, scale=0.1, seed=4)
    return scene, RenderConfig(height=H, width=W, shadows=True)


ROW2_CASES = [("config2", 512, 512), ("config3", 512, 512), ("crowded2", 200, 333),
              ("crowded16", 96, 128), ("many23", 256, 256), ("config2", 200, 333),
              ("config3", 57, 70)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ROW2_CASES, ids=["-".join(map(str, c)) for c in ROW2_CASES])
def test_render_kernel_bit_identical(cuda, case):
    """Row 2 bit for bit at configs 2 and 3 at 512^2, at the most objects
    (24, with 2 and with 16 lights, and 23 spheres of config 5 with its
    ground), at 200x333 (13 live lanes in the last warp of a row) and at
    57x70 (a ragged tile in both directions)."""
    scene, cfg = _row2_case(cuda, case)
    assert scene.spheres.count + scene.rects.count <= fused.MAX_OBJECTS
    _render_bit_identical(scene, cfg)


@pytest.mark.cuda
def test_render_kernel_where_every_ray_misses(cuda):
    """A view of the sky over config 2 (every ray climbs, the spheres lie
    behind the eye): the background everywhere, every plane 0."""
    scene, _, _ = configs.config2_four_spheres(device=cuda)
    sky = dataclasses.replace(scene, camera=type(scene.camera).make(
        (0.0, 1.0, 50.0), (0.0, 60.0, 100.0), device=cuda))
    cfg = RenderConfig(height=72, width=100, shadows=True)
    img, vis = fused.render_fused(sky, cfg)
    assert not _hit(sky, cfg).any()
    assert torch.equal(img, fused.render_fused_plain(sky, cfg)[0])
    assert torch.equal(img, scene.background.clamp(0, 1).expand(72, 100, 3))
    assert vis.shape == (scene.lights.count, 72, 100) and not vis.any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [ROW2_CASES[0], ROW2_CASES[2], ROW2_CASES[6]],
                         ids=["config2-512", "crowded2-200x333", "config3-57x70"])
def test_render_bwd_reads_row2_planes(cuda, case):
    """Row 3 fed row 2's planes (0 on a miss): the gradient of its eager
    twin (`render_bwd_adjoint_eager`) within 1e-2 of each leaf's scale, and
    the same bits as row 3 fed the plain version's planes (it reads them
    only where the ray hit)."""
    scene, cfg = _row2_case(cuda, case)
    g = _seeded(cfg, 3, cuda)
    got = fused.autograd_vjp(render, scene, cfg, g)
    vis_k = fused.render_fused(scene, cfg)[1]
    vis_p = fused.render_fused_plain(scene, cfg)[1].contiguous()
    _close_leaves(fused.render_bwd_adjoint_eager(scene, cfg, g, vis_k), got)
    flat = fused._cuda_flat(scene, cfg)
    by_plain = fused._render_bwd_launch(scene, cfg, flat, g, vis_p)
    assert torch.equal(fused.flatten_scene(got), by_plain)


# (label, family, config number, size, soft_tau, route): the training steps that
# `optim.make_step` captures, through a step kernel (rows 1, 6, 9) or through
# autograd of `render` (a forward and its render backward, rows 4+5)
GRAPH_CASES = [("row1", 2, 48, 0.0, "step"), ("row6", 5, 64, 0.0, "step"),
               ("row9", 5, 48, 0.08, "step"), ("rows4-5", 5, 48, 0.0, "render")]


def _graph_case(cuda, num, size, tau, route, iters=6):
    from reversible_raytracer_tpu_torch import optim

    scene, spec, _ = configs.CONFIGS[num](size=size, device=cuda)
    cfg = RenderConfig(height=size, width=size + 8, shadows=True, soft_tau=tau)
    target = render(scene, cfg).detach()
    start = configs.perturb(scene, spec, scale=0.05, seed=4)
    ocfg = optim.OptConfig(iters=iters, lr=2e-3)
    render_fn = (lambda s: render(s, cfg)) if route == "render" else None
    return start, target, spec, cfg, ocfg, render_fn


def _run_steps(make, start, target, spec, cfg, ocfg, render_fn, n):
    step, init = make(cfg, spec, ocfg, render_fn=render_fn)
    scene, state, losses = start, init(start), []
    for _ in range(n):
        scene, state, loss, _ = step(scene, state, target)
        losses.append(loss.clone())
    return torch.stack(losses), fused.flatten_scene(scene).clone(), step


@pytest.mark.cuda
@pytest.mark.parametrize("label, num, size, tau, route", GRAPH_CASES,
                         ids=[c[0] for c in GRAPH_CASES])
def test_graph_step_is_the_eager_step(cuda, label, num, size, tau, route):
    """`make_step`'s CUDA graph against `make_eager_step` from the same start:
    the per-step losses and the final scene bit for bit; `optimize_scan` in
    chunks of 2 the same bits; and the launches of N replays N times those
    of one step."""
    from reversible_raytracer_tpu_torch import graphs, optim

    args = _graph_case(cuda, num, size, tau, route)
    eager_losses, eager_flat, _ = _run_steps(optim.make_eager_step, *args, n=6)
    per_step = {k.name: k.launches for k in graphs.graph_kernels()}
    _run_steps(optim.make_eager_step, *args, n=1)
    per_step = {k.name: k.launches - per_step[k.name] for k in graphs.graph_kernels()}
    before = {k.name: k.launches for k in graphs.graph_kernels()}
    losses, flat, _ = _run_steps(optim.make_step, *args, n=6)
    assert torch.equal(losses, eager_losses) and torch.equal(flat, eager_flat)
    for k in graphs.graph_kernels():  # one eager (warm-up) step, then five replays
        assert k.launches - before[k.name] == 6 * per_step[k.name], k.name
    start, target, spec, cfg, ocfg, render_fn = args
    final, scan_losses = optim.optimize_scan(start, target, spec, cfg, ocfg,
                                             render_fn=render_fn, max_chunk=2)
    assert torch.equal(scan_losses, eager_losses)
    assert torch.equal(fused.flatten_scene(final), eager_flat)


@pytest.mark.cuda
def test_graph_step_that_cannot_be_captured_raises(cuda):
    """A step that waits for the card (``float(loss)``) runs eagerly once and
    then raises `CaptureError` at its capture; it never runs eagerly in the
    graph's place, and the card stays usable."""
    from reversible_raytracer_tpu_torch import graphs, optim

    start, target, spec, cfg, ocfg, _ = _graph_case(cuda, 2, 32, 0.0, "step")
    vag = loss_and_grad_fn(start, cfg)

    def syncing(scene, tgt):
        loss, grads = vag(scene, tgt)
        float(loss)
        return loss, grads

    step, init = optim.make_step(cfg, spec, ocfg, vag_fn=syncing)
    with pytest.raises(graphs.CaptureError, match="captured"):
        step(start, init(start), target)
    with pytest.raises(graphs.CaptureError):
        optim.optimize(start, target, spec, cfg, ocfg, vag_fn=syncing, log_every=0)
    assert float(torch.ones(4, device=cuda).sum()) == 4.0


# ---------------------------------------------------------------------------
# The soft checker (checker_tau > 0) of rows 7, 8 and 9: config 4
# ---------------------------------------------------------------------------

# The camera's eye, look_at and up gradients come from one chain (the basis
# from the ten ray-form cotangents): each is held to the largest of the
# three, as up's is a float32 cancellation far below eye's on config 4.
CAMERA_CHAIN = ("camera.eye", "camera.look_at", "camera.up")


def _close_leaves_chain(g_ref, g_got, rel=1e-2):
    chain = max(float(getattr(g_ref.camera, p.split(".")[1]).abs().max()) for p in CAMERA_CHAIN)
    for path, a, b in zip(leaf_paths(g_ref), tree_leaves(g_ref), tree_leaves(g_got)):
        if a.numel():
            a, b = a.cpu().numpy(), b.cpu().numpy()
            scale = max(np.abs(a).max(), 1e-6, chain if path in CAMERA_CHAIN else 0.0)
            np.testing.assert_allclose(b, a, atol=rel * scale, rtol=0, err_msg=path)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [64, 512])
def test_soft_checker_kernels_match_plain(cuda, size):
    """Config 4 at tau 0.08, checker_tau 1.0: row 7 against its plain version
    by the oracle rule; rows 9 and 8 (through autograd of `render`) against
    autograd and their eager twins, every leaf within 1e-2 of its scale, the
    camera's and the checker columns' included, and the eye's gradient not
    0; row 9 against row 7's own image a loss of exactly 0."""
    scene, spec, cfg = configs.config4_checker_camera(size, device=cuda)
    cfg = dataclasses.replace(cfg, soft_tau=0.08, checker_tau=1.0)
    assert resolve_impl(scene, cfg) == "cuda_vec_soft"
    start = configs.perturb(scene, spec, scale=0.05, seed=4)
    img_k = fused_vec_soft.render_vec_soft(scene, cfg)
    err = (img_k - fused_vec_soft.render_vec_soft_plain(scene, cfg)).abs()
    assert float((err > 2e-3).float().mean()) < 1e-3 and float(err.mean()) < 1e-4
    target = fused_vec_soft.render_vec_soft_plain(scene, cfg)
    l_k, g_k = fused_vec_soft.loss_grad_vec_soft(start, cfg, target)
    for ref in (fused_vec_soft.loss_grad_vec_soft_adjoint_eager,
                fused_vec_soft.loss_grad_vec_soft_plain):
        l_r, g_r = ref(start, cfg, target)
        assert abs(float(l_k) - float(l_r)) <= 1e-4 * float(l_r)
        _close_leaves_chain(g_r, g_k)
    assert float(g_k.camera.eye.abs().max()) > 1e-6
    assert g_k.rects.material.checker.any() and g_k.rects.material.checker_scale.any()
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(size, size, 3)).astype(
        np.float32)).to(cuda)
    before = fused_vec_soft.SOFT_RENDER_BWD.launches
    g_8 = fused.autograd_vjp(render, start, cfg, g)
    assert fused_vec_soft.SOFT_RENDER_BWD.launches == before + 1
    _close_leaves_chain(fused_vec_soft.render_vec_soft_bwd_plain(start, cfg, g), g_8)
    _close_leaves_chain(fused_vec_soft.render_vec_soft_bwd_adjoint_eager(start, cfg, g), g_8)
    l_0, g_0 = fused_vec_soft.loss_grad_vec_soft(scene, cfg, img_k)
    assert float(l_0) == 0.0 and not fused.flatten_scene(g_0).any()


@pytest.mark.cuda
def test_soft_checker_instance_keeps_unchecked_bits(cuda):
    """Config 5 (no checkered material) at 512^2, tau 0.08: rows 7, 8 and 9
    give the same image, loss and gradient bits at checker_tau 1.0 (the
    kernels' soft-checker instance) as at checker_tau 0 (the instance of the
    hard checker). Its blend is c1 + 0 (c2 - c1) there; at the true scene,
    where color2 is color, the checker column's gradient par (c2 - c1) .
    g_base is 0 as well (at a perturbed colour it is not, and rightly)."""
    scene, spec, _ = configs.config5_many_spheres(size=512, device=cuda)
    cfg0 = RenderConfig(height=512, width=512, shadows=True, soft_tau=0.08)
    cfg1 = dataclasses.replace(cfg0, checker_tau=1.0)
    img = fused_vec_soft.render_vec_soft(scene, cfg0)
    assert torch.equal(img, fused_vec_soft.render_vec_soft(scene, cfg1))
    target = fused_vec_soft.render_vec_soft(configs.perturb(scene, spec, scale=0.05, seed=4),
                                            cfg0)
    l0, g0 = fused_vec_soft.loss_grad_vec_soft(scene, cfg0, target)
    l1, g1 = fused_vec_soft.loss_grad_vec_soft(scene, cfg1, target)
    assert float(l0) == float(l1) > 0.0
    assert torch.equal(fused.flatten_scene(g0), fused.flatten_scene(g1))
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(512, 512, 3)).astype(
        np.float32)).to(cuda)
    assert torch.equal(fused.flatten_scene(fused.autograd_vjp(render, scene, cfg0, g)),
                       fused.flatten_scene(fused.autograd_vjp(render, scene, cfg1, g)))


@pytest.mark.cuda
def test_config4_anneal_recovers_the_camera(cuda):
    """The JAX package's config-4 recipe (tests/test_soft_checker.py:260) at
    64^2 on the card: taus 0.08, 0.03, 0 with checker_ratio 12.5, 100 Adam
    steps a stage at lr 5e-3 from perturb(0.05, seed 0); the eye's RMS
    error ends below 0.02 of its start. Row 9 steps the soft stages (200),
    row 7 renders their targets (2), row 1 the hard polish (100)."""
    from reversible_raytracer_tpu_torch import optim

    scene, spec, cfg = configs.config4_checker_camera(64, device=cuda)
    target = render(scene, cfg).detach()
    start = configs.perturb(scene, spec, scale=0.05, seed=0)
    rms = lambda s: float(((s.camera.eye - scene.camera.eye) ** 2).mean().sqrt())  # noqa: E731
    kernels = fused.KERNELS + fused_vec.KERNELS + fused_vec_soft.KERNELS
    for k in kernels:
        k.launches = 0
    final, losses = optim.optimize_annealed(start, target, spec, cfg,
                                            optim.OptConfig(iters=100, lr=5e-3),
                                            taus=(0.08, 0.03, 0.0), target_scene=scene,
                                            checker_ratio=12.5)
    launches = {k.name: k.launches for k in kernels if k.launches}
    assert launches == {"fused_vec_soft_step": 200, "fused_vec_soft_render": 2,
                        "fused_step": 100}
    assert torch.isfinite(losses).all()
    assert rms(final) < 0.02 * rms(start)


# ---------------------------------------------------------------------------
# spp 4 (2x2 supersampling): rows 1, 2, 3 and 6 loop over the subsamples in
# the kernel, rows 4, 5, 7 and 8 make one launch a subsample
# ---------------------------------------------------------------------------

# (family, config number, soft_tau, launches a call of the forward and of
# the render backward)
SPP4_CASES = [("fused", 2, 0.0, 1), ("vec", 5, 0.0, 4), ("soft", 5, 0.08, 4)]
SPP4_SIZE = 32


def _spp4_case(cuda, num, tau):
    scene, spec, _ = configs.CONFIGS[num](size=SPP4_SIZE, device=cuda)
    cfg = RenderConfig(height=SPP4_SIZE, width=SPP4_SIZE, shadows=True, soft_tau=tau, spp=4)
    return scene, configs.perturb(scene, spec, scale=0.05, seed=4), cfg


def _forward(family):
    """(kernel, wrapper giving (image, planes), plain version) of a family's
    forward."""
    return {"fused": (fused.FUSED_RENDER, fused.render_fused, fused.render_fused_plain),
            "vec": (fused_vec.VEC_RENDER, fused_vec.render_vec, fused_vec.render_vec_plain),
            "soft": (fused_vec_soft.SOFT_RENDER,
                     lambda s, c: (fused_vec_soft.render_vec_soft(s, c), None),
                     lambda s, c: (fused_vec_soft.render_vec_soft_plain(s, c), None))}[family]


@pytest.mark.cuda
@pytest.mark.parametrize("family, num, tau, per_call", SPP4_CASES)
def test_spp4_forward_matches_plain(cuda, family, num, tau, per_call):
    """Rows 2, 4 and 7 at spp 4: rows 2 and 4 bit for bit their plain
    versions (the image; each subsample's planes on the pixels its ray hit,
    and 0 where it hit nothing), row 7 within 1e-6; one launch a call for
    row 2, four for rows 4 and 7; two calls bit-identical."""
    scene, _, cfg = _spp4_case(cuda, num, tau)
    kernel, call, plain = _forward(family)
    before = kernel.launches
    img_k, vis_k = call(scene, cfg)
    assert kernel.launches == before + per_call
    again = call(scene, cfg)
    assert torch.equal(img_k, again[0])
    img_p, vis_p = plain(scene, cfg)
    if family == "soft":
        assert float((img_k - img_p).abs().max()) <= 1e-6
        return
    assert torch.equal(img_k, img_p) and torch.equal(vis_k, again[1])
    L = scene.lights.count
    assert vis_k.shape == vis_p.shape == (4 * L, cfg.height, cfg.width)
    for q, off in enumerate(pipeline.SPP_OFFSETS[4]):
        o, d = pipeline.primary_rays(scene, cfg, off)
        hit = nearest_vec(scene, o, d)[1] >= 0
        planes_k, planes_p = vis_k[q * L:(q + 1) * L], vis_p[q * L:(q + 1) * L]
        assert torch.equal(planes_k[:, hit], planes_p[:, hit])
        assert not planes_k[:, ~hit].any()


@pytest.mark.cuda
@pytest.mark.parametrize("family, num", [("fused", 2), ("vec", 5)])
def test_spp4_step_matches_adjoint(cuda, family, num):
    """Rows 1 and 6 at spp 4 (the residual of the subsamples' average):
    loss within 1e-4 relative and every leaf within 1e-2 of its scale
    against autograd and against the eager twin; one launch a call; two
    calls bit-identical; against the forward kernel's own spp-4 image of the
    same scene a loss of exactly 0 and every gradient exactly 0."""
    scene, start, cfg = _spp4_case(cuda, num, 0.0)
    kernel, step, twin, plain, forward = {
        "fused": (fused.FUSED_STEP, fused.loss_grad_fused, fused.loss_grad_adjoint_eager,
                  fused.loss_grad_fused_plain, fused.render_fused),
        "vec": (fused_vec.VEC_STEP, fused_vec.loss_grad_vec,
                fused_vec.loss_grad_vec_adjoint_eager, fused_vec.loss_grad_vec_plain,
                fused_vec.render_vec)}[family]
    target = forward(scene, cfg)[0].detach()
    before = kernel.launches
    l_k, g_k = step(start, cfg, target)
    assert kernel.launches == before + 1
    l_2, g_2 = step(start, cfg, target)
    assert torch.equal(torch.cat([l_k.reshape(1), fused.flatten_scene(g_k)]),
                       torch.cat([l_2.reshape(1), fused.flatten_scene(g_2)]))
    for ref in (twin, plain):
        l_r, g_r = ref(start, cfg, target)
        assert abs(float(l_k) - float(l_r)) <= 1e-4 * float(l_r)
        _close_leaves(g_r, g_k)
    l_0, g_0 = step(scene, cfg, target)
    assert float(l_0) == 0.0
    assert not fused.flatten_scene(g_0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("family, num, tau, per_call", SPP4_CASES)
def test_spp4_render_bwd_matches_plain(cuda, family, num, tau, per_call):
    """Rows 3, 5 and 8 at spp 4, reached by autograd of `render`: against
    autograd of the eager render and against the eager twin, every leaf
    within 1e-2 of its scale; one launch a call for row 3, four for rows 5
    and 8; two calls bit-identical."""
    _, start, cfg = _spp4_case(cuda, num, tau)
    g = torch.from_numpy(np.random.default_rng(0).normal(
        size=(cfg.height, cfg.width, 3)).astype(np.float32)).to(cuda)
    kernel = _bwd_kernel(family)
    before = kernel.launches
    got, ref = _bwd_call(family, start, cfg, g)
    assert kernel.launches == before + per_call
    _close_leaves(ref, got)
    if family == "fused":
        twin = fused.render_bwd_adjoint_eager(start, cfg, g, fused.render_fused(start, cfg)[1])
    elif family == "vec":
        twin = fused_vec.render_vec_bwd_adjoint_eager(start, cfg, g,
                                                      fused_vec.render_vec(start, cfg)[1])
    else:
        twin = fused_vec_soft.render_vec_soft_bwd_adjoint_eager(start, cfg, g)
    _close_leaves(twin, got)
    again = _bwd_call(family, start, cfg, g)[0]
    assert torch.equal(fused.flatten_scene(got), fused.flatten_scene(again))


@pytest.mark.cuda
def test_spp4_soft_step_is_autograd_of_the_render(cuda):
    """A spp-4 soft training step (`loss_and_grad_fn`) never launches row 9:
    four launches of row 7 and four of row 8 a call, its gradient the
    autograd of the plain render's within 1e-2 of each leaf's scale."""
    scene, start, cfg = _spp4_case(cuda, 5, 0.08)
    target = render(scene, cfg).detach()
    before = [k.launches for k in fused_vec_soft.KERNELS]
    l_k, g_k = loss_and_grad_fn(start, cfg)(start, target)
    assert [k.launches - b for k, b in zip(fused_vec_soft.KERNELS, before)] == [4, 0, 4]
    l_p, g_p = fused_vec_soft.loss_grad_vec_soft_plain(start, cfg, target)
    assert abs(float(l_k) - float(l_p)) <= 1e-4 * float(l_p)
    _close_leaves(g_p, g_k)



# ---------------------------------------------------------------------------
# spp 4 with texel grids and with a bounce: rows 1-3 on configs 6, 7 and 9,
# rows 4-6 on config 10, config 8 with a bounce and the textured globes, rows
# 7-8 on config 8 at tau 0.08
# ---------------------------------------------------------------------------

# name: (family, how the case is made)
SPP4_TEX_CASES = {"config6": "fused", "config7": "fused", "config9": "fused",
                  "config10": "vec", "config8_r1": "vec", "globes": "vec"}
SPP4_TEX_SIZE = 32


def _spp4_tex_case(cuda, name):
    """(truth, start, cfg) at spp 4 and SPP4_TEX_SIZE^2: the texels (config 6:
    the mirror coefficients; config 10: the mirrors and the sky) moved by
    perturb(scale 0.4, or 0.3 / 0.2 on configs 6 / 10)."""
    if name == "globes":
        scene, _, cfg = _globes(cuda, SPP4_TEX_SIZE, 0)
        spec = configs.ParamSpec.none(scene).train("spheres.texture", lower=0.0, upper=1.0)
    else:
        num = int(name[6:].split("_")[0])
        scene, spec, cfg = configs.CONFIGS[num](size=SPP4_TEX_SIZE, device=cuda)
        if name.endswith("_r1"):
            cfg = dataclasses.replace(cfg, reflections=1)
    scale = {"config6": 0.3, "config10": 0.2}.get(name, 0.4)
    start = configs.perturb(scene, spec, scale=scale, seed=3)
    return scene, start, dataclasses.replace(cfg, spp=4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SPP4_TEX_CASES))
def test_spp4_texels_forward_matches_plain(cuda, name):
    """Rows 2 and 4's textured, env and bounce instances at spp 4: the image
    bit for bit the plain version's; each subsample's planes of each level
    bit for bit where that level's ray hit at its offset, 0 elsewhere; one
    launch a call for row 2, four for row 4."""
    family = SPP4_TEX_CASES[name]
    _, scene, cfg = _spp4_tex_case(cuda, name)
    kernel, call, plain = _forward(family)
    before = kernel.launches
    img_k, vis_k = call(scene, cfg)
    assert kernel.launches == before + (1 if family == "fused" else 4)
    img_p, vis_p = plain(scene, cfg)
    assert torch.equal(img_k, img_p)
    L, R = scene.lights.count, cfg.reflections
    assert vis_k.shape == vis_p.shape == (4 * (1 + R) * L, cfg.height, cfg.width)
    hits_at = fused.level_hits if family == "fused" else fused_vec.level_hits
    for q, off in enumerate(pipeline.SPP_OFFSETS[4]):
        for lv, hit in enumerate(hits_at(scene, cfg, off)):
            base = q * (1 + R) * L + lv * L
            k, p = vis_k[base:base + L], vis_p[base:base + L]
            assert torch.equal(k[:, hit], p[:, hit]) and not k[:, ~hit].any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SPP4_TEX_CASES))
def test_spp4_texels_step_matches_adjoint(cuda, name):
    """Rows 1 and 6's textured, env and bounce instances at spp 4: against
    the eager twin and autograd, the loss within 1e-4 relative and every
    leaf within 1e-2 of its scale; one launch a call; against the forward
    kernel's own spp-4 image a loss and every gradient of exactly 0."""
    family = SPP4_TEX_CASES[name]
    truth, start, cfg = _spp4_tex_case(cuda, name)
    kernel, step, twin, plain, forward = {
        "fused": (fused.FUSED_STEP, fused.loss_grad_fused, fused.loss_grad_adjoint_eager,
                  fused.loss_grad_fused_plain, fused.render_fused),
        "vec": (fused_vec.VEC_STEP, fused_vec.loss_grad_vec,
                fused_vec.loss_grad_vec_adjoint_eager, fused_vec.loss_grad_vec_plain,
                fused_vec.render_vec)}[family]
    target = forward(truth, cfg)[0].detach()
    before = kernel.launches
    l_k, g_k = step(start, cfg, target)
    assert kernel.launches == before + 1
    for ref in (twin, plain):
        l_r, g_r = ref(start, cfg, target)
        assert abs(float(l_k) - float(l_r)) <= 1e-4 * float(l_r)
        _close_leaves(g_r, g_k)
    l_0, g_0 = step(truth, cfg, target)
    assert float(l_0) == 0.0 and not fused.flatten_scene(g_0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SPP4_TEX_CASES))
def test_spp4_texels_render_bwd_matches_plain(cuda, name):
    """Rows 3 and 5's textured, env and bounce instances at spp 4, reached by
    autograd of `render`: against autograd of the eager render and the eager
    twin, every leaf within 1e-2 of its scale; one launch a call for row 3,
    four for row 5."""
    family = SPP4_TEX_CASES[name]
    _, start, cfg = _spp4_tex_case(cuda, name)
    g = torch.from_numpy(np.random.default_rng(0).normal(
        size=(cfg.height, cfg.width, 3)).astype(np.float32)).to(cuda)
    kernel = _bwd_kernel(family)
    before = kernel.launches
    got, ref = _bwd_call(family, start, cfg, g)
    assert kernel.launches == before + (1 if family == "fused" else 4)
    _close_leaves(ref, got)
    if family == "fused":
        twin = fused.render_bwd_adjoint_eager(start, cfg, g, fused.render_fused(start, cfg)[1])
    else:
        twin = fused_vec.render_vec_bwd_adjoint_eager(start, cfg, g,
                                                      fused_vec.render_vec(start, cfg)[1])
    _close_leaves(twin, got)


@pytest.mark.cuda
def test_spp4_texels_soft_render_matches_plain(cuda):
    """Rows 7 and 8's texel instances at spp 4 (config 8, tau 0.08): four
    launches of each a call, the image within 1e-6 of the plain version's,
    the gradient (autograd of `render`) within 1e-2 of each leaf's scale of
    the plain render's autograd and of the twin; the soft step refuses spp
    4 by name."""
    scene, spec, cfg = configs.config8_globe(size=SPP4_TEX_SIZE, device=cuda)
    cfg = dataclasses.replace(cfg, spp=4, soft_tau=0.08)
    start = configs.perturb(scene, spec, scale=0.4, seed=3)
    before = [k.launches for k in fused_vec_soft.KERNELS]
    img = fused_vec_soft.render_vec_soft(start, cfg)
    assert float((img - fused_vec_soft.render_vec_soft_plain(start, cfg)).abs().max()) <= 1e-6
    g = torch.from_numpy(np.random.default_rng(0).normal(
        size=(cfg.height, cfg.width, 3)).astype(np.float32)).to(cuda)
    got, ref = _bwd_call("soft", start, cfg, g)
    assert [k.launches - b for k, b in zip(fused_vec_soft.KERNELS, before)] == [8, 0, 4]
    _close_leaves(ref, got)
    _close_leaves(fused_vec_soft.render_vec_soft_bwd_adjoint_eager(start, cfg, g), got)
    with pytest.raises(NotImplementedError, match="spp=4 in the soft step"):
        fused_vec_soft.loss_grad_vec_soft(start, cfg, img.detach())


# ---------------------------------------------------------------------------
# One mirror bounce (reflections 1) in rows 1-3: config 6
# ---------------------------------------------------------------------------

MIRROR_SHAPES = [(512, 512), (200, 333), (57, 70)]


def _mirror_case(cuda, H=512, W=512, seed=3):
    scene, spec, _ = configs.config6_mirror(device=cuda)
    cfg = RenderConfig(height=H, width=W, shadows=True, reflections=1)
    return scene, configs.perturb(scene, spec, scale=0.3, seed=seed), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("H, W", MIRROR_SHAPES)
def test_mirror_forward_bit_identical(cuda, H, W):
    """Row 2 with a bounce level against `render_fused_plain`: the image bit
    for bit; 2 L planes, level 0's bit for bit where the primary ray hit and
    level 1's where both levels hit, 0 elsewhere; one launch a call."""
    _, scene, cfg = _mirror_case(cuda, H, W)
    before = fused.FUSED_RENDER.launches
    img_k, vis_k = fused.render_fused(scene, cfg)
    assert fused.FUSED_RENDER.launches == before + 1
    img_p, vis_p = fused.render_fused_plain(scene, cfg)
    L = scene.lights.count
    assert vis_k.shape == vis_p.shape == (2 * L, H, W)
    assert torch.equal(img_k, img_p)
    for lv, hit in enumerate(fused.level_hits(scene, cfg)):
        k, p = vis_k[lv * L:(lv + 1) * L], vis_p[lv * L:(lv + 1) * L]
        assert torch.equal(k[:, hit], p[:, hit]) and not k[:, ~hit].any()
    assert not torch.equal(img_k, fused.render_fused(scene, dataclasses.replace(
        cfg, reflections=0))[0])


@pytest.mark.cuda
def test_mirror_step_matches_adjoint(cuda):
    """Row 1 with a bounce level at 512^2: against the eager twin and
    autograd (loss within 1e-4 relative, every leaf within 1e-2 of its
    scale, the diffuse sphere's centre too); one launch a call, the same
    bits twice; against row 2's own image of the true scene a loss and
    gradient of exactly 0. The diffuse sphere's mirror coefficient at 0 has
    a gradient toward an image where it reflects (perturb seed 1 takes it
    to 0.246): the bounce is traced where m = 0."""
    scene, start, cfg = _mirror_case(cuda)
    target = fused.render_fused(scene, cfg)[0]
    before = fused.FUSED_STEP.launches
    l_k, g_k = fused.loss_grad_fused(start, cfg, target)
    assert fused.FUSED_STEP.launches == before + 1
    l_2, g_2 = fused.loss_grad_fused(start, cfg, target)
    assert torch.equal(torch.cat([l_k.reshape(1), fused.flatten_scene(g_k)]),
                       torch.cat([l_2.reshape(1), fused.flatten_scene(g_2)]))
    for ref in (fused.loss_grad_adjoint_eager, fused.loss_grad_fused_plain):
        l_r, g_r = ref(start, cfg, target)
        assert abs(float(l_k) - float(l_r)) <= 1e-4 * float(l_r)
        _close_leaves(g_r, g_k)
    assert float(g_k.spheres.center[1].abs().max()) > 0.0
    l_0, g_0 = fused.loss_grad_fused(scene, cfg, target)
    assert float(l_0) == 0.0 and not fused.flatten_scene(g_0).any()
    up = _mirror_case(cuda, seed=1)[1]
    assert float(scene.spheres.material.mirror[1]) == 0.0 < float(up.spheres.material.mirror[1])
    target_up = fused.render_fused(up, cfg)[0]
    g_u = fused.loss_grad_fused(scene, cfg, target_up)[1]
    _close_leaves(fused.loss_grad_fused_plain(scene, cfg, target_up)[1], g_u)
    assert float(g_u.spheres.material.mirror[1]) < 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("H, W", MIRROR_SHAPES)
def test_mirror_render_bwd_matches_plain(cuda, H, W):
    """Row 3 with a bounce level, by autograd of `render`: against autograd
    of the eager render and the eager twin fed row 2's planes, every leaf
    within 1e-2 of its scale; one launch a call; its mse gradient row 1's
    bit for bit."""
    scene, start, cfg = _mirror_case(cuda, H, W)
    g = _seeded(cfg, 0, cuda)
    before = fused.FUSED_RENDER_BWD.launches
    got = fused.autograd_vjp(render, start, cfg, g)
    assert fused.FUSED_RENDER_BWD.launches == before + 1
    _close_leaves(fused.render_fused_bwd_plain(start, cfg, g), got)
    _close_leaves(fused.render_bwd_adjoint_eager(start, cfg, g,
                                                 fused.render_fused(start, cfg)[1]), got)
    target = render(scene, cfg).detach()
    leaves = [l.clone().requires_grad_(True) for l in tree_leaves(start)]
    ((render(tree_unflatten(start, leaves), cfg) - target) ** 2).mean().backward()
    by_render = torch.cat([l.grad.reshape(-1) for l in leaves])
    assert torch.equal(by_render, fused.flatten_scene(fused.loss_grad_fused(start, cfg,
                                                                            target)[1]))


@pytest.mark.cuda
def test_mirror_inversion_recovers_the_coefficients(cuda):
    """`invert --config 6 --perturb 0.3 --lr 2e-2 --iters 150 --seed 3` at
    48^2 on the card: the mirror coefficients' RMS error from its start
    below 1e-3, through row 1 (150 launches) and row 2 (2)."""
    from reversible_raytracer_tpu_torch import cli

    for k in fused.KERNELS:
        k.launches = 0
    out = cli.main(["invert", "--config", "6", "--size", "48", "--perturb", "0.3", "--lr",
                    "2e-2", "--iters", "150", "--seed", "3", "--log-every", "0", "--quiet"])
    assert (fused.FUSED_STEP.launches, fused.FUSED_RENDER.launches) == (150, 1)
    assert out["param_err"] < 1e-3


@pytest.mark.cuda
def test_mirror_refusals_on_cuda(cuda):
    """On CUDA four bounce levels raise by name and launch nothing, at spp 1
    and 4, in both hard families (which take one to three bounce levels at
    either spp)."""
    scene, _, cfg = _mirror_case(cuda, 32, 32)
    big, _, cfg5 = configs.config5_many_spheres(size=32, device=cuda)
    before = [k.launches for k in fused.KERNELS + fused_vec.KERNELS]
    for s, c, why in ((scene, dataclasses.replace(cfg, reflections=4), "reflections > 3"),
                      (scene, dataclasses.replace(cfg, spp=4, reflections=4), "reflections > 3"),
                      (big, dataclasses.replace(cfg5, reflections=4, spp=4),
                       "reflections > 3")):
        with pytest.raises(NotImplementedError, match=why):
            render(s, c)
    assert [k.launches for k in fused.KERNELS + fused_vec.KERNELS] == before


# ---------------------------------------------------------------------------
# Texel grids (object textures, the environment map) in rows 1-3: configs 7-9
# ---------------------------------------------------------------------------

# name: (config, keyword arguments of its builder, a camera (eye, look_at) or None)
TEXEL_CASES = {
    "config7": (7, {}, None),
    "config8": (8, {}, None),
    "config9": (9, {}, None),
    # the floor's edges in view at 4 texels a side: both axes clamp there
    "config7_k4_edges": (7, {"tex_k": 4}, ((0.0, 8.0, 10.0), (0.0, -0.7, 0.0))),
    # looking down the -x axis: the azimuth's atan2 seam runs down the frame
    "config8_seam": (8, {}, ((-3.6, 0.9, 0.0), (0.0, 0.1, 0.0))),
    "config9_seam": (9, {}, ((-3.8, 0.6, 0.0), (0.0, 0.1, 0.0))),
    # one texel a side: the wrapped axis's two corners are one texel
    "config8_k1": (8, {"tex_k": 1}, None),
    "config9_k1": (9, {"env_k": 1}, None),
}


def _texel_case(cuda, name, size=64, seed=0):
    """(truth, start, cfg): the case's scene at ``size``^2 and its texels
    moved by perturb(scale=0.4, seed)."""
    num, kw, cam = TEXEL_CASES[name]
    scene, spec, cfg = configs.CONFIGS[num](size=size, device=cuda, **kw)
    if cam is not None:
        c = scene.camera
        scene = dataclasses.replace(scene, camera=dataclasses.replace(
            c, eye=torch.tensor(cam[0], device=cuda), look_at=torch.tensor(cam[1], device=cuda)))
    return scene, configs.perturb(scene, spec, scale=0.4, seed=seed), cfg


def _texel_leaf(grads, scene):
    return (grads.env if scene.env_mapped else
            grads.spheres.texture if scene.spheres.textured else grads.rects.texture)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TEXEL_CASES))
def test_texture_forward_bit_identical(cuda, name):
    """Row 2's textured instances against `render_fused_plain`: the image bit
    for bit, each level's planes on the pixels it hit and 0 elsewhere
    (`fused.level_hits`); one launch a call, three calls the same bits."""
    _, start, cfg = _texel_case(cuda, name)
    before = fused.FUSED_RENDER.launches
    runs = [fused.render_fused(start, cfg) for _ in range(3)]
    assert fused.FUSED_RENDER.launches == before + 3
    assert all(torch.equal(runs[0][0], r[0]) and torch.equal(runs[0][1], r[1]) for r in runs[1:])
    img, vis = runs[0]
    img_p, vis_p = fused.render_fused_plain(start, cfg)
    assert torch.equal(img, img_p) and vis.shape == vis_p.shape
    L = start.lights.count
    for lv, hit in enumerate(fused.level_hits(start, cfg)):
        k, p_ = vis[lv * L:(lv + 1) * L], vis_p[lv * L:(lv + 1) * L]
        assert torch.equal(k[:, hit], p_[:, hit]) and not k[:, ~hit].any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TEXEL_CASES))
def test_texture_step_matches_adjoint(cuda, name):
    """Row 1's textured instances against the eager adjoint and autograd
    (every leaf, texels, camera and geometry, within 1e-2 of its scale), one
    launch a call, the same bits over three calls; against row 2's own image
    of the truth a loss and gradient of exactly 0; the texels get a
    gradient."""
    scene, start, cfg = _texel_case(cuda, name)
    target = fused.render_fused(scene, cfg)[0]
    g_k = _flat_rows_hold(start, target, cfg)
    assert float(_texel_leaf(g_k, scene).abs().max()) > 0.0
    l_0, g_0 = fused.loss_grad_fused(scene, cfg, target)
    assert float(l_0) == 0.0 and not fused.flatten_scene(g_0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TEXEL_CASES))
def test_texture_render_bwd_matches_plain(cuda, name):
    """Row 3's textured instances, by autograd of `render`: against autograd
    of the eager render and the eager twin fed row 2's planes, every leaf
    within 1e-2 of its scale; one launch a call, three calls the same bits;
    its mse gradient row 1's bit for bit."""
    scene, start, cfg = _texel_case(cuda, name)
    g = _seeded(cfg, 1, cuda)
    before = fused.FUSED_RENDER_BWD.launches
    got = fused.autograd_vjp(render, start, cfg, g)
    assert fused.FUSED_RENDER_BWD.launches == before + 1
    for _ in range(2):
        assert torch.equal(fused.flatten_scene(got),
                           fused.flatten_scene(fused.autograd_vjp(render, start, cfg, g)))
    _close_leaves(fused.render_fused_bwd_plain(start, cfg, g), got)
    _close_leaves(fused.render_bwd_adjoint_eager(start, cfg, g,
                                                 fused.render_fused(start, cfg)[1]), got)
    target = render(scene, cfg).detach()
    leaves = [l.clone().requires_grad_(True) for l in tree_leaves(start)]
    ((render(tree_unflatten(start, leaves), cfg) - target) ** 2).mean().backward()
    by_render = torch.cat([l.grad.reshape(-1) for l in leaves])
    assert torch.equal(by_render, fused.flatten_scene(fused.loss_grad_fused(start, cfg,
                                                                            target)[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("num, frac", [(7, 0.25), (8, 0.3), (9, 0.3)])
def test_texture_inversion_meets_the_jax_criteria(cuda, num, frac):
    """`invert --config N --lr 3e-2 --perturb 0.4 --iters 200` at 64^2 on the
    card, through row 1 (200 launches) and row 2 (the target): a final loss
    below 1e-5 and the observable texels' RMS error below ``frac`` of its
    start (tests/test_texture.py:385-408, :490-512; tests/test_env.py:95-117);
    observable: a gradient at the truth towards 0.9 times its image."""
    from reversible_raytracer_tpu_torch import cli

    scene, spec, cfg = configs.CONFIGS[num](size=64, device=cuda)
    for k in fused.KERNELS:
        k.launches = 0
    out = cli.main(["invert", "--config", str(num), "--size", "64", "--lr", "3e-2", "--perturb",
                    "0.4", "--iters", "200", "--log-every", "199", "--quiet"])
    assert (fused.FUSED_STEP.launches, fused.FUSED_RENDER.launches) == (200, 1)
    target = fused.render_fused(scene, cfg)[0] * 0.9
    mask = _texel_leaf(fused.loss_grad_fused(scene, cfg, target)[1], scene).abs() > 1e-10
    start = configs.perturb(scene, spec, scale=0.4, seed=0)
    truth = _texel_leaf(scene, scene)
    err0 = float(((_texel_leaf(start, scene) - truth)[mask] ** 2).mean().sqrt())
    err1 = float(((_texel_leaf(out["scene"], scene) - truth)[mask] ** 2).mean().sqrt())
    assert out["history"][-1]["loss"] < 1e-5
    assert err1 < frac * err0, (err0, err1)


@pytest.mark.cuda
def test_texture_refusals_on_cuda(cuda):
    """On CUDA each combination the textured instances do not take raises by
    name and launches nothing: two bounce levels with a texel grid at spp 4,
    at most 24 objects and past 24, four bounce levels with the environment
    map, the soft step of a textured scene past 24 objects at spp 4 (the
    soft render takes it) and a soft render of one of at most 24 under the
    soft checker (the soft kernels' texel instances take the hard checker),
    and a grid whose rows do not fit a block's shared memory."""
    tex, _, cfg7 = configs.config7_texture(size=32, device=cuda)
    sky, _, cfg9 = configs.config9_sky(size=32, device=cuda)
    big = configs.config9_sky(size=32, env_k=48, device=cuda)[0]
    many, _, cfg5 = configs.config5_many_spheres(size=32, device=cuda)
    many = dataclasses.replace(many, rects=dataclasses.replace(
        many.rects, texture=torch.full((1, 4, 4, 3), 0.5, device=cuda)))
    before = [k.launches for k in fused.KERNELS + fused_vec.KERNELS + fused_vec_soft.KERNELS]
    for s, c, why in ((tex, dataclasses.replace(cfg7, spp=4, reflections=4), "reflections > 3"),
                      (many, dataclasses.replace(cfg5, spp=4, reflections=4), "reflections > 3"),
                      (sky, dataclasses.replace(cfg9, reflections=4), "reflections > 3"),
                      (many, dataclasses.replace(cfg5, soft_tau=0.05, spp=4),
                       "spp=4 in the soft step"),
                      (tex, dataclasses.replace(cfg7, soft_tau=0.05, checker_tau=0.5),
                       "the soft checker"),
                      (big, cfg9, "a texel grid this large")):
        with pytest.raises(NotImplementedError, match=why):
            if "soft step" in why:
                fused_vec_soft.loss_grad_vec_soft(s, c, torch.zeros((32, 32, 3), device=cuda))
            else:
                render(s, c)
    assert [k.launches for k in fused.KERNELS + fused_vec.KERNELS
            + fused_vec_soft.KERNELS] == before


# ---------------------------------------------------------------------------
# The environment map and one bounce level in rows 4-6: config 10
# ---------------------------------------------------------------------------

# name: (config, keyword arguments of its builder, image size, bounce levels)
CHROME_CASES = {
    "config10": (10, {}, (96, 128), 1),
    "config10_no_bounce": (10, {}, (96, 128), 0),
    "config10_k1": (10, {"env_k": 1}, (64, 64), 1),
    "config5_bounce": (5, {}, (96, 128), 1),
}


def _chrome_case(cuda, name, seed=10):
    num, kw, (H, W), refl = CHROME_CASES[name]
    scene, spec, cfg = configs.CONFIGS[num](device=cuda, **kw)
    cfg = dataclasses.replace(cfg, height=H, width=W, reflections=refl)
    return scene, configs.perturb(scene, spec, scale=0.2 if num == 10 else 0.05, seed=seed), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CHROME_CASES))
def test_chrome_forward_bit_identical(cuda, name):
    """Row 4's env and bounce instances against `render_vec_plain`: the
    image bit for bit; (1 + R) L planes, level 0's bit for bit where the
    primary ray hit and level 1's where both levels hit, 0 elsewhere; one
    launch a call, three calls the same bits."""
    _, start, cfg = _chrome_case(cuda, name)
    before = fused_vec.VEC_RENDER.launches
    runs = [fused_vec.render_vec(start, cfg) for _ in range(3)]
    assert fused_vec.VEC_RENDER.launches == before + 3
    assert all(torch.equal(runs[0][0], r[0]) and torch.equal(runs[0][1], r[1]) for r in runs[1:])
    img_k, vis_k = runs[0]
    img_p, vis_p = fused_vec.render_vec_plain(start, cfg)
    L = start.lights.count
    assert vis_k.shape == vis_p.shape == ((1 + cfg.reflections) * L, cfg.height, cfg.width)
    assert torch.equal(img_k, img_p)
    for lv, hit in enumerate(fused_vec.level_hits(start, cfg)):
        k, p = vis_k[lv * L:(lv + 1) * L], vis_p[lv * L:(lv + 1) * L]
        assert torch.equal(k[:, hit], p[:, hit]) and not k[:, ~hit].any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CHROME_CASES))
def test_chrome_step_matches_adjoint(cuda, name):
    """Row 6's env and bounce instances against the eager twin and autograd
    (loss within 1e-4 relative, every leaf within 1e-2 of its scale, the
    env's and the mirror coefficients' included); one launch a call, three
    calls the same bits; against row 4's own image of the true scene a loss
    and gradient of exactly 0."""
    scene, start, cfg = _chrome_case(cuda, name)
    target = fused_vec.render_vec(scene, cfg)[0]
    before = fused_vec.VEC_STEP.launches
    runs = [fused_vec.loss_grad_vec(start, cfg, target) for _ in range(3)]
    assert fused_vec.VEC_STEP.launches == before + 3
    flat = [torch.cat([l.reshape(1), fused.flatten_scene(g)]) for l, g in runs]
    assert all(torch.equal(flat[0], f) for f in flat[1:])
    l_k, g_k = runs[0]
    for ref in (fused_vec.loss_grad_vec_adjoint_eager, fused_vec.loss_grad_vec_plain):
        l_r, g_r = ref(start, cfg, target)
        assert abs(float(l_k) - float(l_r)) <= 1e-4 * float(l_r)
        _close_leaves(g_r, g_k)
    if cfg.reflections:
        assert float(g_k.spheres.material.mirror.abs().max()) > 0.0
    l_0, g_0 = fused_vec.loss_grad_vec(scene, cfg, target)
    assert float(l_0) == 0.0 and not fused.flatten_scene(g_0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CHROME_CASES))
def test_chrome_render_bwd_matches_plain(cuda, name):
    """Row 5's env and bounce instances, by autograd of `render`: against
    autograd of the eager render and the eager twin fed row 4's planes,
    every leaf within 1e-2 of its scale; one launch a call, three calls the
    same bits; its mse gradient row 6's bit for bit."""
    scene, start, cfg = _chrome_case(cuda, name)
    g = _seeded(cfg, 0, cuda)
    before = fused_vec.VEC_RENDER_BWD.launches
    runs = [fused.flatten_scene(fused.autograd_vjp(render, start, cfg, g)) for _ in range(3)]
    assert fused_vec.VEC_RENDER_BWD.launches == before + 3
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    got = fused.autograd_vjp(render, start, cfg, g)
    _close_leaves(fused_vec.render_vec_bwd_plain(start, cfg, g), got)
    _close_leaves(fused_vec.render_vec_bwd_adjoint_eager(start, cfg, g,
                                                         fused_vec.render_vec(start, cfg)[1]),
                  got)
    target = render(scene, cfg).detach()
    leaves = [l.clone().requires_grad_(True) for l in tree_leaves(start)]
    ((render(tree_unflatten(start, leaves), cfg) - target) ** 2).mean().backward()
    by_render = torch.cat([(torch.zeros_like(l) if l.grad is None else l.grad).reshape(-1)
                           for l in leaves])
    assert torch.equal(by_render, fused.flatten_scene(
        fused_vec.loss_grad_vec(start, cfg, target)[1]))


@pytest.mark.cuda
def test_chrome_refusals_on_cuda(cuda):
    """Past 24 objects, four bounces raise by name and launch nothing, at spp
    1 and 4, with object textures and the env or with the env alone."""
    scene, _, cfg = _chrome_case(cuda, "config10")
    tex = dataclasses.replace(scene, rects=dataclasses.replace(
        scene.rects, texture=torch.full((1, 4, 4, 3), 0.5, device=cuda)))
    before = [k.launches for k in fused_vec.KERNELS]
    for s, c, why in ((tex, dataclasses.replace(cfg, spp=4, reflections=4), "reflections > 3"),
                      (scene, dataclasses.replace(cfg, spp=4, reflections=4), "reflections > 3"),
                      (tex, dataclasses.replace(cfg, reflections=4), "reflections > 3"),
                      (scene, dataclasses.replace(cfg, reflections=4), "reflections > 3")):
        with pytest.raises(NotImplementedError, match=why):
            render(s, c)
    assert [k.launches for k in fused_vec.KERNELS] == before


# ---------------------------------------------------------------------------
# Object texel grids in rows 4-6: the textured globes, configs 7 and 8 with a
# bounce
# ---------------------------------------------------------------------------

# name: (what, image size, bounce levels, the grids' side, the env's side, the floor's grid side)
VEC_TEX_CASES = {
    "globes": ("globes", (64, 64), 0, 16, 0, 0),
    "globes_bounce": ("globes", (64, 96), 1, 16, 0, 0),
    "globes_env_bounce": ("globes", (48, 64), 1, 8, 16, 0),
    "globes_floor_env_bounce": ("globes", (48, 64), 1, 8, 16, 4),
    "config7_bounce": (7, (64, 64), 1, 16, 0, 0),
    "config8_bounce": (8, (64, 64), 1, 16, 0, 0),
}


def _globes(cuda, size, refl, k=16, env_k=0, floor_k=0):
    """Config 5's 64 spheres + ground, each sphere with a (k, k, 3) texel
    grid uniform(0.1, 0.9) of default_rng(7) and, with ``refl``, mirror
    coefficients uniform(0.2, 0.8) drawn next (the JAX package's
    scripts/vec_textured_tpu_check.py); with ``env_k`` config 9's sky of that
    side, with ``floor_k`` a ground grid of that side drawn next (the rects'
    texels after the spheres' in the texel row). Trains the object texels."""
    scene, _, cfg = configs.config5_many_spheres(size=size, device=cuda)
    sp = scene.spheres
    rng = np.random.default_rng(7)
    sp = dataclasses.replace(sp, texture=torch.tensor(
        rng.uniform(0.1, 0.9, (sp.count, k, k, 3)), dtype=torch.float32, device=cuda))
    if refl:
        mir = torch.tensor(rng.uniform(0.2, 0.8, (sp.count,)), dtype=torch.float32, device=cuda)
        sp = dataclasses.replace(sp, material=dataclasses.replace(sp.material, mirror=mir))
    scene = dataclasses.replace(scene, spheres=sp)
    if env_k:
        scene = dataclasses.replace(scene, env=configs.config9_sky(size=size, env_k=env_k,
                                                                   device=cuda)[0].env)
    spec = configs.ParamSpec.none(scene).train("spheres.texture", lower=0.0, upper=1.0)
    if floor_k:
        floor = torch.tensor(rng.uniform(0.1, 0.9, (1, floor_k, floor_k, 3)), dtype=torch.float32,
                             device=cuda)
        scene = dataclasses.replace(scene, rects=dataclasses.replace(scene.rects, texture=floor))
        spec = configs.ParamSpec.none(scene).train(
            lambda path: path.endswith("texture"), lower=0.0, upper=1.0)
    return scene, spec, dataclasses.replace(cfg, reflections=refl)


def _vec_tex_case(cuda, name, seed=0):
    """(truth, start, cfg): the case at its size, its object texels moved by
    perturb(scale=0.4, seed)."""
    what, (H, W), refl, k, env_k, floor_k = VEC_TEX_CASES[name]
    if what == "globes":
        scene, spec, cfg = _globes(cuda, H, refl, k, env_k, floor_k)
    else:
        scene, spec, cfg = configs.CONFIGS[what](size=H, device=cuda)
        cfg = dataclasses.replace(cfg, reflections=refl)
    cfg = dataclasses.replace(cfg, height=H, width=W)
    return scene, configs.perturb(scene, spec, scale=0.4, seed=seed), cfg


def _object_texels(grads):
    return torch.cat([grads.spheres.texture.reshape(-1), grads.rects.texture.reshape(-1)])


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(VEC_TEX_CASES))
def test_vec_texture_forward_bit_identical(cuda, name):
    """Row 4's textured instances against `render_vec_plain`: the image bit
    for bit; (1 + R) L planes, level 0's bit for bit where the primary ray
    hit and level 1's where both levels hit, 0 elsewhere; one launch a call,
    three calls the same bits; `resolve_impl` takes them."""
    _, start, cfg = _vec_tex_case(cuda, name)
    assert resolve_impl(start, cfg) == "cuda_vec"
    before = fused_vec.VEC_RENDER.launches
    runs = [fused_vec.render_vec(start, cfg) for _ in range(3)]
    assert fused_vec.VEC_RENDER.launches == before + 3
    assert all(torch.equal(runs[0][0], r[0]) and torch.equal(runs[0][1], r[1]) for r in runs[1:])
    img_k, vis_k = runs[0]
    img_p, vis_p = fused_vec.render_vec_plain(start, cfg)
    L = start.lights.count
    assert vis_k.shape == vis_p.shape == ((1 + cfg.reflections) * L, cfg.height, cfg.width)
    assert torch.equal(img_k, img_p)
    for lv, hit in enumerate(fused_vec.level_hits(start, cfg)):
        k, p = vis_k[lv * L:(lv + 1) * L], vis_p[lv * L:(lv + 1) * L]
        assert torch.equal(k[:, hit], p[:, hit]) and not k[:, ~hit].any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(VEC_TEX_CASES))
def test_vec_texture_step_matches_adjoint(cuda, name):
    """Row 6's textured instances against the eager twin and autograd (loss
    within 1e-4 relative, every leaf within 1e-2 of its scale, the texels'
    included and not all 0); one launch a call, three calls the same bits;
    against row 4's own image of the true scene a loss and gradient of
    exactly 0."""
    scene, start, cfg = _vec_tex_case(cuda, name)
    target = fused_vec.render_vec(scene, cfg)[0]
    before = fused_vec.VEC_STEP.launches
    runs = [fused_vec.loss_grad_vec(start, cfg, target) for _ in range(3)]
    assert fused_vec.VEC_STEP.launches == before + 3
    flat = [torch.cat([l.reshape(1), fused.flatten_scene(g)]) for l, g in runs]
    assert all(torch.equal(flat[0], f) for f in flat[1:])
    l_k, g_k = runs[0]
    assert bool(_object_texels(g_k).any())
    for ref in (fused_vec.loss_grad_vec_adjoint_eager, fused_vec.loss_grad_vec_plain):
        l_r, g_r = ref(start, cfg, target)
        assert abs(float(l_k) - float(l_r)) <= 1e-4 * float(l_r)
        _close_leaves(g_r, g_k)
    l_0, g_0 = fused_vec.loss_grad_vec(scene, cfg, target)
    assert float(l_0) == 0.0 and not fused.flatten_scene(g_0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(VEC_TEX_CASES))
def test_vec_texture_render_bwd_matches_plain(cuda, name):
    """Row 5's textured instances, by autograd of `render`: against autograd
    of the eager render and the eager twin fed row 4's planes, every leaf
    within 1e-2 of its scale, the texels' not all 0; one launch a call, three
    calls the same bits; its mse gradient row 6's bit for bit."""
    scene, start, cfg = _vec_tex_case(cuda, name)
    g = _seeded(cfg, 0, cuda)
    before = fused_vec.VEC_RENDER_BWD.launches
    runs = [fused.flatten_scene(fused.autograd_vjp(render, start, cfg, g)) for _ in range(3)]
    assert fused_vec.VEC_RENDER_BWD.launches == before + 3
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    got = fused.autograd_vjp(render, start, cfg, g)
    assert bool(_object_texels(got).any())
    _close_leaves(fused_vec.render_vec_bwd_plain(start, cfg, g), got)
    _close_leaves(fused_vec.render_vec_bwd_adjoint_eager(start, cfg, g,
                                                         fused_vec.render_vec(start, cfg)[1]),
                  got)
    target = render(scene, cfg).detach()
    leaves = [l.clone().requires_grad_(True) for l in tree_leaves(start)]
    ((render(tree_unflatten(start, leaves), cfg) - target) ** 2).mean().backward()
    by_render = torch.cat([(torch.zeros_like(l) if l.grad is None else l.grad).reshape(-1)
                           for l in leaves])
    assert torch.equal(by_render, fused.flatten_scene(
        fused_vec.loss_grad_vec(start, cfg, target)[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(VEC_TEX_CASES))
def test_vec_texture_smem_matches_python(cuda, name):
    """`fused_vec.texel_step_smem_bytes`, which the dispatch refuses by, is
    what the textured step's and render backward's C entries count."""
    _, start, cfg = _vec_tex_case(cuda, name)
    dims = (start.spheres.count, start.rects.count, start.lights.count,
            *fused_vec.tex_levels(start, cfg)[1:])
    want = fused_vec.texel_step_smem_bytes(start)
    assert fused_vec.VEC_STEP.lib().rrt_vec_step_tex_smem(*dims) == want
    assert fused_vec.VEC_RENDER_BWD.lib().rrt_vec_render_bwd_tex_smem(*dims) == want


@pytest.mark.cuda
@pytest.mark.parametrize("num, frac", [(7, 0.25), (8, 0.3)])
def test_vec_texture_inversion_meets_the_jax_criteria(cuda, num, frac):
    """`invert --config N --reflections 1 --lr 3e-2 --perturb 0.4 --iters 200`
    at 64^2 on the card, through row 6 (200 launches) and row 4 (the
    target), no row 1-3: a final loss below 1e-5 and the observable texels'
    RMS error below ``frac`` of its start (the JAX tests' criteria; the
    configs' mirror coefficients are 0, so the bounce adds nothing to the
    image)."""
    from reversible_raytracer_tpu_torch import cli

    scene, spec, cfg = configs.CONFIGS[num](size=64, device=cuda)
    cfg = dataclasses.replace(cfg, reflections=1)
    for k in fused.KERNELS + fused_vec.KERNELS:
        k.launches = 0
    out = cli.main(["invert", "--config", str(num), "--reflections", "1", "--size", "64", "--lr",
                    "3e-2", "--perturb", "0.4", "--iters", "200", "--log-every", "199",
                    "--quiet"])
    assert (fused_vec.VEC_STEP.launches, fused_vec.VEC_RENDER.launches) == (200, 1)
    assert all(k.launches == 0 for k in fused.KERNELS)
    target = fused_vec.render_vec(scene, cfg)[0] * 0.9
    mask = _texel_leaf(fused_vec.loss_grad_vec(scene, cfg, target)[1], scene).abs() > 1e-10
    start = configs.perturb(scene, spec, scale=0.4, seed=0)
    truth = _texel_leaf(scene, scene)
    err0 = float(((_texel_leaf(start, scene) - truth)[mask] ** 2).mean().sqrt())
    err1 = float(((_texel_leaf(out["scene"], scene) - truth)[mask] ** 2).mean().sqrt())
    assert out["history"][-1]["loss"] < 1e-5
    assert err1 < frac * err0, (err0, err1)


@pytest.mark.cuda
@pytest.mark.parametrize("refl", [0, 1])
def test_vec_texture_captured_loop_matches_eager(cuda, refl):
    """The globes' 49,152 texels through the captured step (`optim.make_step`:
    the static buffers and the flat Adam update) and the eager one
    (`make_eager_step`) from the same start: the losses and the final
    trainable vector bit for bit, one launch of row 6 a step, the loss
    falling."""
    from reversible_raytracer_tpu_torch import optim

    scene, spec, cfg = _globes(cuda, 64, refl)
    target = render(scene, cfg).detach()
    start = configs.perturb(scene, spec, scale=0.4, seed=0)
    ocfg = optim.OptConfig(iters=6, lr=3e-2)
    flags = optim.trainable_flags(spec)
    assert int(optim.ravel_trainable(start, flags).numel()) == 64 * 16 * 16 * 3
    runs = []
    for make in (optim.make_step, optim.make_eager_step):
        step, init = make(cfg, spec, ocfg)
        s, state = start, init(start)
        losses = torch.empty((ocfg.iters,), device=cuda)
        before = fused_vec.VEC_STEP.launches
        for i in range(ocfg.iters):
            s, state, loss, _ = step(s, state, target)
            losses[i] = loss
        assert fused_vec.VEC_STEP.launches - before == ocfg.iters
        runs.append((losses, optim.ravel_trainable(s, flags).clone()))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    assert float(runs[0][0][-1]) < float(runs[0][0][0])


@pytest.mark.cuda
def test_vec_texture_refusals_on_cuda(cuda):
    """Object texel grids past 24 objects with four bounces at spp 4 and at
    spp 1, in a soft render with a bounce, and grids whose gradient row does
    not fit a block's shared memory (the 64 globes' 16 x 16 grids beside a
    16 x 16 sky, in rows 4-6 and in the soft step) raise by name and launch
    nothing."""
    scene, _, cfg = _globes(cuda, 32, 1)
    big = _globes(cuda, 32, 1, env_k=16)[0]
    before = [k.launches for k in fused.KERNELS + fused_vec.KERNELS + fused_vec_soft.KERNELS]
    for s, c, why in ((scene, dataclasses.replace(cfg, spp=4, reflections=4),
                       "reflections > 3"),
                      (scene, dataclasses.replace(cfg, reflections=4), "reflections > 3"),
                      (scene, dataclasses.replace(cfg, soft_tau=0.05), "mirror reflections"),
                      (big, cfg, "object texel grids this large"),
                      (big, dataclasses.replace(cfg, soft_tau=0.05, reflections=0),
                       "a texel grid this large")):
        with pytest.raises(NotImplementedError, match=why):
            render(s, c)
    assert [k.launches for k in fused.KERNELS + fused_vec.KERNELS
            + fused_vec_soft.KERNELS] == before


# ---------------------------------------------------------------------------
# Two and three bounce levels in rows 1-6: configs 6 and 9 (rows 1-3), config
# 10 and config 8's globe with mirror coefficients (rows 4-6, ``_levels`` with
# the env and ``_tex``)
# ---------------------------------------------------------------------------

# name: (family, config, its trained leaves' perturb scale)
BOUNCE_CASES = {"config6": ("fused", 6, 0.3), "config9": ("fused", 9, 0.4),
                "config10": ("vec", 10, 0.2), "config8_mirrors": ("vec", 8, 0.4)}
BOUNCE_SIZE = 64


def _bounce_case(cuda, name, refl, spp):
    """(truth, start, cfg) of a case at BOUNCE_SIZE^2 with ``refl`` bounce
    levels at ``spp``: config 8's globe with mirror coefficients 0.3 and its
    floor 0.4, so that its grid is seen at every level."""
    _, num, scale = BOUNCE_CASES[name]
    scene, spec, cfg = configs.CONFIGS[num](size=BOUNCE_SIZE, device=cuda)
    if name == "config8_mirrors":
        sp, rc = scene.spheres, scene.rects
        scene = dataclasses.replace(
            scene,
            spheres=dataclasses.replace(sp, material=dataclasses.replace(
                sp.material, mirror=torch.full_like(sp.material.mirror, 0.3))),
            rects=dataclasses.replace(rc, material=dataclasses.replace(
                rc.material, mirror=torch.full_like(rc.material.mirror, 0.4))))
    cfg = dataclasses.replace(cfg, reflections=refl, spp=spp)
    return scene, configs.perturb(scene, spec, scale=scale, seed=3), cfg


def _f64(scene):
    return tree_map(lambda x: x.to(torch.float64), scene)


def _close_by_rule(g32, got, f64_fn, tol=1e-4):
    """Every leaf of ``got`` within ``tol`` of its scale of the float32 plain
    gradient ``g32``, or of the float64 one (``f64_fn()``), or, where float32
    does not determine it so closely, no farther from ``g32`` than ``g32`` is
    from float64 (and within 1e-2): chip_smoke.py's rule."""
    g64 = None
    for path, a, b in zip(leaf_paths(g32), tree_leaves(g32), tree_leaves(got)):
        if not a.numel():
            continue
        scale = max(float(a.abs().max()), 1e-6)
        err = float((b - a).abs().max()) / scale
        if err <= tol:
            continue
        if g64 is None:
            g64 = dict(zip(leaf_paths(g32), tree_leaves(f64_fn())))
        e = g64[path].to(a.device)
        s64 = max(float(e.abs().max()), 1e-6)
        if float((b.double() - e).abs().max()) / s64 <= tol:
            continue
        spread = float((a.double() - e).abs().max()) / s64
        assert err <= min(1e-2, spread), (path, err, spread)


@pytest.mark.cuda
@pytest.mark.parametrize("spp", [1, 4])
@pytest.mark.parametrize("refl", [2, 3])
@pytest.mark.parametrize("name", list(BOUNCE_CASES))
def test_bounces_forward_bit_identical(cuda, name, refl, spp):
    """Rows 2 and 4 at two and three bounce levels: the image bit for bit the
    plain version's; each subsample's planes of each level bit for bit where
    that level and every level above hit at its offset, 0 elsewhere; one
    launch a call for row 2, spp for row 4; three calls the same bits."""
    family = BOUNCE_CASES[name][0]
    _, scene, cfg = _bounce_case(cuda, name, refl, spp)
    kernel, call, plain = _forward(family)
    before = kernel.launches
    runs = [call(scene, cfg) for _ in range(3)]
    assert kernel.launches == before + 3 * (1 if family == "fused" else spp)
    assert all(torch.equal(runs[0][0], r[0]) and torch.equal(runs[0][1], r[1]) for r in runs[1:])
    img_k, vis_k = runs[0]
    img_p, vis_p = plain(scene, cfg)
    assert torch.equal(img_k, img_p)
    L = scene.lights.count
    assert vis_k.shape == vis_p.shape == (spp * (1 + refl) * L, cfg.height, cfg.width)
    hits_at = fused.level_hits if family == "fused" else fused_vec.level_hits
    for q, off in enumerate(pipeline.SPP_OFFSETS[spp]):
        hits = hits_at(scene, cfg, off)
        assert len(hits) == 1 + refl
        for lv, hit in enumerate(hits):
            base = q * (1 + refl) * L + lv * L
            k, p = vis_k[base:base + L], vis_p[base:base + L]
            assert torch.equal(k[:, hit], p[:, hit]) and not k[:, ~hit].any()
    if name in ("config6", "config10"):  # a level-1 winner there reflects: the deeper level shows
        assert not torch.equal(img_k, call(scene, dataclasses.replace(cfg,
                                                                     reflections=refl - 1))[0])


@pytest.mark.cuda
@pytest.mark.parametrize("spp", [1, 4])
@pytest.mark.parametrize("refl", [2, 3])
@pytest.mark.parametrize("name", list(BOUNCE_CASES))
def test_bounces_step_matches_plain(cuda, name, refl, spp):
    """Rows 1 and 6 at two and three bounce levels: one launch a call, three
    calls the same bits; against autograd of the plain render by
    `_close_by_rule` (the loss within 1e-4 relative) and against the eager
    twin within 1e-2 of each leaf's scale; against the forward kernel's own
    image of the truth a loss and every gradient of exactly 0."""
    family = BOUNCE_CASES[name][0]
    truth, start, cfg = _bounce_case(cuda, name, refl, spp)
    kernel, step, twin, plain, forward = {
        "fused": (fused.FUSED_STEP, fused.loss_grad_fused, fused.loss_grad_adjoint_eager,
                  fused.loss_grad_fused_plain, fused.render_fused),
        "vec": (fused_vec.VEC_STEP, fused_vec.loss_grad_vec,
                fused_vec.loss_grad_vec_adjoint_eager, fused_vec.loss_grad_vec_plain,
                fused_vec.render_vec)}[family]
    target = forward(truth, cfg)[0].detach()
    before = kernel.launches
    runs = [step(start, cfg, target) for _ in range(3)]
    assert kernel.launches == before + 3
    flat = [torch.cat([l.reshape(1), fused.flatten_scene(g)]) for l, g in runs]
    assert all(torch.equal(flat[0], f) for f in flat[1:])
    l_k, g_k = runs[0]
    l_p, g_p = plain(start, cfg, target)
    assert abs(float(l_k) - float(l_p)) <= 1e-4 * float(l_p)
    _close_by_rule(g_p, g_k, lambda: plain(_f64(start), cfg, target.double())[1])
    l_t, g_t = twin(start, cfg, target)
    assert abs(float(l_k) - float(l_t)) <= 1e-4 * float(l_t)
    _close_leaves(g_t, g_k)
    assert float(g_k.spheres.material.mirror.abs().max()) > 0.0
    l_0, g_0 = step(truth, cfg, target)
    assert float(l_0) == 0.0 and not fused.flatten_scene(g_0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("spp", [1, 4])
@pytest.mark.parametrize("refl", [2, 3])
@pytest.mark.parametrize("name", list(BOUNCE_CASES))
def test_bounces_render_bwd_matches_plain(cuda, name, refl, spp):
    """Rows 3 and 5 at two and three bounce levels, by autograd of `render`:
    one launch a call for row 3, spp for row 5, three calls the same bits;
    against autograd of the plain render by `_close_by_rule` and against
    the eager twin fed the forward's planes within 1e-2 of each leaf's
    scale; its mse gradient row 1's or row 6's bit for bit (row 5's at spp 1,
    where it is one launch)."""
    family = BOUNCE_CASES[name][0]
    truth, start, cfg = _bounce_case(cuda, name, refl, spp)
    g = _seeded(cfg, 0, cuda)
    kernel = _bwd_kernel(family)
    before = kernel.launches
    runs = [fused.autograd_vjp(render, start, cfg, g) for _ in range(3)]
    assert kernel.launches == before + 3 * (1 if family == "fused" else spp)
    assert all(torch.equal(fused.flatten_scene(runs[0]), fused.flatten_scene(r))
               for r in runs[1:])
    got = runs[0]
    plain = fused.render_fused_bwd_plain if family == "fused" else fused_vec.render_vec_bwd_plain
    _close_by_rule(plain(start, cfg, g), got, lambda: plain(_f64(start), cfg, g.double()))
    if family == "fused":
        twin = fused.render_bwd_adjoint_eager(start, cfg, g, fused.render_fused(start, cfg)[1])
    else:
        twin = fused_vec.render_vec_bwd_adjoint_eager(start, cfg, g,
                                                      fused_vec.render_vec(start, cfg)[1])
    _close_leaves(twin, got)
    if family == "vec" and spp != 1:
        return
    target = render(truth, cfg).detach()
    leaves = [l.clone().requires_grad_(True) for l in tree_leaves(start)]
    ((render(tree_unflatten(start, leaves), cfg) - target) ** 2).mean().backward()
    by_render = torch.cat([(torch.zeros_like(l) if l.grad is None else l.grad).reshape(-1)
                           for l in leaves])
    assert torch.equal(by_render, fused.flatten_scene(loss_and_grad_fn(start, cfg)(start,
                                                                                   target)[1]))


@pytest.mark.cuda
def test_bounces_refusals_on_cuda(cuda):
    """Four bounce levels raise by name with the numbers and launch nothing,
    in both hard families, at spp 1 and 4."""
    before = [k.launches for k in fused.KERNELS + fused_vec.KERNELS]
    for name in ("config6", "config10"):
        _, scene, cfg = _bounce_case(cuda, name, 4, 1)
        for spp in (1, 4):
            with pytest.raises(NotImplementedError, match=r"reflections > 3 \(reflections=4"):
                render(scene, dataclasses.replace(cfg, spp=spp))
    assert [k.launches for k in fused.KERNELS + fused_vec.KERNELS] == before


# Rows 7-9's texel instances (the soft kernels' ``_tex`` entries): name ->
# (what, size, tau); "globes" is `_globes` without the bounce, "sky" config
# 5 under config 9's sky seen toward the horizon (the JAX package's
# scripts/vec_textured_tpu_check.py softenv camera), configs 7 and 9 (the
# latter without its bounce).
SOFT_TEX_CASES = {"globes": ("globes", (96, 120), 0.05), "sky": ("sky", (96, 96), 0.05),
                  "config7": (7, (80, 96), 0.08), "config9": (9, (96, 80), 0.08)}


def _soft_tex_case(cuda, name):
    """(truth, start, cfg): the case, its texels moved by perturb(scale=0.4,
    seed=0)."""
    what, (H, W), tau = SOFT_TEX_CASES[name]
    if what == "globes":
        scene, spec, cfg = _globes(cuda, H, 0)
    elif what == "sky":
        scene, _, cfg = configs.config5_many_spheres(size=H, device=cuda)
        scene = dataclasses.replace(
            scene, env=configs.config9_sky(size=H, device=cuda)[0].env,
            camera=configs.Camera.make((0.0, 1.5, 9.5), (0.0, 2.5, 0.0), fov_deg=60.0,
                                       device=cuda))
        spec = configs.ParamSpec.none(scene).train("env", lower=0.0, upper=1.0)
    else:
        scene, spec, cfg = configs.CONFIGS[what](size=H, device=cuda)
    cfg = dataclasses.replace(cfg, height=H, width=W, soft_tau=tau, reflections=0)
    return scene, configs.perturb(scene, spec, scale=0.4, seed=0), cfg


def _all_texels(grads, scene):
    return torch.cat([grads.spheres.texture.reshape(-1), grads.rects.texture.reshape(-1)]
                     + ([grads.env.reshape(-1)] if scene.env_mapped else []))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SOFT_TEX_CASES))
def test_soft_texture_forward_matches_plain(cuda, name):
    """Row 7's texel instance against `render_vec_soft_plain` by the oracle
    rule; one launch a call, three calls the same bits; `resolve_impl` takes
    it."""
    _, start, cfg = _soft_tex_case(cuda, name)
    assert resolve_impl(start, cfg) == "cuda_vec_soft"
    before = fused_vec_soft.SOFT_RENDER.launches
    runs = [fused_vec_soft.render_vec_soft(start, cfg) for _ in range(3)]
    assert fused_vec_soft.SOFT_RENDER.launches == before + 3
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    err = (runs[0] - fused_vec_soft.render_vec_soft_plain(start, cfg)).abs()
    assert float((err > 2e-3).float().mean()) < 1e-3
    assert float(err.mean()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SOFT_TEX_CASES))
def test_soft_texture_step_matches_adjoint(cuda, name):
    """Row 9's texel instance against the eager twin and autograd (loss
    within 1e-4 relative, every leaf within 1e-2 of its scale, the texels'
    or the env's included and not all 0); one launch a call, three calls the
    same bits; against row 7's own image of the true scene a loss and
    gradient of exactly 0."""
    scene, start, cfg = _soft_tex_case(cuda, name)
    target = fused_vec_soft.render_vec_soft_plain(scene, cfg)
    before = fused_vec_soft.SOFT_STEP.launches
    runs = [fused_vec_soft.loss_grad_vec_soft(start, cfg, target) for _ in range(3)]
    assert fused_vec_soft.SOFT_STEP.launches == before + 3
    flat = [torch.cat([l.reshape(1), fused.flatten_scene(g)]) for l, g in runs]
    assert all(torch.equal(flat[0], f) for f in flat[1:])
    l_k, g_k = runs[0]
    assert bool(_all_texels(g_k, start).any())
    for ref in (fused_vec_soft.loss_grad_vec_soft_adjoint_eager,
                fused_vec_soft.loss_grad_vec_soft_plain):
        l_r, g_r = ref(start, cfg, target)
        assert abs(float(l_k) - float(l_r)) <= 1e-4 * float(l_r)
        _close_leaves(g_r, g_k)
    l_0, g_0 = fused_vec_soft.loss_grad_vec_soft(scene, cfg,
                                                 fused_vec_soft.render_vec_soft(scene, cfg))
    assert float(l_0) == 0.0 and not fused.flatten_scene(g_0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SOFT_TEX_CASES))
def test_soft_texture_render_bwd_matches_plain(cuda, name):
    """Row 8's texel instance, by autograd of `render`: against autograd of
    the eager render and the eager twin, every leaf within 1e-2 of its
    scale, the texels' not all 0; one launch a call, three calls the same
    bits; its mse gradient row 9's bit for bit."""
    scene, start, cfg = _soft_tex_case(cuda, name)
    g = _seeded(cfg, 0, cuda)
    before = fused_vec_soft.SOFT_RENDER_BWD.launches
    runs = [fused.flatten_scene(fused.autograd_vjp(render, start, cfg, g)) for _ in range(3)]
    assert fused_vec_soft.SOFT_RENDER_BWD.launches == before + 3
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    got = fused.autograd_vjp(render, start, cfg, g)
    assert bool(_all_texels(got, start).any())
    _close_leaves(fused_vec_soft.render_vec_soft_bwd_plain(start, cfg, g), got)
    _close_leaves(fused_vec_soft.render_vec_soft_bwd_adjoint_eager(start, cfg, g), got)
    target = render(scene, cfg).detach()
    leaves = [l.clone().requires_grad_(True) for l in tree_leaves(start)]
    ((render(tree_unflatten(start, leaves), cfg) - target) ** 2).mean().backward()
    by_render = torch.cat([(torch.zeros_like(l) if l.grad is None else l.grad).reshape(-1)
                           for l in leaves])
    by_step = fused.flatten_scene(fused_vec_soft.loss_grad_vec_soft(start, cfg, target)[1])
    assert torch.equal(by_render, by_step)


@pytest.mark.cuda
def test_soft_texel_instance_without_grids_is_the_untextured_one(cuda):
    """On config 5 without a texel grid, the texel instances' entries at
    sides 0 reduce to the untextured instances' arithmetic: row 7's image
    bit for bit, and rows 9 and 8's loss and gradient (summed over another
    grid of blocks) within 1e-5 of each leaf's scale; the wrappers take the
    untextured entries there, and the texel instance's block keeps the 32
    prefix slots of the untextured one."""
    scene, spec, _ = configs.config5_many_spheres(device=cuda)
    cfg = RenderConfig(height=96, width=128, shadows=True, soft_tau=0.05)
    start = configs.perturb(scene, spec, scale=0.05, seed=4)
    target = fused_vec_soft.render_vec_soft_plain(scene, cfg)
    glob, sph, rct = fused_vec_soft._cuda_inputs(start, cfg)
    none = torch.zeros((0,), device=cuda)
    geom = fused_vec._geometry(start, cfg)
    ptrs = (glob.data_ptr(), sph.data_ptr(), rct.data_ptr(), none.data_ptr(), none.data_ptr(),
            *geom)
    stream = torch.cuda.current_stream().cuda_stream
    img = torch.empty((96, 128, 3), device=cuda)
    fused_vec_soft.SOFT_RENDER.call("rrt_soft_render_tex", *ptrs, 0.0, 0.0, 0.05, 0, 0, 0,
                                    img.data_ptr(), stream)
    assert torch.equal(img, fused_vec_soft.render_vec_soft(start, cfg))
    dims = (start.spheres.count, start.rects.count, start.lights.count)
    scratch = torch.empty((fused_vec_soft.SOFT_STEP.lib().rrt_soft_step_tex_scratch_floats(
        *dims, 96, 128, 0, 0, 0),), device=cuda)
    out = torch.empty((1 + glob.numel() + sph.numel() + rct.numel(),), device=cuda)
    for entry, args, ref in (
            ("rrt_soft_step_tex", (target.data_ptr(), 1.0 / target.numel()),
             fused_vec_soft.loss_grad_vec_soft(start, cfg, target)),
            ("rrt_soft_render_bwd_tex", (_seeded(cfg, 0, cuda).data_ptr(),),
             (torch.zeros(()), fused_vec_soft._render_bwd_launch(
                 start, cfg, (0.0, 0.0), glob, sph, rct, _seeded(cfg, 0, cuda))))):
        kernel = (fused_vec_soft.SOFT_STEP if entry == "rrt_soft_step_tex"
                  else fused_vec_soft.SOFT_RENDER_BWD)
        offs = () if entry == "rrt_soft_step_tex" else (0.0, 0.0)
        kernel.call(entry, *ptrs, *offs, 0.05, 0, 0, 0, *args, scratch.data_ptr(),
                    out.data_ptr(), stream)
        got = fused_vec._unpack_out(start, out, glob, sph, rct)
        _close_leaves(ref[1], got, rel=1e-5)
    lib = fused_vec_soft.SOFT_STEP.lib()
    assert lib.rrt_soft_step_pcap(*dims, 0, 0, 0) == fused_vec_soft.soft_step_plan(
        start, fused_vec.VEC_RENDER.lib().rrt_smem_optin())["pcap"]


@pytest.mark.cuda
def test_multistart_recovers_topology_stall(cuda):
    """The JAX package's CI-size recovery (tests/test_soft_inversion.py
    `test_multistart_recovers_topology_stall`) through the port's
    `optimize_multistart` on the card: config 2 at 48^2 from perturb(scale=0.3,
    seed=2), 100 steps a stage, 4 jittered restarts (jitter 0.15, seed 100).
    Restart 0 reproduces the stall, a jittered restart escapes it and wins on
    the hard loss, and the parameters end nearer the truth."""
    from reversible_raytracer_tpu_torch.optim import OptConfig, optimize_multistart, param_error

    scene, spec, _ = configs.config2_four_spheres(48, device=cuda)
    cfg = RenderConfig(height=48, width=48, shadows=True)
    target = render(scene, cfg).detach()
    ocfg = OptConfig(iters=100, lr=1e-2, schedule="cosine")
    start = configs.perturb(scene, spec, scale=0.3, seed=2)
    err0 = float(param_error(start, scene, spec))
    best, best_loss, finals = optimize_multistart(
        start, target, spec, cfg, ocfg, restarts=4, jitter=0.15, seed=100,
        taus=(0.08, 0.03, 0.0), target_scene=scene)
    assert finals[0] > 4e-3, finals
    assert best_loss < 0.5 * finals[0], finals
    assert best_loss == min(finals)
    err1 = float(param_error(best, scene, spec))
    assert err1 < 0.45 * err0, (err0, err1)


@pytest.mark.cuda
def test_resid_proposal_card_matches_cpu(cuda):
    """The `resid` proposal on config 5 at 256^2 (its attribution through
    row 4) against the port's CPU result from the same start and target,
    r = 1..4: the same peak pixel, and the same suspect with every leaf
    within 1e-5 of its largest wherever the suspect's suspicion is more than
    1e-4 (relative) from its neighbours' in the order."""
    from reversible_raytracer_tpu_torch.models.scene import tree_map
    from reversible_raytracer_tpu_torch.optim import (
        propose_restart,
        reseed_pick,
        restart_attribution,
    )

    scene, spec, cfg = configs.config5_many_spheres(256, device=cuda)
    target = render(scene, cfg).detach()
    start = configs.perturb(scene, spec, scale=0.03, seed=0)
    cpu_start, cpu_target = tree_map(lambda l: l.cpu(), start), target.cpu()
    card = [x.cpu().numpy() for x in restart_attribution(start, target, cfg)]
    cpu = [x.numpy() for x in restart_attribution(cpu_start, cpu_target, cfg)]
    np.testing.assert_array_equal(np.isfinite(card[1]), np.isfinite(cpu[1]))
    ordered = cpu[1][np.argsort(-cpu[1], kind="stable")]
    for r in range(1, 5):
        k = (r - 1) % len(ordered)
        near = [(ordered[j], ordered[j + 1]) for j in (k - 1, k) if 0 <= j < len(ordered) - 1]
        tie = any(np.isfinite(a) and np.isfinite(b) and abs(a - b) <= 1e-4 * max(a, b)
                  for a, b in near)
        pick_k, pick_c = reseed_pick(*card, r - 1), reseed_pick(*cpu, r - 1)
        assert pick_k[1] == pick_c[1], r
        if tie:
            continue
        assert pick_k[0] == pick_c[0], r
        got = propose_restart(start, spec, r, 0.3, 7, "resid", target=target, rcfg=cfg)
        want = propose_restart(cpu_start, spec, r, 0.3, 7, "resid", target=cpu_target, rcfg=cfg)
        for path, a, b in zip(leaf_paths(want), tree_leaves(got), tree_leaves(want)):
            if b.numel():
                np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                           atol=1e-5 * float(b.abs().max()), err_msg=path)


# ---------------------------------------------------------------------------
# Row bands (every row's ``_band`` entries) and the sharded step
# ---------------------------------------------------------------------------


def _band_family(cuda, row, size):
    """(scene, spec, cfg) of the row's family: config 2 (rows 1-3), config 5
    (rows 4-6), config 5 at tau 0.08 (rows 7-9)."""
    if row <= 3:
        return configs.config2_four_spheres(size, device=cuda)
    scene, spec, cfg = configs.config5_many_spheres(size, device=cuda)
    return scene, spec, dataclasses.replace(cfg, soft_tau=0.08 if row >= 7 else 0.0)


def _leaf_rel(got, want):
    return max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in zip(tree_leaves(got), tree_leaves(want)) if b.numel())


@pytest.mark.cuda
@pytest.mark.parametrize("row", [2, 4, 7])
@pytest.mark.parametrize("n", [2, 4])
def test_band_forwards_put_together_are_the_image(cuda, row, n):
    """Rows 2, 4 and 7 in n bands: each band the plain version's at its row0
    (rows 2 and 4 bit for bit, row 7 by the oracle rule), the bands put
    together the whole image's kernel output to the bit."""
    scene, _, cfg = _band_family(cuda, row, 128)
    fn = {2: lambda *a: fused.render_fused(*a)[0], 4: lambda *a: fused_vec.render_vec(*a)[0],
          7: fused_vec_soft.render_vec_soft}[row]
    plain = {2: lambda *a: fused.render_fused_plain(*a)[0],
             4: lambda *a: fused_vec.render_vec_plain(*a)[0],
             7: fused_vec_soft.render_vec_soft_plain}[row]
    b = cfg.height // n
    parts = [fn(scene, cfg, i * b, b).detach() for i in range(n)]
    assert torch.equal(torch.cat(parts), fn(scene, cfg).detach())
    for i, part in enumerate(parts):
        ref = plain(scene, cfg, i * b, b).detach()
        if row == 7:
            assert float((part - ref).abs().max()) < 2e-3
        else:
            assert torch.equal(part, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("row", [1, 6, 9])
def test_band_steps_sum_to_the_image(cuda, row):
    """Rows 1, 6 and 9 over 4 bands (the whole image's norm): the sums of
    the bands' losses and gradients are the whole-image call's within 1e-4
    of each leaf's scale."""
    scene, spec, cfg = _band_family(cuda, row, 128)
    target = render(scene, cfg).detach()
    start = configs.perturb(scene, spec, scale=0.05, seed=1)
    l, g = loss_and_grad_fn(start, cfg)(start, target)
    b, total, ls = cfg.height // 4, None, 0.0
    for i in range(4):
        lb, gb = loss_and_grad_fn(start, cfg, row0=i * b, out_height=b)(
            start, target[i * b:(i + 1) * b])
        ls += float(lb)
        total = gb if total is None else tree_unflatten(
            gb, [x + y for x, y in zip(tree_leaves(total), tree_leaves(gb))])
    assert abs(ls - float(l)) <= 1e-4 * float(l)
    assert _leaf_rel(total, g) <= 1e-4


@pytest.mark.cuda
def test_sharded_step_is_a_graph_with_the_all_reduce(cuda):
    """One NCCL rank: `optimize_sharded_scan` replays a CUDA graph that holds
    the all-reduce, and gives `optimize_scan`'s losses to the bit."""
    import torch.distributed as dist

    from reversible_raytracer_tpu_torch.optim import OptConfig, optimize_scan
    from reversible_raytracer_tpu_torch.parallel import (
        initialize,
        make_ray_mesh,
        optimize_sharded_scan,
    )

    scene, spec, cfg = configs.config2_four_spheres(128, device=cuda)
    target = render(scene, cfg).detach()
    start = configs.perturb(scene, spec, scale=0.05, seed=1)
    ocfg = OptConfig(iters=10)
    initialize()
    try:
        assert dist.get_backend() == "nccl"
        _, want = optimize_scan(start, target, spec, cfg, ocfg)
        before = fused.FUSED_STEP.launches
        _, got = optimize_sharded_scan(start, target, make_ray_mesh(), cfg, spec, ocfg)
        assert fused.FUSED_STEP.launches == before + 10
        assert torch.equal(got, want)
    finally:
        dist.destroy_process_group()
