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
from reversible_raytracer_tpu_torch.models.scene import tree_unflatten
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
    with pytest.raises(NotImplementedError):
        fused.render_fused(scene, RenderConfig(height=32, width=32, spp=4))
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
    """spp 4 names what the soft kernels lack (subsample offsets), in the
    step and in a render that would need the backward."""
    scene, _, _ = configs.config5_many_spheres(size=32, device=cuda)
    spp4 = RenderConfig(height=32, width=32, spp=4, soft_tau=0.05)
    with pytest.raises(NotImplementedError, match="subsample offsets"):
        fused_vec_soft.loss_grad_vec_soft(scene, spp4, torch.zeros((32, 32, 3), device=cuda))
    leaves = [l.clone().requires_grad_(True) for l in tree_leaves(scene)]
    with pytest.raises(NotImplementedError, match="subsample offsets"):
        render(tree_unflatten(scene, leaves), spp4)


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
