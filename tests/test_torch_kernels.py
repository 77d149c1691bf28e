"""The CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one. Nothing here imports
JAX: on the card run them with
``python -m pytest --noconftest tests/test_torch_kernels.py``, which skips
the JAX set-up that tests/conftest.py does for the other test files.
"""

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


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _hit(scene, cfg):
    o, d = pipeline.primary_rays(scene, cfg)
    return pipeline.trace_nearest(scene, o, d, cfg.shape)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("num, H, W", [(1, 64, 64), (2, 128, 160), (3, 96, 72)])
def test_render_kernel_matches_plain(cuda, num, H, W):
    """Oracle rule of tests/test_render_vs_oracle.py on the image; on hit
    pixels the visibility planes agree (on a miss they hold the shadow test
    of a ray from the BIG sentinel, which nothing reads)."""
    scene, _, _ = configs.CONFIGS[num](device=cuda)
    cfg = RenderConfig(height=H, width=W, shadows=num != 1)
    img_k, vis_k = fused.render_fused(scene, cfg)
    img_p, vis_p = fused.render_fused_plain(scene, cfg)
    err = (img_k - img_p).abs()
    assert float((err > 2e-3).float().mean()) < 1e-3
    assert float(err.mean()) < 1e-4
    assert vis_k.shape == vis_p.shape == (pipeline.n_vis_planes(scene, cfg), H, W)
    if vis_k.numel():
        assert float((vis_k != vis_p)[:, _hit(scene, cfg)].float().mean()) < 1e-3


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
