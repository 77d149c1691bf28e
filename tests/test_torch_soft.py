"""The port's soft-visibility renderer (``soft_tau > 0``) against the JAX
package, its training step's hand-written adjoint against autograd, and
the soft dispatch, on the CPU.

- `render_eager_vec` with soft_tau vs `render_jnp_vec`, config 5 cut to 16
  spheres at 48x48, at tau 0.08 and 0.02, with and without shadows, by the
  edge-masked rule of tests/test_fused_vec_soft.py (which holds the JAX
  package's soft Pallas kernels to the same `render_jnp_vec`, so those
  kernels are not traced here). The JAX side runs `render_jnp_vec`'s spp-1
  body, `_render_soft`, jitted with tau as an argument: one compile per
  shadow setting serves both taus;
- the eager twin of the soft step kernel's adjoint
  (`loss_grad_vec_soft_adjoint_eager`) vs autograd of the soft render, in
  float64 at 1e-5 of each leaf's scale (they agree to ~1e-13);
- the gradient of an edge-masked loss vs `jax.grad` of the JAX soft render
  at tau 0.08 (the same jitted function gives the images above, with
  shadows), the same scene from perturb(scale=0.05, seed) for seeds 0-2:
  every leaf within 1e-2 of its scale. The soft render is smooth
  away from layer changes, so unlike the hard step (tests/test_torch_vec_
  step.py) no size had to be picked by a scan: at 32, 40 and 48 pixels the
  worst leaf at seeds 0-2 is within 1e-5 of its scale.
The soft kernels are held to these plain versions on a card in
tests/test_torch_kernels.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reversible_raytracer_tpu.models import configs as jconfigs
from reversible_raytracer_tpu.ops.pipeline import RenderConfig as JRenderConfig
from reversible_raytracer_tpu.ops.pipeline_vec import _render_soft
from reversible_raytracer_tpu_torch.bridge import scene_from_numpy
from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.models.scene import (
    leaf_paths,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from reversible_raytracer_tpu_torch.ops.kernels import fused_vec_soft
from reversible_raytracer_tpu_torch.ops.pipeline import RenderConfig
from reversible_raytracer_tpu_torch.ops.pipeline_vec import render_eager_vec
from reversible_raytracer_tpu_torch.ops.render import (
    loss_and_grad_fn,
    render,
    render_eager,
    resolve_impl,
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


def _edge_mask(*images, thresh=0.02, dilate=1):
    """Pixels whose neighborhood contains a discontinuity in ANY image (a
    copy of tests/test_fused_vec.py's)."""
    e = np.zeros(images[0].shape[:2], bool)
    for img in images:
        for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)):
            e |= np.abs(img - np.roll(img, sh, axis=ax)).max(-1) > thresh
    for _ in range(dilate):
        for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)):
            e |= np.roll(e, sh, axis=ax)
    return e


def _pair(size, n_spheres, start_seed=None):
    """The JAX config-5 scene cut to ``n_spheres`` (perturbed by ``start_seed``
    if given) and its port twin, bridged through numpy."""
    js, jspec, _ = jconfigs.config5_many_spheres(size, n_spheres=n_spheres)
    if start_seed is not None:
        js = jconfigs.perturb(js, jspec, scale=0.05, seed=start_seed)
    like, _, _ = configs.config5_many_spheres(size, n_spheres=n_spheres, device="cpu")
    ts = scene_from_numpy([np.asarray(x) for x in jax.tree_util.tree_leaves(js)], like=like,
                          device="cpu")
    return js, ts


SIZE, N_SPHERES = 48, 16


@functools.lru_cache(maxsize=None)
def _jax_soft(shadows):
    """JAX's soft render at spp 1 (what `render_jnp_vec` runs for soft_tau
    > 0), jitted with tau as an argument: ``f(scene, tau, w) -> (image,
    gradient of sum(w * image^2))`` with shadows, ``f(scene, tau) -> image``
    without (one compile each)."""
    cfg = JRenderConfig(height=SIZE, width=SIZE, shadows=shadows, soft_tau=1.0)

    def img(s, tau):
        return _render_soft(s, dataclasses.replace(cfg, soft_tau=tau))

    if not shadows:
        return jax.jit(img)

    def loss(s, tau, w):
        im = img(s, tau)
        return jnp.sum(w * im ** 2), im

    vag = jax.jit(jax.value_and_grad(loss, has_aux=True))
    return lambda s, tau, w=jnp.ones((SIZE, SIZE, 1)): (vag(s, tau, w)[0][1], vag(s, tau, w)[1])


def _jax_image(js, tau, shadows):
    out = _jax_soft(shadows)(js, tau)
    return np.asarray(out[0] if shadows else out)


@pytest.mark.parametrize("tau", [0.08, 0.02])
def test_soft_render_matches_jnp_vec(tau):
    js, ts = _pair(SIZE, N_SPHERES)
    for shadows in (True, False):
        a = _jax_image(js, tau, shadows)
        b = render_eager_vec(ts, RenderConfig(height=SIZE, width=SIZE, shadows=shadows,
                                              soft_tau=tau)).numpy()
        stable = ~_edge_mask(a, b)
        assert stable.mean() > 0.3
        err = np.abs(a - b)
        assert err[stable].max() < 1e-3, f"tau={tau} shadows={shadows}"
        assert err[stable].mean() < 1e-6
        assert (err.max(-1) > 1e-3).mean() < 2e-2


@pytest.mark.parametrize("shadows, clip, loss", [(True, True, "mse"), (False, True, "sum"),
                                                 (True, False, "mse")])
def test_soft_adjoint_matches_autograd_float64(shadows, clip, loss):
    scene, spec, _ = configs.config5_many_spheres(size=24, n_spheres=12, device="cpu")
    cfg = RenderConfig(height=24, width=20, shadows=shadows, clip=clip, soft_tau=0.05)
    start = configs.perturb(scene, spec, scale=0.05, seed=4)
    scene, start = (tree_map(lambda x: x.to(torch.float64), s) for s in (scene, start))
    target = render_eager_vec(scene, cfg)
    l_ref, g_ref = fused_vec_soft.loss_grad_vec_soft_plain(start, cfg, target, loss)
    l_adj, g_adj = fused_vec_soft.loss_grad_vec_soft_adjoint_eager(start, cfg, target, loss)
    assert abs(float(l_ref) - float(l_adj)) <= 1e-5 * abs(float(l_ref))
    for path, a, b in zip(leaf_paths(g_ref), tree_leaves(g_ref), tree_leaves(g_adj)):
        assert torch.isfinite(b).all(), path
        if a.numel():
            scale = max(float(a.abs().max()), 1e-6)
            assert float((a - b).abs().max()) <= 1e-5 * scale, path
    assert float(g_adj.spheres.radius.abs().max()) > 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_grads_match_jax(seed):
    js, ts = _pair(SIZE, N_SPHERES, start_seed=seed)
    tcfg = RenderConfig(height=SIZE, width=SIZE, shadows=True, soft_tau=0.08)
    a = _jax_image(js, 0.08, True)
    b = render_eager_vec(ts, tcfg).numpy()
    w = (~_edge_mask(a, b)).astype(np.float32)[..., None]
    jgrads = _jax_soft(True)(js, 0.08, jnp.asarray(w))[1]
    leaves = [l.clone().requires_grad_(True) for l in tree_leaves(ts)]
    (torch.from_numpy(w) * render_eager_vec(tree_unflatten(ts, leaves), tcfg) ** 2).sum().backward()
    for path, ja, tl in zip(leaf_paths(ts), jax.tree_util.tree_leaves(jgrads), leaves):
        ja = np.asarray(ja, np.float64)
        if ja.size:
            got = tl.grad.numpy() if tl.grad is not None else np.zeros_like(ja)
            scale = max(np.abs(ja).max(), 1e-6)
            assert np.abs(got - ja).max() <= 1e-2 * scale, path


def test_soft_dispatch_on_cpu():
    """Soft renders take the eager vec path at any object count (the hard
    where chain refuses soft_tau), and the soft step's CPU contract is
    autograd over that render."""
    ts, _, _ = configs.config2_four_spheres(16, device="cpu")
    cfg = RenderConfig(height=16, width=16, soft_tau=0.05)
    assert resolve_impl(ts, cfg) == "eager_vec"
    torch.testing.assert_close(render(ts, cfg), render_eager_vec(ts, cfg), rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="soft_tau"):
        render_eager(ts, cfg)
    target = torch.zeros((16, 16, 3))
    l_a, g_a = loss_and_grad_fn(ts, cfg)(ts, target)
    l_b, g_b = fused_vec_soft.loss_grad_vec_soft(ts, cfg, target)
    assert float(l_a) == float(l_b)
    for a, b in zip(tree_leaves(g_a), tree_leaves(g_b)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the soft checker renders through the same path; the where chain refuses it
    checker = dataclasses.replace(cfg, checker_tau=0.5)
    assert resolve_impl(ts, checker) == "eager_vec"
    torch.testing.assert_close(render(ts, checker), render_eager_vec(ts, checker), rtol=0,
                               atol=0)
    with pytest.raises(NotImplementedError, match="checker_tau"):
        render_eager(ts, dataclasses.replace(checker, soft_tau=0.0))


@pytest.mark.parametrize("kw, exc, why", [
    (dict(spp=4), NotImplementedError, "subsample offsets"),
    (dict(checker_tau=0.1, soft_tau=0.0), NotImplementedError, "checker"),
    (dict(reflections=1), NotImplementedError, "reflections"),
    (dict(soft_tau=0.0), ValueError, "soft_tau > 0"),
])
def test_soft_kernels_refuse_uncovered_configs(kw, exc, why):
    """What the soft step (row 9) refuses: spp 4 too, as the JAX package's
    soft step does (the render, rows 7-8, takes spp 4 in four launches)."""
    ts, _, _ = configs.config5_many_spheres(16, n_spheres=9, device="cpu")
    cfg = dataclasses.replace(RenderConfig(height=16, width=16, soft_tau=0.05), **kw)
    with pytest.raises(exc, match=why):
        fused_vec_soft.check_soft_kernel_config(ts, cfg, step=True)
    if cfg.spp == 4:
        fused_vec_soft.check_soft_kernel_config(ts, cfg)
    env = dataclasses.replace(ts, env=torch.ones((4, 4, 3)))
    assert fused_vec_soft.soft_kernel_ok(env)
    big = dataclasses.replace(ts, env=torch.ones((72, 72, 3)))  # its gradient fits no block
    assert not fused_vec_soft.soft_kernel_ok(big)
    with pytest.raises(NotImplementedError, match="a texel grid this large"):
        fused_vec_soft.check_soft_kernel_config(big, RenderConfig(height=8, width=8,
                                                                  soft_tau=0.05))
