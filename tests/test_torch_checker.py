"""The port's soft checker (``checker_tau > 0``) and config 4 on the CPU
against the JAX package.

- `pipeline.soft_checker_q` against the JAX package's on a grid that holds
  exact integers (cell boundaries, where tri is 0), one axis and three, in
  float32 to 1e-6, and finite at tau = 0;
- `render_eager_vec` of config 4 at 32x32 against the JAX package's: the
  soft render (`_render_soft`, soft_tau 0.05, checker_tau 0.5) and the
  checker-only relaxation (`render_jnp_vec`, soft_tau 0, checker_tau 0.5),
  by the edge-masked rule of tests/test_soft_checker.py:181;
- ``checker_tau == 0`` keeps the hard select bit for bit (the where chain's
  image, and the soft forward kernel's eager twin with and without the
  checker equal to the plain render);
- the eager twin of the soft kernels' adjoint (`_soft_adjoint`) against
  autograd of the soft render in float64, every leaf within 1e-5 of its
  scale, the camera and the checker columns included;
- the gradient of an edge-masked loss against `jax.grad` of the JAX soft
  render, every leaf within 1e-2 of its scale (the camera's is not 0);
- `optimize_annealed(checker_ratio=12.5)` for 3 steps of one soft stage
  (tau 0.04, so checker_tau 0.5) against the JAX package's stage, step by
  step: its stage target (the truth at that stage's taus), value and
  gradient (`jax.value_and_grad` of the mean squared error of `_render_soft`)
  and flat Adam update (`make_flat_update`), to the tolerance of
  tests/test_torch_anneal.py. JAX's own `optimize_annealed` compiles a
  second program of the same size for its scan (some 8 s on a CPU), so the
  stage is driven from the one compiled value-and-grad that the render and
  gradient tests also use;
- `--config 4` and `--checker-ratio` through `cli.main` at 16x16.

The JAX side compiles two functions: the soft render with its value and
gradient (soft_tau an argument, checker_tau 0.5) and the checker-only
render. The soft kernels are held to these plain versions on a card in
tests/test_torch_kernels.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reversible_raytracer_tpu import optim as joptim
from reversible_raytracer_tpu.models import configs as jconfigs
from reversible_raytracer_tpu.ops.pipeline import RenderConfig as JRenderConfig
from reversible_raytracer_tpu.ops.pipeline import soft_checker_q as jax_soft_checker_q
from reversible_raytracer_tpu.ops.pipeline_vec import _render_soft, render_jnp_vec
from reversible_raytracer_tpu_torch import cli, optim
from reversible_raytracer_tpu_torch.bridge import scene_from_numpy, scene_to_numpy
from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.models.scene import (
    leaf_paths,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from reversible_raytracer_tpu_torch.ops.kernels import fused_vec_soft
from reversible_raytracer_tpu_torch.ops.pipeline import RenderConfig, soft_checker_q
from reversible_raytracer_tpu_torch.ops.pipeline_vec import render_eager_vec
from reversible_raytracer_tpu_torch.ops.render import render, render_eager, resolve_impl


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


SIZE, SOFT_TAU, CHECKER_TAU = 32, 0.05, 0.5
CAMERA_CHAIN = ("camera.eye", "camera.look_at", "camera.up")


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _pair(size=SIZE, start_seed=None):
    """JAX's config 4 (perturbed by ``start_seed`` if given), its spec, and
    the port's twin bridged through numpy."""
    js, jspec, _ = jconfigs.config4_checker_camera(size)
    if start_seed is not None:
        js = jconfigs.perturb(js, jspec, scale=0.05, seed=start_seed)
    like, _, _ = configs.config4_checker_camera(size, device="cpu")
    return js, jspec, scene_from_numpy(_np_leaves(js), like=like, device="cpu")


def _cfg(**kw):
    return RenderConfig(height=SIZE, width=SIZE, shadows=True, **kw)


@functools.lru_cache(maxsize=None)
def _jax_soft():
    """JAX's soft render at checker_tau 0.5, jitted with soft_tau, a target
    and per-pixel weights as arguments: ``f(scene, tau, target, w) ->
    ((mean(w (image - target)^2), image), gradient)``; one compile."""
    cfg = JRenderConfig(height=SIZE, width=SIZE, shadows=True, soft_tau=1.0,
                        checker_tau=CHECKER_TAU)

    def loss(s, tau, target, w):
        im = _render_soft(s, dataclasses.replace(cfg, soft_tau=tau))
        return jnp.mean(w * (im - target) ** 2), im

    vag = jax.jit(jax.value_and_grad(loss, has_aux=True))
    zeros, ones = jnp.zeros((SIZE, SIZE, 3)), jnp.ones((SIZE, SIZE, 1))
    return lambda s, tau=SOFT_TAU, target=zeros, w=ones: vag(s, tau, target, w)


def _jax_image(js, tau=SOFT_TAU):
    return np.asarray(_jax_soft()(js, tau)[0][1])


@pytest.mark.parametrize("tau", [0.0, 0.5])
def test_soft_checker_q_matches_jax(tau):
    x = np.linspace(-3.0, 3.0, 241, dtype=np.float32)  # holds the integers -3..3
    assert np.isin(np.arange(-3.0, 4.0), x).all()
    for parts in ((x,), (x, x[::-1] * 0.5, x * 1.5 + 0.25)):
        want = np.asarray(jax_soft_checker_q(tuple(jnp.asarray(p) for p in parts), tau))
        got = soft_checker_q(tuple(torch.from_numpy(p.copy()) for p in parts), tau).numpy()
        assert got.dtype == np.float32 and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if tau == 0.0:  # the hard parity's sign off the cell boundaries
        off = np.abs(x - np.round(x)) > 1e-3
        q = soft_checker_q((torch.from_numpy(x),), 0.0).numpy()
        assert (np.sign(q[off]) == (-1.0) ** np.floor(x[off])).all()


def test_config4_builds_as_jax():
    js, jspec, ts = _pair()
    like, spec, cfg = configs.config4_checker_camera(SIZE, device="cpu")
    assert (cfg.height, cfg.shadows) == (SIZE, True) and configs.CONFIGS[4] is \
        configs.config4_checker_camera
    for a, b in zip(_np_leaves(js), scene_to_numpy(like)):
        np.testing.assert_array_equal(a, b)
    assert [bool(t) for t in jax.tree_util.tree_leaves(jspec.trainable)] == \
        [bool(t) for t in tree_leaves(spec.trainable)]
    for a, b in zip(_np_leaves(jconfigs.perturb(js, jspec, scale=0.05, seed=0)),
                    scene_to_numpy(configs.perturb(like, spec, scale=0.05, seed=0))):
        np.testing.assert_array_equal(a, b)


def _assert_edge_masked_close(a, b):
    """The rule of tests/test_soft_checker.py:181, and every pixel within
    1e-3: at 32x32 the ground's checker (18 cells a unit) changes by more
    than the mask's 0.02 from pixel to pixel, so the mask leaves little more
    than the sky (a fifth of the image) where the JAX test at 64x64 leaves
    0.3."""
    stable = ~_edge_mask(a, b)
    assert stable.mean() > 0.2
    err = np.abs(a - b)
    assert err[stable].max() < 1e-3 and err[stable].mean() < 1e-6
    assert (err.max(-1) > 1e-3).mean() < 2e-2
    assert err.max() < 1e-3


def test_soft_checker_render_matches_jax():
    js, _, ts = _pair()
    a = _jax_image(js)
    b = render_eager_vec(ts, _cfg(soft_tau=SOFT_TAU, checker_tau=CHECKER_TAU)).numpy()
    _assert_edge_masked_close(a, b)
    hard = render_eager_vec(ts, _cfg(soft_tau=SOFT_TAU)).numpy()
    assert np.abs(hard - b).max() > 0.05  # the checker did blend


def test_checker_only_render_matches_jax():
    """soft_tau 0, checker_tau > 0: no kernel in either package; the port
    renders it through render_eager_vec on every device."""
    js, _, ts = _pair()
    jcfg = JRenderConfig(height=SIZE, width=SIZE, shadows=True, checker_tau=CHECKER_TAU)
    a = np.asarray(jax.jit(lambda s: render_jnp_vec(s, jcfg))(js))
    cfg = _cfg(checker_tau=CHECKER_TAU)
    assert resolve_impl(ts, cfg) == "eager_vec"
    b = render(ts, cfg).numpy()
    _assert_edge_masked_close(a, b)
    with pytest.raises(NotImplementedError, match="checker_tau"):  # the where chain refuses it
        render_eager(ts, cfg)


def test_checker_tau_zero_is_the_hard_select():
    _, _, ts = _pair()
    hard = _cfg()
    torch.testing.assert_close(render_eager_vec(ts, hard), render_eager(ts, hard), rtol=0,
                               atol=0)
    for ctau in (0.0, CHECKER_TAU):
        cfg = _cfg(soft_tau=SOFT_TAU, checker_tau=ctau)
        torch.testing.assert_close(fused_vec_soft.render_vec_soft_culled(ts, cfg),
                                   fused_vec_soft.render_vec_soft_plain(ts, cfg), rtol=0, atol=0)


@pytest.mark.parametrize("shadows, clip, loss, ctau", [(True, True, "mse", 0.5),
                                                       (False, True, "sum", 1.0),
                                                       (True, False, "mse", 0.3)])
def test_checker_adjoint_matches_autograd_float64(shadows, clip, loss, ctau):
    scene, spec, _ = configs.config4_checker_camera(24, device="cpu")
    cfg = RenderConfig(height=24, width=20, shadows=shadows, clip=clip, soft_tau=0.05,
                       checker_tau=ctau)
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
    for leaf in (g_adj.camera.eye, g_adj.rects.material.checker,
                 g_adj.rects.material.checker_scale, g_adj.spheres.material.checker):
        assert float(leaf.abs().max()) > 0.0


def test_masked_grads_match_jax():
    """The weights keep the pixels that the two renders shade alike (within
    1e-4; at 32x32 the edge mask keeps only the sky here), so no pixel whose
    layers the two rank differently enters the gradient. The camera's eye,
    look_at and up gradients come from one chain (the basis from the ten
    ray-form cotangents) and are held to the largest of the three: up's is
    a float32 cancellation 1e4 times smaller than eye's here, which the two
    frameworks' sums leave at different roundoff."""
    js, _, ts = _pair(start_seed=0)
    a = _jax_image(js)
    cfg = _cfg(soft_tau=SOFT_TAU, checker_tau=CHECKER_TAU)
    b = render_eager_vec(ts, cfg).numpy()
    w = (np.abs(a - b).max(-1) < 1e-4).astype(np.float32)[..., None]
    assert w.mean() > 0.9
    jgrads = _jax_soft()(js, SOFT_TAU, jnp.zeros((SIZE, SIZE, 3)), jnp.asarray(w))[1]
    assert float(np.abs(np.asarray(jgrads.camera.eye)).max()) > 1e-6
    leaves = [l.clone().requires_grad_(True) for l in tree_leaves(ts)]
    (torch.from_numpy(w) * render_eager_vec(tree_unflatten(ts, leaves), cfg) ** 2).mean().backward()
    cam = max(float(np.abs(np.asarray(getattr(jgrads.camera, f))).max())
              for f in ("eye", "look_at", "up"))
    for path, ja, tl in zip(leaf_paths(ts), jax.tree_util.tree_leaves(jgrads), leaves):
        ja = np.asarray(ja, np.float64)
        if ja.size:
            got = tl.grad.numpy() if tl.grad is not None else np.zeros_like(ja)
            scale = max(np.abs(ja).max(), 1e-6, cam if path in CAMERA_CHAIN else 0.0)
            assert np.abs(got - ja).max() <= 1e-2 * scale, path


def test_optimize_annealed_checker_ratio_matches_jax():
    tau, ratio, iters = 0.04, 12.5, 3  # checker_tau = 12.5 * 0.04 = 0.5, _jax_soft's
    js, jspec, ts = _pair()
    jstart = jconfigs.perturb(js, jspec, scale=0.05, seed=0)
    _, tspec, _ = configs.config4_checker_camera(SIZE, device="cpu")
    tstart = scene_from_numpy(_np_leaves(jstart), like=ts, device="cpu")
    ocfg = dict(iters=iters, lr=5e-3)
    # the JAX package's stage: its target is the truth at the stage's taus
    target = _jax_soft()(js, tau)[0][1]
    jinit, japply = joptim.make_flat_update(jstart, jspec, joptim.OptConfig(**ocfg))
    jscene, jstate, jlosses = jstart, jinit(jstart), []
    for _ in range(iters):
        (loss, _), grads = _jax_soft()(jscene, tau, target)
        jlosses.append(float(loss))
        jscene, jstate, _ = japply(jscene, jstate, grads)
    tfinal, tlosses = optim.optimize_annealed(tstart, None, tspec, _cfg(), optim.OptConfig(**ocfg),
                                              taus=(tau,), target_scene=ts, checker_ratio=ratio)
    np.testing.assert_allclose(tlosses.numpy(), jlosses, rtol=5e-4)
    trained = [bool(t) for t in jax.tree_util.tree_leaves(jspec.trainable)]
    for a, b, t in zip(_np_leaves(jscene), scene_to_numpy(tfinal), trained):
        if t:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-2)


def test_invert_config4_checker_ratio_on_cpu(tmp_path):
    png = tmp_path / "final.png"
    out = cli.main(["invert", "--device", "cpu", "--config", "4", "--size", "16", "--anneal",
                    "0.08,0", "--checker-ratio", "12.5", "--iters", "2", "--lr", "5e-3",
                    "-o", str(png)])
    assert out["checker_ratio"] == 12.5 and out["taus"] == [0.08, 0.0]
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    assert np.isfinite(out["param_err"]) and png.read_bytes().startswith(b"\x89PNG")
    hard = cli.main(["invert", "--device", "cpu", "--config", "4", "--size", "16", "--iters",
                     "2", "--log-every", "1", "--quiet"])
    assert len(hard["history"]) == 2 and np.isfinite(hard["param_err"])
    with pytest.raises(SystemExit):  # there is no config 11: argparse refuses it
        cli.main(["invert", "--device", "cpu", "--config", "11", "--size", "8"])
