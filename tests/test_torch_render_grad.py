"""The render's gradient on the CPU: the eager twins of the three render
backward kernels against autograd and against the JAX package's `jax.vjp`,
the step and the backward sharing one adjoint, and `optimize(render_fn=)`.

- twin vs torch autograd, float64, a seeded normal cotangent, with and
  without shadows and clip: the vec and soft twins against autograd of
  `render_eager_vec` to 1e-10 of each leaf's scale (they agree to ~1e-14).
  The small-scene twin is held to the same autograd, which on scenes of at
  most 24 objects gives `render_eager`'s image bit for bit, at 1e-10; and
  to autograd of `render_eager` itself, the where-chain graph, at the same
  1e-10 (they agree to ~1e-14 since its rect normals keep the scene's
  dtype; before, a float32 sign took the rects' edges 6e-8 of scale off).
- twin vs `jax.vjp` of the JAX package's plain renderers, which the JAX
  suite holds its Pallas backwards to (tests/test_fused_vec.py): config 2
  at 40x72 through `render_jnp`, config 5 cut to 25 spheres at 26x26
  through `render_jnp_vec` (hard), and 16 spheres at 48x48 through its soft
  body `_render_soft` at tau 0.08, from perturb(seed) for seeds 0-2, with a
  normal cotangent drawn from the same seed; the soft one is zero on pixels
  next to an edge in either image (the edge mask of tests/test_torch_soft.py),
  where the soft render is not smooth. The trained half of the step tests'
  rule (tests/test_torch_step.py, tests/test_torch_vec_step.py): every
  trained leaf within 1e-2 of its scale at every seed. Their untrained
  half, every leaf at seed 0: the soft family under its edge-masked
  cotangent; the hard families under the same edge mask, because a
  cotangent that is dense on their limb pixels, where t = -b - sqrt(disc)
  magnifies the two frameworks' one-ulp ray differences without bound,
  takes an untrained leaf to 1.6e-2 of scale at seed 0 in both (printed,
  run with -s), while with those pixels masked every leaf agrees to 1e-5.
  The JAX side compiles one vjp per family, most of the file's time; the
  size of the image does not change that compile.
- the step's twin and the backward's twin with the mse cotangent 2 (img -
  target) / n: the same gradient to 1e-12 of scale in float64, as both run
  one adjoint per family.
- `optimize(render_fn=render_eager)` against `optimize()` over 5 steps.
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
from reversible_raytracer_tpu.ops.pipeline_vec import _render_soft, render_jnp_vec
from reversible_raytracer_tpu.ops.render import render_jnp
from reversible_raytracer_tpu_torch import optim
from reversible_raytracer_tpu_torch.bridge import scene_from_numpy
from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.models.scene import leaf_paths, tree_leaves, tree_map
from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec, fused_vec_soft
from reversible_raytracer_tpu_torch.ops.pipeline import RenderConfig
from reversible_raytracer_tpu_torch.ops.pipeline_vec import render_eager_vec
from reversible_raytracer_tpu_torch.ops.render import render, render_eager


def _errors(ref, got):
    """Worst |got - ref| / scale(ref) per non-empty leaf."""
    out = {}
    for path, a, b in zip(leaf_paths(got), ref, tree_leaves(got)):
        a = np.asarray(a, np.float64)
        if a.size:
            b = b.detach().numpy().astype(np.float64)
            out[path] = np.abs(b - a).max() / max(np.abs(a).max(), 1e-6)
    return out


def _f64(scene):
    return tree_map(lambda x: x.to(torch.float64), scene)


def _cotangent(shape, seed):
    return np.random.default_rng(seed).normal(size=shape)


# ---------------------------------------------------------------------------
# The twins against torch autograd (float64)
# ---------------------------------------------------------------------------


def _family_case(family, shadows, clip):
    """(scene, start scene, config) of a family at a small size, in float64."""
    if family == "fused":
        scene, spec, _ = configs.config2_four_spheres(device="cpu")
        cfg = RenderConfig(height=20, width=36, shadows=shadows, clip=clip)
        scale = 0.1
    elif family == "vec":
        scene, spec, _ = configs.config5_many_spheres(size=20, n_spheres=25, device="cpu")
        cfg = RenderConfig(height=20, width=22, shadows=shadows, clip=clip)
        scale = 0.1
    else:
        scene, spec, _ = configs.config5_many_spheres(size=24, n_spheres=12, device="cpu")
        cfg = RenderConfig(height=24, width=20, shadows=shadows, clip=clip, soft_tau=0.05)
        scale = 0.05
    return _f64(scene), _f64(configs.perturb(scene, spec, scale=scale, seed=4)), cfg


def _twin(family, scene, cfg, g):
    """The family's eager backward twin, given the forward's planes."""
    if family == "fused":
        return fused.render_bwd_adjoint_eager(scene, cfg, g,
                                              fused.render_fused_plain(scene, cfg)[1])
    if family == "vec":
        return fused_vec.render_vec_bwd_adjoint_eager(scene, cfg, g,
                                                      fused_vec.render_vec_plain(scene, cfg)[1])
    return fused_vec_soft.render_vec_soft_bwd_adjoint_eager(scene, cfg, g)


@pytest.mark.parametrize("family", ["fused", "vec", "soft"])
@pytest.mark.parametrize("shadows, clip", [(True, True), (False, True), (True, False)])
def test_bwd_twin_matches_autograd_float64(family, shadows, clip):
    _, start, cfg = _family_case(family, shadows, clip)
    g = torch.from_numpy(_cotangent((cfg.height, cfg.width, 3), 0))
    got = _twin(family, start, cfg, g)
    ref = fused.autograd_vjp(render_eager_vec, start, cfg, g)
    errs = _errors([x.numpy() for x in tree_leaves(ref)], got)
    assert max(errs.values()) <= 1e-10, errs
    assert float(got.spheres.center.abs().max()) > 0.0
    print(f"{family} vs render_eager_vec: {max(errs.values()):.1e} of scale")
    if family == "fused":
        ref = fused.render_fused_bwd_plain(start, cfg, g)  # autograd of render_eager
        errs = _errors([x.numpy() for x in tree_leaves(ref)], got)
        assert max(errs.values()) <= 1e-10, errs
        print(f"fused vs render_eager: {max(errs.values()):.1e} of scale")


@pytest.mark.parametrize("family", ["fused", "vec", "soft"])
def test_step_and_backward_twins_share_one_adjoint(family):
    """With the mse cotangent the backward twin gives the step twin's
    gradient (float64, 1e-12 of scale)."""
    scene, start, cfg = _family_case(family, True, True)
    target = render_eager_vec(scene, cfg)
    img = render_eager_vec(start, cfg)
    g = 2.0 * (img - target) / img.numel()
    step = {"fused": fused.loss_grad_adjoint_eager, "vec": fused_vec.loss_grad_vec_adjoint_eager,
            "soft": fused_vec_soft.loss_grad_vec_soft_adjoint_eager}[family]
    _, g_step = step(start, cfg, target, "mse")
    errs = _errors([x.numpy() for x in tree_leaves(g_step)], _twin(family, start, cfg, g))
    assert max(errs.values()) <= 1e-12, errs


# ---------------------------------------------------------------------------
# The twins against jax.vjp of the JAX package's plain renderers
# ---------------------------------------------------------------------------


def _bridge(jscene, like):
    return scene_from_numpy([np.asarray(x) for x in jax.tree_util.tree_leaves(jscene)], like=like,
                            device="cpu")


def _edge_mask(*images, thresh=0.02, dilate=1):
    """Pixels whose neighborhood contains a discontinuity in any image (a
    copy of tests/test_fused_vec.py's)."""
    e = np.zeros(images[0].shape[:2], bool)
    for img in images:
        for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)):
            e |= np.abs(img - np.roll(img, sh, axis=ax)).max(-1) > thresh
    for _ in range(dilate):
        for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)):
            e |= np.roll(e, sh, axis=ax)
    return e


# family: (JAX scene factory, port scene factory, perturb scale, (H, W))
JAX_CASES = {
    "fused": (lambda: jconfigs.config2_four_spheres(),
              lambda: configs.config2_four_spheres(device="cpu"), 0.1, (40, 72)),
    "vec": (lambda: jconfigs.config5_many_spheres(size=26, n_spheres=25),
            lambda: configs.config5_many_spheres(size=26, n_spheres=25, device="cpu"), 0.1,
            (26, 26)),
    "soft": (lambda: jconfigs.config5_many_spheres(48, n_spheres=16),
             lambda: configs.config5_many_spheres(48, n_spheres=16, device="cpu"), 0.05,
             (48, 48)),
}


@functools.lru_cache(maxsize=None)
def _jax_vjp(family):
    """``f(scene, cotangent) -> (image, scene cotangent)`` of the family's
    JAX renderer, jitted once per process."""
    H, W = JAX_CASES[family][3]
    if family == "soft":
        jcfg = JRenderConfig(height=H, width=W, shadows=True, soft_tau=0.08)
        render = lambda s: _render_soft(s, jcfg)  # noqa: E731
    else:
        jcfg = JRenderConfig(height=H, width=W, shadows=True)
        render = (lambda s: render_jnp(s, jcfg)) if family == "fused" else (
            lambda s: render_jnp_vec(s, jcfg))

    def f(s, g):
        img, vjp = jax.vjp(render, s)
        return img, vjp(g)[0]
    return jax.jit(f)


def _jax_errors(family, seed, mask_edges):
    """Per-leaf errors of the family's twin against `jax.vjp` at ``seed``,
    with the cotangent zero on edge pixels if ``mask_edges``; and the
    trainable flag of each leaf."""
    jfactory, tfactory, scale, (H, W) = JAX_CASES[family]
    js, jspec, _ = jfactory()
    like, spec, _ = tfactory()
    jstart = jconfigs.perturb(js, jspec, scale=scale, seed=seed)
    tstart = _bridge(jstart, like)
    cfg = RenderConfig(height=H, width=W, shadows=True, soft_tau=0.08 if family == "soft" else 0.0)
    g = _cotangent((H, W, 3), seed).astype(np.float32)
    vjp = _jax_vjp(family)
    img, ref = vjp(jstart, jnp.asarray(g))
    if mask_edges:
        g = g * (~_edge_mask(np.asarray(img), render_eager_vec(tstart, cfg).numpy()))[..., None]
        ref = vjp(jstart, jnp.asarray(g))[1]
    got = _twin(family, tstart, cfg, torch.from_numpy(g))
    errs = _errors(jax.tree_util.tree_leaves(ref), got)
    return errs, dict(zip(leaf_paths(got), tree_leaves(spec.trainable)))


@pytest.mark.parametrize("family", ["fused", "vec", "soft"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bwd_twin_matches_jax_vjp(family, seed):
    """Every trained leaf within 1e-2 of its scale at every seed, the soft
    family's cotangent edge-masked. The soft family's untrained leaves too
    at seed 0. The hard families' untrained leaves are printed here and
    held at seed 0 by `test_hard_bwd_twin_matches_jax_vjp_off_edges`: with
    this dense cotangent config 2's `camera.up` reaches 1.6e-2 of scale and
    config 5's `spheres.material.shininess` 1.6e-2."""
    errs, trained = _jax_errors(family, seed, mask_edges=family == "soft")
    held = {p: e for p, e in errs.items() if trained[p] or (family == "soft" and seed == 0)}
    assert max(held.values()) <= 1e-2, held
    for p, e in errs.items():
        if p not in held:
            print(f"{family} seed {seed} untrained {p}: {e:.3e} of scale")


@pytest.mark.parametrize("family", ["fused", "vec"])
def test_hard_bwd_twin_matches_jax_vjp_off_edges(family):
    """The untrained half of the step tests' rule for the hard families:
    at seed 0, with the cotangent zero on pixels next to an edge (limbs,
    shadow boundaries) in either image, every leaf within 1e-2 of its
    scale. The dense cotangent's 1.6e-2 (test_bwd_twin_matches_jax_vjp)
    comes from those pixels."""
    errs, _ = _jax_errors(family, 0, mask_edges=True)
    print(f"{family} seed 0 edge-masked: worst {max(errs, key=errs.get)} "
          f"{max(errs.values()):.3e} of scale")
    assert max(errs.values()) <= 1e-2, errs


# ---------------------------------------------------------------------------
# The render's gradient on the CPU, and the trainer through a renderer
# ---------------------------------------------------------------------------


def test_cpu_render_grad_is_the_plain_version():
    """On CPU tensors `render`'s gradient, for an expanded (stride-0)
    cotangent, is each family's plain version (autograd of the eager
    render); the cotangent the kernels read is made contiguous float32 from
    such a view."""
    scene, _, _ = configs.config5_many_spheres(size=16, n_spheres=9, device="cpu")
    big, _, _ = configs.config5_many_spheres(size=16, n_spheres=25, device="cpu")
    cfg = RenderConfig(height=16, width=16, shadows=True)
    soft = dataclasses.replace(cfg, soft_tau=0.05)
    g = torch.ones(()).expand(16, 16, 3)
    for plain, s, c in ((fused.render_fused_bwd_plain, scene, cfg),
                        (fused_vec.render_vec_bwd_plain, big, cfg),
                        (fused_vec_soft.render_vec_soft_bwd_plain, scene, soft)):
        for a, b in zip(tree_leaves(fused.autograd_vjp(render, s, c, g)),
                        tree_leaves(plain(s, c, g))):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    c = fused.cotangent_f32(g.to(torch.float64), cfg)
    assert c.dtype == torch.float32 and c.is_contiguous() and c.stride() == (48, 3, 1)
    with pytest.raises(ValueError):
        fused.cotangent_f32(g[:-1], cfg)
    with pytest.raises(ValueError):
        fused.render_bwd_adjoint_eager(scene, cfg, g[:-1], torch.ones((1, 16, 16)))


def test_optimize_through_render_fn_matches_the_step():
    """`optimize(render_fn=...)` (autograd of the loss over the renderer, the
    JAX package's `make_step` route) gives `optimize()`'s losses."""
    scene, spec, _ = configs.config2_four_spheres(device="cpu")
    cfg = RenderConfig(height=16, width=16, shadows=True)
    target = render_eager(scene, cfg)
    start = configs.perturb(scene, spec, scale=0.1, seed=1)
    ocfg = optim.OptConfig(iters=5, lr=2e-2)
    _, _, by_step = optim.optimize(start, target, spec, cfg, ocfg, log_every=0)
    final, _, by_render = optim.optimize(start, target, spec, cfg, ocfg, log_every=0,
                                         render_fn=lambda s: render_eager(s, cfg))
    np.testing.assert_allclose(by_render.numpy(), by_step.numpy(), rtol=1e-6, atol=0)
    assert float(by_render[-1]) < float(by_render[0])
    assert all(torch.isfinite(x).all() for x in tree_leaves(final))
