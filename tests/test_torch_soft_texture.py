"""Object texel grids and the environment map in the soft renderer
(``soft_tau > 0``) and its eager twins, on the CPU, against the JAX package.

The cases, made from seeded numpy draws and carried over by the bridge:
  - ``field``: config 5 cut to 10 spheres at 24^2, each with an (8, 8, 3)
    grid uniform(0.1, 0.9) from default_rng(5) (the JAX package's
    tests/test_fused_vec_soft.py `_textured_soft_scene`);
  - ``config7``: config 7's textured floor at 24^2;
  - ``sky``: config 5 cut to 10 spheres under a (16, 16, 3) sky
    uniform(0.1, 0.9) from default_rng(7), the camera (0, 1.5, 9.5) ->
    (0, 2.5, 0) at 60 degrees (the JAX package's
    scripts/vec_textured_tpu_check.py softenv mode), at 24^2.

- the soft render (`render_eager_vec`, `pipeline_vec.shade_soft`) against
  `render_jnp_vec` at tau 0.05: within 1e-5 on the pixels away from an
  edge of either image (tests/test_torch_soft.py's mask), and at most 2% of
  the pixels beyond 1e-3 (the two packages' soft shadow products round apart
  at silhouettes, textured or not);
- a near-miss layer on config 8's globe at tau 0.2: the soft layer's base
  colour against the JAX package's `_gather_layer` at the same winners and
  ranks, within 1e-6, on the pixels whose layer is a sphere the ray misses,
  where (p - c) / r is longer than 1 and `sphere_uv` samples it without
  renormalising it, its y clamped inside 1 - 1e-6 (sampling the unit normal
  instead differs there by more than 1e-2);
- the eager twins of rows 9 and 8 (`loss_grad_vec_soft_adjoint_eager`,
  `render_vec_soft_bwd_adjoint_eager`: each layer's textured winner's texel
  record, the environment's at every pixel) against torch autograd of the
  soft render in float64, within 1e-9 of each leaf's scale, on the three
  cases and config 9 without its bounce; the soft forward's twin
  (`render_vec_soft_culled`) against the render bit for bit;
- the gradient of the soft render of the JAX package's smooth textured
  scene (config 2's four spheres, low-contrast 8 x 8 grids) held to its
  float64 autograd at the JAX test's tolerance, 2e-3 of the texels' largest
  (`jax.grad` of `render_jnp_vec` took 19 s to compile on the CPU: the JAX side is
  held to by the renders above);
- the bridge: each case leaf for leaf the JAX package's;
- `optimize_annealed` on config 7 at 16^2: two stages, finite and falling
  losses.

One JAX compile (the three renders and the near-miss layer, at XLA's backend
optimization level 0 without LLVM's expensive passes) runs in a thread from
the file's first test on; the JAX tests come last. The soft kernels' texel
instances are held to these plain versions on a card in
tests/test_torch_kernels.py and chip_smoke.py (phases soft_texture,
soft_texture_main).
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reversible_raytracer_tpu.models import configs as jconfigs
from reversible_raytracer_tpu.models.scene import Camera as JCamera
from reversible_raytracer_tpu.ops.pipeline import RenderConfig as JRenderConfig
from reversible_raytracer_tpu.ops.pipeline import camera_rays
from reversible_raytracer_tpu.ops.pipeline_vec import _gather_layer, _rect_ts, render_jnp_vec
from reversible_raytracer_tpu_torch.bridge import scene_from_numpy
from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.models.scene import (
    Camera,
    ParamSpec,
    leaf_paths,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from reversible_raytracer_tpu_torch.ops import pipeline as pl
from reversible_raytracer_tpu_torch.ops import pipeline_vec as pv
from reversible_raytracer_tpu_torch.ops.kernels import fused_vec_soft
from reversible_raytracer_tpu_torch.ops.pipeline import RenderConfig
from reversible_raytracer_tpu_torch.ops.pipeline_vec import render_eager_vec
from reversible_raytracer_tpu_torch.optim import OptConfig, optimize_annealed

SIZE, N_SPHERES, TAU = 24, 10, 0.05
CASES = ("field", "config7", "sky")
NEAR_TAU = 0.2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six test
    processes at once, and torch's default of a thread per core slows this
    file and the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_scene(case):
    """The JAX package's scene of a case."""
    if case == "config7":
        return jconfigs.config7_texture(SIZE)[0]
    if case == "config8":
        return jconfigs.config8_globe(SIZE)[0]
    js = jconfigs.config5_many_spheres(SIZE, n_spheres=N_SPHERES)[0]
    if case == "field":
        tex = np.random.default_rng(5).uniform(0.1, 0.9, (js.spheres.count, 8, 8, 3))
        return dataclasses.replace(js, spheres=dataclasses.replace(
            js.spheres, texture=jnp.asarray(tex, jnp.float32)))
    env = np.random.default_rng(7).uniform(0.1, 0.9, (16, 16, 3))
    return dataclasses.replace(js, env=jnp.asarray(env, jnp.float32),
                               camera=JCamera.make((0.0, 1.5, 9.5), (0.0, 2.5, 0.0),
                                                   fov_deg=60.0))


def _like(case):
    """The port's scene of a case's structure (its values come from the
    bridge)."""
    if case == "config7":
        return configs.config7_texture(SIZE, device="cpu")[0]
    if case == "config8":
        return configs.config8_globe(SIZE, device="cpu")[0]
    ts = configs.config5_many_spheres(SIZE, n_spheres=N_SPHERES, device="cpu")[0]
    if case == "field":
        return dataclasses.replace(ts, spheres=dataclasses.replace(
            ts.spheres, texture=torch.zeros((ts.spheres.count, 8, 8, 3))))
    return dataclasses.replace(ts, env=torch.zeros((16, 16, 3)),
                               camera=Camera.make((0.0, 1.5, 9.5), (0.0, 2.5, 0.0),
                                                  fov_deg=60.0, device="cpu"))


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _pair(case):
    """(JAX scene, the port's twin through the bridge)."""
    js = _jax_scene(case)
    return js, scene_from_numpy(_np_leaves(js), like=_like(case), device="cpu")


def _near_layers():
    """Config 8's globe at NEAR_TAU: the port's soft ranking (winners and
    ranks of both layers) and the pixels whose layer is the sphere, ranked at
    a near miss."""
    _, ts = _pair("config8")
    cfg = RenderConfig(height=SIZE, width=SIZE, shadows=True, soft_tau=NEAR_TAU)
    o, d = pl.primary_rays(ts, cfg)
    layers = pv.two_layers(ts, o, d, NEAR_TAU)
    c, r = pv.sphere_axis(ts.spheres)
    oc = pl.vm.vsub(pv._lead(o), c)
    b = pl.vm.vdot(oc, pv._lead(d))
    miss = (b * b - (pl.vm.vdot(oc, oc) - r * r) <= 0.0)[0]
    return ts, cfg, o, d, layers, [(k == 0) & miss for _, k in layers]


def _compile():
    """``f(field, config7, sky, config8, k1, t1, k2, t2) -> (the three soft
    images, the base colours of config 8's two layers by _gather_layer at the
    given winners and ranks)``, compiled at XLA's backend optimization level
    0 without LLVM's expensive passes."""
    cfg = JRenderConfig(height=SIZE, width=SIZE, shadows=True, soft_tau=TAU)
    ii, jj = jnp.meshgrid(jnp.arange(SIZE, dtype=jnp.float32),
                          jnp.arange(SIZE, dtype=jnp.float32), indexing="ij")

    def layers(s, ks, ts):
        o, d = camera_rays(s.camera, ii, jj, SIZE, SIZE, "perspective")
        o = tuple(jnp.broadcast_to(v, (SIZE, SIZE)) for v in o)
        d = tuple(jnp.broadcast_to(v, (SIZE, SIZE)) for v in d)
        _, ra, rb = _rect_ts(s, *o, *d)
        out = []
        for k, t in zip(ks, ts):
            at = _gather_layer(s, k, t, o, d, ra, rb)
            out.append(jnp.stack([at["cr"], at["cg"], at["cb"]], axis=-1))
        return out

    def f(a, b, c, g, k1, t1, k2, t2):
        return (*(render_jnp_vec(s, cfg) for s in (a, b, c)), *layers(g, (k1, k2), (t1, t2)))

    k = jnp.zeros((SIZE, SIZE), jnp.int32)
    t = jnp.zeros((SIZE, SIZE), jnp.float32)
    scenes = [_jax_scene(c) for c in (*CASES, "config8")]
    return jax.jit(f).lower(*scenes, k, t, k, t).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})


_COMPILED = {}


@pytest.fixture(autouse=True, scope="module")
def _start_jax_compile():
    """Start the file's one JAX compile in a thread as its first test starts:
    XLA compiles without holding the GIL, so the tests before the JAX ones
    run meanwhile."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        _COMPILED["f"] = pool.submit(_compile)
        yield


def _jax_outputs():
    """The compiled function's outputs (computed once)."""
    if "out" not in _COMPILED:
        _, _, _, _, layers, _ = _near_layers()
        args = [_jax_scene(c) for c in (*CASES, "config8")]
        for t, k in layers:
            args += [jnp.asarray(k.clamp(min=0).numpy(), jnp.int32),
                     jnp.asarray(torch.where(k >= 0, t, 0.0).numpy())]
        _COMPILED["out"] = [np.asarray(x) for x in _COMPILED["f"].result()(*args)]
    return _COMPILED["out"]


def _edge_mask(*images, thresh=0.02, dilate=1):
    """Pixels whose neighborhood contains a discontinuity in ANY image (a
    copy of tests/test_torch_soft.py's)."""
    e = np.zeros(images[0].shape[:2], bool)
    for img in images:
        for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)):
            e |= np.abs(img - np.roll(img, sh, axis=ax)).max(-1) > thresh
    for _ in range(dilate):
        for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)):
            e |= np.roll(e, sh, axis=ax)
    return e


def _errors(want, got):
    """Worst |got - want| / scale(want) per non-empty leaf."""
    return {path: float((b - a).abs().max()) / max(float(a.abs().max()), 1e-6)
            for path, a, b in zip(leaf_paths(got), tree_leaves(want), tree_leaves(got))
            if a.numel()}


def _f64(scene):
    return tree_map(lambda x: x.to(torch.float64), scene)


def _moved(case):
    """A case (or config 9 without its bounce) in float64, and a start with
    its texels, geometry, a light and the camera moved."""
    if case == "config9":
        ts = configs.config9_sky(SIZE, device="cpu")[0]
    else:
        ts = _pair(case)[1]
    spec = ParamSpec.none(ts)
    paths = ["spheres.center", "spheres.radius", "rects.origin", "rects.edge_u",
             "lights.position", "camera.eye", "camera.look_at", "camera.fov_deg"]
    for path in paths + [f"{g}.texture" for g in ("spheres", "rects")
                         if getattr(ts, g).textured] + (["env"] if ts.env_mapped else []):
        spec = spec.train(path, lower=-20.0, upper=20.0)
    return _f64(ts), _f64(configs.perturb(ts, spec, scale=0.02, seed=1))


def _texels(grads, scene):
    leaves = [grads.spheres.texture, grads.rects.texture] + ([grads.env] if scene.env_mapped
                                                             else [])
    return torch.cat([x.reshape(-1) for x in leaves])


@pytest.mark.parametrize("case", (*CASES, "config9"))
def test_twins_match_autograd_float64(case):
    scene, start = _moved(case)
    cfg = RenderConfig(height=20, width=24, shadows=True, soft_tau=TAU)
    fused_vec_soft.check_soft_kernel_config(scene, cfg, step=True)
    target = render_eager_vec(scene, cfg)
    l_t, g_t = fused_vec_soft.loss_grad_vec_soft_adjoint_eager(start, cfg, target)
    l_a, g_a = fused_vec_soft.loss_grad_vec_soft_plain(start, cfg, target)
    assert abs(float(l_t) - float(l_a)) <= 1e-12 * float(l_a)
    errs = _errors(g_a, g_t)
    assert max(errs.values()) <= 1e-9, errs
    assert bool(_texels(g_t, scene).any())
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(20, 24, 3)))
    got = fused_vec_soft.render_vec_soft_bwd_adjoint_eager(start, cfg, g)
    errs = _errors(fused_vec_soft.render_vec_soft_bwd_plain(start, cfg, g), got)
    assert max(errs.values()) <= 1e-9, errs
    assert bool(_texels(got, scene).any())
    assert torch.equal(fused_vec_soft.render_vec_soft_culled(start, cfg),
                       render_eager_vec(start, cfg))


def _sq_grad(scene, cfg):
    """torch.autograd of the summed squared soft render: each leaf's
    gradient."""
    leaves = [x.clone().requires_grad_(True) for x in tree_leaves(scene)]
    img = render_eager_vec(tree_unflatten(scene, leaves), cfg)
    return torch.autograd.grad((img * img).sum(), leaves, allow_unused=True,
                               materialize_grads=True)


def test_smooth_texel_gradient_float32_vs_float64():
    """The JAX test's scene (tests/test_fused_vec_soft.py:377-397, its
    `_textured_soft_scene(smooth=True)`): the float32 soft render's gradient
    of the summed squared image against float64's, every leaf within 2e-3
    of its scale (the texels' too), the texels' gradient not 0."""
    ts, _, _ = configs.config2_four_spheres(32, device="cpu")
    ii, jj = np.meshgrid(np.linspace(0, 1, 8), np.linspace(0, 1, 8), indexing="ij")
    base = np.stack([0.35 + 0.1 * ii, 0.4 + 0.08 * jj, 0.45 - 0.08 * ii], axis=-1)
    per = np.random.default_rng(5).uniform(0.9, 1.1, (ts.spheres.count, 1, 1, 1))
    ts = dataclasses.replace(ts, spheres=dataclasses.replace(
        ts.spheres, texture=torch.tensor(base[None] * per, dtype=torch.float32)))
    cfg = RenderConfig(height=32, width=32, shadows=True, soft_tau=TAU)
    g32, g64 = _sq_grad(ts, cfg), _sq_grad(_f64(ts), cfg)
    paths = leaf_paths(ts)
    errs = {p: float((a.double() - b).abs().max()) / max(float(b.abs().max()), 1e-6)
            for p, a, b in zip(paths, g32, g64) if b.numel()}
    assert max(errs.values()) <= 2e-3, errs
    assert float(g64[paths.index("spheres.texture")].abs().max()) > 0.0


def test_optimize_annealed_on_textures():
    """Config 7 at 16^2, its texels perturbed: the soft stage (tau 0.05,
    against the truth rendered at it) and the hard polish each run on the
    CPU with finite losses that fall."""
    scene, spec, cfg = configs.config7_texture(16, device="cpu")
    start = configs.perturb(scene, spec, scale=0.4, seed=0)
    iters = 6
    _, losses = optimize_annealed(start, render_eager_vec(scene, cfg), spec, cfg,
                                  OptConfig(iters=iters, lr=3e-2), taus=(0.05, 0.0),
                                  target_scene=scene)
    assert losses.shape == (2 * iters,) and torch.isfinite(losses).all()
    for stage in losses.reshape(2, iters):
        assert float(stage[-1]) < float(stage[0])


# ---- the JAX package (its one compile runs in a thread from the first test)


@pytest.mark.parametrize("case", (*CASES, "config8"))
def test_bridge_carries_the_scene(case):
    js, ts = _pair(case)
    for path, a, b in zip(leaf_paths(ts), _np_leaves(js), tree_leaves(ts)):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=path)
    assert fused_vec_soft.soft_kernel_ok(ts)


@pytest.mark.parametrize("case", CASES)
def test_soft_render_matches_jnp_vec(case):
    _, ts = _pair(case)
    got = render_eager_vec(ts, RenderConfig(height=SIZE, width=SIZE, shadows=True,
                                            soft_tau=TAU)).numpy()
    want = _jax_outputs()[CASES.index(case)]
    stable = ~_edge_mask(want, got)
    err = np.abs(got - want)
    assert stable.any() and err[stable].max() <= 1e-5, case
    assert (err.max(-1) > 1e-3).mean() <= 2e-2


def test_near_miss_layer_samples_the_unnormalised_normal():
    ts, cfg, o, d, layers, near = _near_layers()
    want = _jax_outputs()[len(CASES):]
    seen = 0
    for (t, k), mask, jax_base in zip(layers, near, want):
        _, _, at, _ = pv.soft_layer(ts, o, d, k, NEAR_TAU, cfg.shape)
        got = torch.stack([at["cr"], at["cg"], at["cb"]], dim=-1).numpy()
        m = mask.numpy()
        seen += int(m.sum())
        np.testing.assert_allclose(got[m], jax_base[m], rtol=0, atol=1e-6)
        # the unit normal's sample is another colour there
        p = pl.vm.vadd(o, pl.vm.vscale(d, t))
        n = pl.vm.vnormalize(pl.vm.vsub(p, pl.vm.splat(ts.spheres.center[0])))
        unit = pl.sample_texture(ts.spheres.texture[0], *pl.sphere_uv(n), wrap_a=True)
        unit = torch.stack(unit, dim=-1).numpy()
        assert np.abs(unit[m] - got[m]).max() > 1e-2
    assert seen >= 8
