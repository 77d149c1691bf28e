"""Mirror reflections (``RenderConfig.reflections``, each object's ``mirror``
coefficient) and config 6 in the port, on the CPU, against the JAX package.

- the eager reflective render (`render_eager`, the where chain) against the
  float64 numpy oracle `oracle.reference_np.render(..., reflections=R)` at
  R = 0, 1, 2 on config 6's scene at 48x48, by the rule of
  tests/test_reflections.py (max < 1e-3, mean < 1e-5); the object-vectorized
  `render_eager_vec` (`shade_vec`) gives its bits at R = 1, spp 1 and 4;
- reflections = 0 keeps the non-reflective bits: config 6's scene renders
  at R = 0 as with every mirror coefficient 0, and so does R = 1 with every
  coefficient 0 (the blend adds m (col1 - col0) = 0 before the one clip);
- the eager twin of the kernels' adjoint (`fused._adjoint` through
  `loss_grad_adjoint_eager` and `render_bwd_adjoint_eager`) with and without
  the bounce against torch autograd of `render_eager`, in float64, from a
  start with every geometry, material and light leaf moved: every leaf within
  1e-9 of its scale (they agree to ~1e-14);
- the CLI: `render --config 6`, `--reflections 0` overriding config 6, and a
  short `invert --config 6` whose mirror RMS error falls;
- the refusals by name: reflections with soft_tau or checker_tau; on the
  CUDA route (`fused.uncovered`) four levels at spp 1 and 4 (spp 4 with one
  to three levels is covered), in both hard families; `optimize_annealed` with a soft
  stage;
- against the JAX package: `loss_grad_adjoint_eager` against the value and
  gradient of the mean squared error of `render_jnp` at R = 1 (48x48, from
  perturb(scale 0.3, seed) of the trained mirror leaves, seeds 0-2; the
  trained leaves held at every seed, every leaf at seed 0 and the diffuse
  sphere's centre, seen directly and in the chrome sphere and the floor, row
  by row), the loss within 1e-4 relative; and `render_bwd_adjoint_eager`
  against `jax.vjp` for a seeded normal cotangent zero on pixels next to an
  edge in either image (the rule of tests/test_torch_render_grad.py), every
  leaf within 1e-2 of its scale, and the image against `render_jnp`'s by the
  oracle's rule. One compiled JAX function serves all three: the render and
  its vjp, applied to the mse's cotangent 2 (img - target) / n (the gradient
  `jax.value_and_grad` gives) and to the test's cotangent. Its compile (10-13
  s on a CPU, most of this file's time; at XLA's backend optimization level
  0) runs in a thread from the file's first test on, beside the tests
  above, and the JAX tests come last.

The kernels themselves are held to these plain versions on a card in
tests/test_torch_kernels.py and chip_smoke.py (phases mirror, mirror_main).
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reversible_raytracer_tpu.models import configs as jconfigs
from reversible_raytracer_tpu.ops.pipeline import RenderConfig as JRenderConfig
from reversible_raytracer_tpu.ops.render import render_jnp
from reversible_raytracer_tpu.oracle import reference_np as ref
from reversible_raytracer_tpu_torch import cli, optim
from reversible_raytracer_tpu_torch.bridge import scene_from_numpy
from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.models.scene import (
    ParamSpec,
    leaf_paths,
    tree_leaves,
    tree_map,
)
from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec
from reversible_raytracer_tpu_torch.ops.pipeline import RenderConfig
from reversible_raytracer_tpu_torch.ops.pipeline_vec import render_eager_vec
from reversible_raytracer_tpu_torch.ops.render import render_eager, resolve_impl


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six test
    processes at once, and torch's default of a thread per core slows this
    file and the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _pair(size=48, seed=None):
    """JAX's config 6 (its mirror leaves perturbed by ``seed`` if given) and
    the port's twin bridged through numpy."""
    js, jspec, _ = jconfigs.config6_mirror(size)
    if seed is not None:
        js = jconfigs.perturb(js, jspec, scale=0.3, seed=seed)
    like, _, _ = configs.config6_mirror(size, device="cpu")
    return js, scene_from_numpy(_np_leaves(js), like=like, device="cpu")


def _zero_mirrors(scene):
    sp, rc = scene.spheres, scene.rects
    return dataclasses.replace(
        scene,
        spheres=dataclasses.replace(sp, material=dataclasses.replace(
            sp.material, mirror=torch.zeros_like(sp.material.mirror))),
        rects=dataclasses.replace(rc, material=dataclasses.replace(
            rc.material, mirror=torch.zeros_like(rc.material.mirror))))


def _errors(ref_leaves, got):
    """Worst |got - ref| / scale(ref) per non-empty leaf."""
    out = {}
    for path, a, b in zip(leaf_paths(got), ref_leaves, tree_leaves(got)):
        a = np.asarray(a, np.float64)
        if a.size:
            b = b.detach().numpy().astype(np.float64)
            out[path] = np.abs(b - a).max() / max(np.abs(a).max(), 1e-6)
    return out


# ---------------------------------------------------------------------------
# The eager reflective render
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reflections", [0, 1, 2])
def test_eager_render_matches_f64_oracle(reflections):
    js, ts = _pair()
    img = render_eager(ts, RenderConfig(height=48, width=48, reflections=reflections)).numpy()
    orc = ref.render(js, 48, 48, reflections=reflections)
    assert np.abs(img - orc).max() < 1e-3
    assert np.abs(img - orc).mean() < 1e-5


@pytest.mark.parametrize("spp", [1, 4])
def test_shade_vec_matches_shade(spp):
    """The object-vectorized levels (`render_eager_vec`, the CPU path of
    reflective scenes of more than 24 objects) give the where chain's bits."""
    _, ts = _pair(24)
    cfg = RenderConfig(height=24, width=20, reflections=1, spp=spp)
    a, b = render_eager(ts, cfg), render_eager_vec(ts, cfg)
    assert torch.equal(a, b)
    assert not torch.equal(a, render_eager(ts, dataclasses.replace(cfg, reflections=0)))


def test_mirror_gradient_where_the_coefficient_is_0():
    """The diffuse sphere's coefficient is 0 in config 6: towards an image
    in which it reflects (perturb seed 1: 0.246) it still has a gradient,
    d col / d m = col1 - col0, from the bounce traced where m = 0; the twin
    gives autograd's in float64."""
    scene, _, _ = configs.config6_mirror(24, device="cpu")
    _, up = _pair(24, seed=1)
    f64 = lambda s: tree_map(lambda x: x.to(torch.float64), s)  # noqa: E731
    scene, up = f64(scene), f64(up)
    cfg = RenderConfig(height=24, width=24, reflections=1)
    target = render_eager(up, cfg)
    _, g_t = fused.loss_grad_adjoint_eager(scene, cfg, target)
    _, g_a = fused.loss_grad_fused_plain(scene, cfg, target)
    assert float(scene.spheres.material.mirror[1]) == 0.0
    got, want = float(g_t.spheres.material.mirror[1]), float(g_a.spheres.material.mirror[1])
    assert want < 0.0 and abs(got - want) <= 1e-9 * abs(want)


def test_reflections_zero_keeps_the_non_reflective_bits():
    _, ts = _pair(32)
    cfg0 = RenderConfig(height=32, width=32, reflections=0)
    plain = render_eager(_zero_mirrors(ts), cfg0)
    assert torch.equal(render_eager(ts, cfg0), plain)
    assert torch.equal(render_eager(_zero_mirrors(ts), dataclasses.replace(cfg0, reflections=1)),
                       plain)
    img, vis = fused.render_fused(ts, cfg0)
    assert torch.equal(img, plain) and vis.shape == (1, 32, 32)
    img1, vis1 = fused.render_fused(ts, dataclasses.replace(cfg0, reflections=1))
    assert vis1.shape == (2, 32, 32) and torch.equal(vis1[:1], vis)
    assert float((img1 - img).abs().max()) > 0.1


# ---------------------------------------------------------------------------
# The adjoint twin against autograd (float64)
# ---------------------------------------------------------------------------


def _moved_start():
    """Config 6 at 20x24 in float64, from a start with every geometry,
    material and light leaf moved, so that every leaf has a gradient."""
    scene, _, _ = configs.config6_mirror(24, device="cpu")
    spec = ParamSpec.none(scene)
    for path in ("spheres.center", "spheres.radius", "spheres.material.color",
                 "spheres.material.ks", "spheres.material.mirror", "rects.origin",
                 "rects.material.color", "rects.material.mirror", "lights.position",
                 "lights.color", "camera.eye", "ambient"):
        spec = spec.train(path, lower=-20.0, upper=20.0)
    start = configs.perturb(scene, spec, scale=0.02, seed=1)
    f64 = lambda s: tree_map(lambda x: x.to(torch.float64), s)  # noqa: E731
    return f64(scene), f64(start)


@pytest.mark.parametrize("reflections", [0, 1])
@pytest.mark.parametrize("shadows, clip", [(True, True), (False, False)])
def test_adjoint_twins_match_autograd_float64(reflections, shadows, clip):
    scene, start = _moved_start()
    cfg = RenderConfig(height=20, width=24, shadows=shadows, clip=clip, reflections=reflections)
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(20, 24, 3)))
    got = fused.render_bwd_adjoint_eager(start, cfg, g, fused.render_fused_plain(start, cfg)[1])
    want = fused.autograd_vjp(render_eager, start, cfg, g)
    errs = _errors([x.numpy() for x in tree_leaves(want)], got)
    assert max(errs.values()) <= 1e-9, errs
    target = render_eager(scene, cfg)
    l_t, g_t = fused.loss_grad_adjoint_eager(start, cfg, target)
    l_a, g_a = fused.loss_grad_fused_plain(start, cfg, target)
    assert abs(float(l_t) - float(l_a)) <= 1e-12 * float(l_a)
    errs = _errors([x.numpy() for x in tree_leaves(g_a)], g_t)
    assert max(errs.values()) <= 1e-9, errs
    mirror = float(g_t.spheres.material.mirror.abs().max())
    assert (mirror > 0.0) == bool(reflections)


# ---------------------------------------------------------------------------
# The CLI, and the refusals
# ---------------------------------------------------------------------------


def test_cli_config6_on_cpu(tmp_path):
    from PIL import Image

    one, zero = tmp_path / "one.png", tmp_path / "zero.png"
    cli.main(["render", "--device", "cpu", "--config", "6", "--size", "24", "-o", str(one)])
    cli.main(["render", "--device", "cpu", "--config", "6", "--size", "24", "--reflections", "0",
              "-o", str(zero)])
    a, b = (np.asarray(Image.open(p)).astype(np.int32) for p in (one, zero))
    scene, _, cfg = configs.config6_mirror(24, device="cpu")
    want = np.clip(np.round(render_eager(scene, dataclasses.replace(cfg, reflections=0)).numpy()
                            * 255.0), 0, 255)
    assert np.abs(b - want).max() <= 1 and np.abs(a - b).max() > 25
    out = cli.main(["invert", "--device", "cpu", "--config", "6", "--size", "24", "--perturb",
                    "0.3", "--lr", "2e-2", "--iters", "15", "--seed", "3", "--log-every", "14"])
    errs = [h["param_err"] for h in out["history"]]
    assert errs[-1] < 0.5 * errs[0] and out["param_err"] < 0.5 * errs[0]


def test_reflections_refused_by_name():
    ts, spec, cfg = configs.config6_mirror(16, device="cpu")
    assert resolve_impl(ts, cfg) == "eager"
    for kw in (dict(soft_tau=0.05), dict(checker_tau=0.5)):
        with pytest.raises(NotImplementedError, match="mirror reflections require hard"):
            render_eager_vec(ts, dataclasses.replace(cfg, **kw))
    with pytest.raises(NotImplementedError, match="mirror reflections require hard"):
        render_eager(ts, dataclasses.replace(cfg, soft_tau=0.05))
    assert fused.uncovered(ts, cfg) is None
    assert "reflections > 3" in fused.uncovered(ts, dataclasses.replace(cfg, reflections=4))
    for refl in (2, 3):  # two and three bounce levels, at spp 1 and 4, in both hard families
        for spp in (1, 4):
            more = dataclasses.replace(cfg, reflections=refl, spp=spp)
            assert fused.uncovered(ts, more) is None
            fused_vec.check_vec_kernel_config(ts, more)
    assert fused.uncovered(ts, dataclasses.replace(cfg, spp=4)) is None  # spp 4 with the bounce
    fused_vec.check_vec_kernel_config(ts, cfg)  # one bounce level in rows 4-6 too
    fused_vec.check_vec_kernel_config(ts, dataclasses.replace(cfg, spp=4))
    for kw, why in ((dict(reflections=4), "reflections > 3"),
                    (dict(spp=4, reflections=4), "reflections > 3")):
        with pytest.raises(NotImplementedError, match=why):
            fused_vec.check_vec_kernel_config(ts, dataclasses.replace(cfg, **kw))
    target = render_eager(ts, cfg)
    with pytest.raises(NotImplementedError, match="mirror reflections require hard"):
        optim.optimize_annealed(ts, target, spec, cfg, optim.OptConfig(iters=1),
                                taus=(0.05, 0.0))


# ---------------------------------------------------------------------------
# The adjoint twin against the JAX package
# ---------------------------------------------------------------------------

JAX_SIZE = 48


def _compile():
    """``f(scene, g) -> (image, vjp of g)`` of `render_jnp` at reflections 1,
    compiled at XLA's backend optimization level 0."""
    cfg = JRenderConfig(height=JAX_SIZE, width=JAX_SIZE, shadows=True, reflections=1)

    def f(s, g):
        img, vjp = jax.vjp(lambda x: render_jnp(x, cfg), s)
        return img, vjp(g)[0]
    return jax.jit(f).lower(jconfigs.config6_mirror(JAX_SIZE)[0],
                            jnp.zeros((JAX_SIZE, JAX_SIZE, 3))).compile(
        compiler_options={"xla_backend_optimization_level": 0})


_COMPILED = {}


@pytest.fixture(autouse=True, scope="module")
def _start_jax_compile():
    """Start the file's one JAX compile in a thread as its first test starts:
    XLA compiles without holding the GIL, so the tests before the JAX ones
    run meanwhile."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        _COMPILED["f"] = pool.submit(_compile)
        yield


def _jax_fn():
    return _COMPILED["f"].result()


def _jax_value_and_grad(js, target):
    """(image, mse, its gradient) of `render_jnp` against ``target``: the
    gradient is the vjp of the mse's cotangent 2 (img - target) / n."""
    img = _jax_fn()(js, jnp.zeros((JAX_SIZE, JAX_SIZE, 3)))[0]
    resid = img - target
    return img, jnp.mean(resid * resid), _jax_fn()(js, 2.0 * resid / resid.size)[1]


def _jax_case(seed):
    js, _ = _pair(JAX_SIZE)
    jstart, tstart = _pair(JAX_SIZE, seed)
    cfg = RenderConfig(height=JAX_SIZE, width=JAX_SIZE, shadows=True, reflections=1)
    target = _jax_fn()(js, jnp.zeros((JAX_SIZE, JAX_SIZE, 3)))[0]
    return jstart, tstart, cfg, target


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_twin_matches_jax_value_and_grad(seed):
    jstart, tstart, cfg, target = _jax_case(seed)
    img, l_ref, g_ref = _jax_value_and_grad(jstart, target)
    l_t, g_t = fused.loss_grad_adjoint_eager(tstart, cfg, torch.from_numpy(np.array(target)))
    assert abs(float(l_t) - float(l_ref)) <= 1e-4 * float(l_ref)
    ref_leaves = jax.tree_util.tree_leaves(g_ref)
    errs = _errors(ref_leaves, g_t)
    trained = dict(zip(leaf_paths(g_t), tree_leaves(configs.config6_mirror(8, "cpu")[1].trainable)))
    held = {p: e for p, e in errs.items() if trained[p] or seed == 0}
    assert held and max(held.values()) <= 1e-2, held
    if seed == 1:  # the diffuse sphere's coefficient moved off 0 (to 0.246), row by row
        want = float(np.asarray(dict(zip(leaf_paths(g_t), ref_leaves))
                                ["spheres.material.mirror"])[1])
        got = float(g_t.spheres.material.mirror[1])
        assert want > 0.0 and abs(got - want) <= 1e-2 * want
    if seed == 0:
        # the diffuse sphere's centre, row by row
        want = np.asarray(dict(zip(leaf_paths(g_t), ref_leaves))["spheres.center"])[1]
        got = g_t.spheres.center[1].numpy()
        assert np.abs(want).max() > 0.0
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
        err = np.abs(np.array(img) - render_eager(tstart, cfg).numpy())
        assert err.max() < 1e-3 and err.mean() < 1e-5  # the rule against the oracle


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


def test_bwd_twin_matches_jax_vjp():
    jstart, tstart, cfg, target = _jax_case(0)
    g = np.random.default_rng(0).normal(size=(JAX_SIZE, JAX_SIZE, 3)).astype(np.float32)
    img = _jax_fn()(jstart, jnp.asarray(g))[0]
    tvis = fused.render_fused_plain(tstart, cfg)
    keep = ~_edge_mask(np.asarray(img), tvis[0].numpy())
    assert keep.mean() > 0.25  # the checkered floor and its reflections are edges
    g = g * keep[..., None]
    ref_g = _jax_fn()(jstart, jnp.asarray(g))[1]
    got = fused.render_bwd_adjoint_eager(tstart, cfg, torch.from_numpy(g), tvis[1])
    errs = _errors(jax.tree_util.tree_leaves(ref_g), got)
    assert max(errs.values()) <= 1e-2, errs
    assert float(got.spheres.material.mirror[0].abs()) > 0.0
    assert float(got.rects.material.mirror[0].abs()) > 0.0
