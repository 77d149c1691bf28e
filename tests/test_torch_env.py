"""The environment map (config 9: a sky over a mirror sphere and a floor,
one bounce) in the port, on the CPU, against the JAX package.

- config 9 and its `perturb` leaf for leaf against the JAX package's (the
  sky's texels bit for bit);
- the eager render (`render_eager`: a missed ray's colour the sky's
  bilinear sample at the lat-long coordinates of its direction, at either
  bounce level) against the float64 numpy oracle at 16 texels a side, with
  the bounce and without, by the rule of tests/test_env.py (max < 1e-3,
  mean < 1e-5): the default view, one looking down -x into the atan2 seam,
  1 texel;
- the eager twins of rows 1 and 3 against torch autograd of `render_eager`
  in float64, from a start with the sky, camera, geometry and mirror
  coefficient moved, with the bounce and without: every leaf within 1e-9 of
  its scale; the sky's gradient comes from level 0's misses and, with the
  bounce, from the reflected rays' misses too; the background gets none;
- the env leaf through the numpy bridge, scene JSON and the npz checkpoint,
  both ways with the JAX package's;
- the CUDA route's refusals by name, and the CLI on the CPU;
- against the JAX package at 32^2, 4 texels a side, one bounce: the image of
  `render_jnp` by the oracle's rule, the twin of row 1 against the value and
  gradient of the mean squared error and the twin of row 3 against `jax.vjp`
  of a seeded normal cotangent zero next to a silhouette or a shadow's edge,
  every leaf within 1e-2 of its scale (the sky, camera and geometry), for the
  default view and the seam's. One compiled JAX function (the render and
  its vjp) compiles in a thread from the file's first test on (XLA's
  backend optimization level 0); the JAX tests come last.

The kernels themselves are held to these plain versions on a card in
tests/test_torch_kernels.py and chip_smoke.py (phases texture,
texture_main).
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
from reversible_raytracer_tpu.utils import checkpoint as jcheckpoint
from reversible_raytracer_tpu.utils import sceneio as jsceneio
from reversible_raytracer_tpu_torch import cli
from reversible_raytracer_tpu_torch.bridge import scene_from_numpy, scene_to_numpy
from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.models.scene import (
    ParamSpec,
    leaf_paths,
    tree_leaves,
    tree_map,
)
from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec
from reversible_raytracer_tpu_torch.ops.pipeline import RenderConfig, primary_rays
from reversible_raytracer_tpu_torch.ops.render import render_eager, resolve_impl
from reversible_raytracer_tpu_torch.utils import checkpoint, sceneio


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


# name: (the sky's side, a camera (eye, look_at) or None)
VIEWS = {
    "config9": (16, None),
    "config9_seam": (16, ((3.8, 0.6, 0.0), (0.0, 0.1, 0.0))),
    "config9_k1": (1, None),
}


def _pair(name, size=32, env_k=None, perturbed=None):
    """JAX's scene of the view (its sky moved by perturb(scale=0.4,
    seed=``perturbed``) if given) and the port's twin bridged through
    numpy."""
    k, cam = VIEWS[name]
    k = env_k or k
    js, jspec, _ = jconfigs.config9_sky(size, env_k=k)
    if cam is not None:
        js = dataclasses.replace(js, camera=dataclasses.replace(
            js.camera, eye=jnp.asarray(cam[0], jnp.float32),
            look_at=jnp.asarray(cam[1], jnp.float32)))
    if perturbed is not None:
        js = jconfigs.perturb(js, jspec, scale=0.4, seed=perturbed)
    like = configs.config9_sky(size, env_k=k, device="cpu")[0]
    return js, scene_from_numpy(_np_leaves(js), like=like, device="cpu")


def _errors(ref_leaves, got):
    """Worst |got - ref| / scale(ref) per non-empty leaf."""
    out = {}
    for path, a, b in zip(leaf_paths(got), ref_leaves, tree_leaves(got)):
        a = np.asarray(a, np.float64)
        if a.size:
            b = b.detach().numpy().astype(np.float64)
            out[path] = np.abs(b - a).max() / max(np.abs(a).max(), 1e-6)
    return out


def test_config9_and_perturb_match_jax():
    js, jspec, jcfg = jconfigs.config9_sky(24)
    ts, tspec, tcfg = configs.config9_sky(24, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for a, b in zip(_np_leaves(js), tree_leaves(ts)):
        np.testing.assert_array_equal(a, b.numpy())
    assert [bool(t) for t in jax.tree_util.tree_leaves(jspec.trainable)] == list(
        tree_leaves(tspec.trainable))
    for seed in (0, 9):
        jp = jconfigs.perturb(js, jspec, scale=0.4, seed=seed)
        tp = configs.perturb(ts, tspec, scale=0.4, seed=seed)
        for path, a, b in zip(leaf_paths(tp), _np_leaves(jp), tree_leaves(tp)):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=path)


@pytest.mark.parametrize("name", list(VIEWS))
@pytest.mark.parametrize("reflections", [0, 1])
def test_eager_render_matches_f64_oracle(name, reflections):
    _, ts = _pair(name)
    img = render_eager(ts, RenderConfig(height=32, width=32, reflections=reflections)).numpy()
    orc = ref.render(ts, 32, 32, reflections=reflections)
    assert np.abs(img - orc).max() < 1e-3
    assert np.abs(img - orc).mean() < 1e-5


def test_seam_view_covers_the_seam():
    """The seam view's missed rays straddle the atan2 seam (directions with x
    < 0, z = +-0: the camera on +x looks down -x)."""
    from reversible_raytracer_tpu_torch.ops.pipeline import sphere_uv, trace_nearest

    _, ts = _pair("config9_seam")
    cfg = RenderConfig(height=32, width=32)
    o, d = primary_rays(ts, cfg)
    miss = ~trace_nearest(ts, o, d, cfg.shape)[1]
    u = sphere_uv(d)[0][miss]
    assert (u < 0.02).any() and (u > 0.98).any()


def _moved(name):
    """The view at 20x24 in float64 with 4 texels a side (1 for the k1 view),
    and a start with the sky, camera, geometry and mirror coefficient
    moved."""
    _, ts = _pair(name, env_k=1 if VIEWS[name][0] == 1 else 4)
    spec = ParamSpec.none(ts)
    for path in ("env", "spheres.center", "spheres.radius", "spheres.material.mirror",
                 "spheres.material.ks", "rects.origin", "rects.edge_u", "rects.material.color",
                 "lights.position", "camera.eye", "camera.look_at", "camera.fov_deg",
                 "ambient"):
        spec = spec.train(path, lower=-20.0, upper=20.0)
    start = configs.perturb(ts, spec, scale=0.02, seed=1)
    f64 = lambda s: tree_map(lambda x: x.to(torch.float64), s)  # noqa: E731
    return f64(ts), f64(start)


@pytest.mark.parametrize("name", list(VIEWS))
@pytest.mark.parametrize("reflections", [0, 1])
@pytest.mark.parametrize("shadows, clip", [(True, True), (False, False)])
def test_adjoint_twins_match_autograd_float64(name, reflections, shadows, clip):
    scene, start = _moved(name)
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
    assert float(g_t.env.abs().max()) > 0.0 and not g_t.background.any()


def test_bounce_adds_sky_gradient():
    """With the bounce the sky's texels seen only in the mirror sphere get a
    gradient too (tests/test_env.py's live-texel rule, here at 4 texels)."""
    scene, start = _moved("config9")
    live = []
    for refl in (0, 1):
        cfg = RenderConfig(height=20, width=24, reflections=refl)
        g = fused.loss_grad_adjoint_eager(start, cfg, render_eager(scene, cfg) * 0.9)[1]
        live.append(g.env.abs() > 1e-12)
    assert int(live[1].sum()) > int(live[0].sum())


def test_env_leaf_round_trips_with_jax(tmp_path):
    js, jspec, _ = jconfigs.config9_sky(16, env_k=4)
    ts, _, _ = configs.config9_sky(16, env_k=4, device="cpu")
    moved = jconfigs.perturb(js, jspec, scale=0.4, seed=2)
    port = scene_from_numpy(_np_leaves(moved), like=ts, device="cpu")
    for a, b in zip(_np_leaves(moved), scene_to_numpy(port)):
        np.testing.assert_array_equal(a, b)
    path = str(tmp_path / "s.json")
    jsceneio.save_scene(path, moved)
    for a, b in zip(_np_leaves(moved), scene_to_numpy(sceneio.load_scene(path, ts))):
        np.testing.assert_array_equal(a, b)
    sceneio.save_scene(path, port)
    for a, b in zip(_np_leaves(moved), _np_leaves(jsceneio.load_scene(path, js))):
        np.testing.assert_array_equal(a, b)
    path = str(tmp_path / "c.npz")
    checkpoint.save(path, port, step=3)
    back, _, step = jcheckpoint.load(path, js)
    assert step == 3
    for a, b in zip(_np_leaves(moved), _np_leaves(back)):
        np.testing.assert_array_equal(a, b)
    jcheckpoint.save(path, moved, step=4)
    back, _, step = checkpoint.load(path, ts)
    assert step == 4
    for a, b in zip(_np_leaves(moved), scene_to_numpy(back)):
        np.testing.assert_array_equal(a, b)


def test_cuda_route_refuses_by_name():
    ts, spec, cfg = configs.config9_sky(16, env_k=4, device="cpu")
    assert resolve_impl(ts, cfg) == "eager"
    assert fused.uncovered(ts, cfg, texels=True) is None
    assert fused.uncovered(ts, cfg) == "environment maps"
    for kw in (dict(reflections=4), dict(spp=4, reflections=4)):
        assert "reflections > 3" in fused.uncovered(ts, dataclasses.replace(cfg, **kw),
                                                    texels=True)
    for kw in (dict(reflections=2), dict(spp=4, reflections=3)):  # the env with more bounces
        assert fused.uncovered(ts, dataclasses.replace(cfg, **kw), texels=True) is None
    # the env with and without its bounce at spp 1 and 4, in both hard families
    # (past 24 objects the object-chunked kernels)
    for spp in (1, 4):
        for refl in (0, 1):
            both = dataclasses.replace(cfg, spp=spp, reflections=refl)
            assert fused.uncovered(ts, both, texels=True) is None
            fused_vec.check_vec_kernel_config(ts, both)
    big = configs.config9_sky(16, env_k=48, device="cpu")[0]
    assert "a texel grid this large" in fused.uncovered(big, cfg, texels=True)
    # the soft kernels take the env without the bounce (the render at spp 4
    # too, the step at spp 1 only); the anneal's
    # soft stages refuse config 9's bounce by name, as the JAX package does
    from reversible_raytracer_tpu_torch.ops.kernels import fused_vec_soft
    from reversible_raytracer_tpu_torch.optim import OptConfig, optimize_annealed

    soft = dataclasses.replace(cfg, soft_tau=0.05, reflections=0)
    fused_vec_soft.check_soft_kernel_config(ts, soft, step=True)
    fused_vec_soft.check_soft_kernel_config(ts, dataclasses.replace(soft, spp=4))
    with pytest.raises(NotImplementedError, match="spp=4 in the soft step"):
        fused_vec_soft.check_soft_kernel_config(ts, dataclasses.replace(soft, spp=4), step=True)
    with pytest.raises(NotImplementedError, match="mirror reflections"):
        optimize_annealed(ts, render_eager(ts, cfg), spec, cfg, OptConfig(iters=1),
                          taus=(0.05, 0.0))


def test_cli_config9_on_cpu(tmp_path):
    from PIL import Image

    png = tmp_path / "r.png"
    cli.main(["render", "--device", "cpu", "--config", "9", "--size", "24", "-o", str(png)])
    scene, _, cfg = configs.config9_sky(24, device="cpu")
    want = np.clip(np.round(render_eager(scene, cfg).numpy() * 255.0), 0, 255)
    assert np.abs(np.asarray(Image.open(png)).astype(np.int32) - want).max() <= 1
    out = cli.main(["invert", "--device", "cpu", "--config", "9", "--size", "24", "--lr", "3e-2",
                    "--perturb", "0.4", "--iters", "12", "--log-every", "11", "--quiet"])
    hist = out["history"]
    assert hist[-1]["loss"] < 0.5 * hist[0]["loss"] and hist[-1]["param_err"] < hist[0][
        "param_err"]


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

JAX_SIZE = 32
JAX_K = 4


def _compile():
    """``f(scene, g) -> (image, vjp of g)`` of `render_jnp` at one bounce,
    compiled at XLA's backend optimization level 0."""
    cfg = JRenderConfig(height=JAX_SIZE, width=JAX_SIZE, shadows=True, reflections=1)

    def f(s, g):
        img, vjp = jax.vjp(lambda x: render_jnp(x, cfg), s)
        return img, vjp(g)[0]
    return jax.jit(f).lower(jconfigs.config9_sky(JAX_SIZE, env_k=JAX_K)[0],
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


def _edge_mask(scene, cfg, dilate=1):
    """Pixels next to a silhouette or a shadow's edge, at either level: a
    neighbour whose primary or reflected ray hits another object, or whose
    visibility differs."""
    from reversible_raytracer_tpu_torch.ops.pipeline import reflect_dir, shadow_origin

    o, d = primary_rays(scene, cfg)
    t, k = fused._nearest_chain(scene, o, d)
    zero = torch.zeros(cfg.shape)
    w = fused.winner_surface(scene, fused.winner_geometry(scene, k, zero), o, d, t, zero)
    k1 = fused._nearest_chain(scene, shadow_origin(o, d, t, w.n), reflect_dir(d, w.n))[1]
    ids = (k * 64 + torch.where(k >= 0, k1, -1)).numpy()
    vis = fused.render_fused_plain(scene, cfg)[1]  # each level's, where it hit
    L = scene.lights.count
    vis = torch.cat([vis[lv * L:(lv + 1) * L] * hit
                     for lv, hit in enumerate(fused.level_hits(scene, cfg))]).numpy()
    e = np.zeros(ids.shape, bool)
    for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)):
        e |= ids != np.roll(ids, sh, axis=ax)
        e |= (vis != np.roll(vis, sh, axis=ax + 1)).any(0)
    for _ in range(dilate):
        for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)):
            e |= np.roll(e, sh, axis=ax)
    return e


@pytest.mark.parametrize("name", ["config9", "config9_seam"])
def test_twins_match_jax(name):
    """The image against `render_jnp` by the oracle's rule; row 1's twin
    against the mse's value and gradient (each package's target its own
    render of the truth), row 3's against `jax.vjp` of an edge-masked seeded
    cotangent, every leaf within 1e-2 of its scale (the sky, camera and
    geometry)."""
    js, ts = _pair(name, JAX_SIZE, JAX_K)
    jstart, tstart = _pair(name, JAX_SIZE, JAX_K, perturbed=9)
    zero = jnp.zeros((JAX_SIZE, JAX_SIZE, 3))
    cfg = RenderConfig(height=JAX_SIZE, width=JAX_SIZE, reflections=1)
    f = _COMPILED["f"].result()
    target = f(js, zero)[0]
    img = f(jstart, zero)[0]
    err = np.abs(np.array(img) - render_eager(tstart, cfg).numpy())
    assert err.max() < 1e-3 and err.mean() < 1e-5
    resid = img - target
    g_ref = f(jstart, 2.0 * resid / resid.size)[1]
    l_t, g_t = fused.loss_grad_adjoint_eager(tstart, cfg, render_eager(ts, cfg))
    assert abs(float(l_t) - float(jnp.mean(resid * resid))) <= 1e-4 * float(jnp.mean(resid ** 2))
    errs = _errors(jax.tree_util.tree_leaves(g_ref), g_t)
    assert max(errs.values()) <= 1e-2, errs
    g = np.random.default_rng(0).normal(size=(JAX_SIZE, JAX_SIZE, 3)).astype(np.float32)
    g = g * ~_edge_mask(tstart, cfg)[..., None]
    ref_g = f(jstart, jnp.asarray(g))[1]
    got = fused.render_bwd_adjoint_eager(tstart, cfg, torch.from_numpy(g),
                                         fused.render_fused_plain(tstart, cfg)[1])
    errs = _errors(jax.tree_util.tree_leaves(ref_g), got)
    assert max(errs.values()) <= 1e-2, errs
    assert float(got.env.abs().max()) > 0.0 and float(got.camera.eye.abs().max()) > 0.0
