"""Config 10 (64 chrome spheres under a sky, one bounce) and the
object-chunked family's environment map and bounce level, on the CPU,
against the JAX package.

- config 10 and its `perturb` leaf for leaf against the JAX package's (the
  sky's texels and the mirror coefficients bit for bit), at its full size
  and at the cut the tests render (25 spheres, so 26 objects take the
  object-chunked route, and an 8 x 8 sky);
- the object-vectorized eager render (`render_eager_vec`: the sky at either
  level's misses) against `render_jnp_vec` at 32^2 by the oracle's rule,
  with the bounce and without; and the forward kernel's eager twin
  (`render_vec_culled`) against its plain version, the image and the 2 L
  planes (level 1's zero where either level missed) bit for bit;
- the eager twins of rows 5 and 6 (`render_vec_bwd_adjoint_eager`,
  `loss_grad_vec_adjoint_eager`: level 1 over every sphere, its shadow rays
  culled, the env's texel records, the mirror column) against torch autograd
  of `render_eager_vec` in float64, with the bounce and without: every leaf
  within 1e-9 of its scale;
- the same twins against the JAX package at 32^2: row 6's against the value
  and gradient of the mean squared error, row 5's against `jax.vjp` of a
  seeded normal cotangent zero next to an edge of either level or of a
  shadow, every leaf within 1e-2 of its scale;
- the packed globals with the env last, and the transpose of the packing;
- the routes: the object-chunked kernels take the env and one bounce at spp
  1 and 4 with one to three bounces, and refuse four by name, at either spp
  and with object textures too;
- the CLI: `invert --config 10` on the CPU.

One compiled JAX function (both renders and the bounce's vjp, at XLA's
backend optimization level 0) compiles in a thread from the file's first
test on; the JAX tests come last. The kernels themselves are held to these
plain versions on a card in tests/test_torch_kernels.py and chip_smoke.py
(phases chrome, chrome_main).
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
from reversible_raytracer_tpu.ops.pipeline_vec import render_jnp_vec
from reversible_raytracer_tpu_torch import cli
from reversible_raytracer_tpu_torch.bridge import scene_from_numpy
from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.models.scene import (
    ParamSpec,
    leaf_paths,
    tree_leaves,
    tree_map,
)
from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec
from reversible_raytracer_tpu_torch.ops.pipeline import (
    RenderConfig,
    primary_rays,
    reflect_dir,
    shadow_origin,
)
from reversible_raytracer_tpu_torch.ops.pipeline_vec import nearest_vec, render_eager_vec
from reversible_raytracer_tpu_torch.ops.render import resolve_impl

SIZE = 32
CUT = dict(n_spheres=25, env_k=8)  # 26 objects: past the unrolled kernels' 24


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six test
    processes at once, and torch's default of a thread per core slows this
    file and the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _compile():
    """``f(scene, g) -> (image, vjp of g, image without the bounce)`` of
    `render_jnp_vec` on the cut, compiled at XLA's backend optimization
    level 0."""
    cfg = JRenderConfig(height=SIZE, width=SIZE, shadows=True, reflections=1)
    cfg0 = dataclasses.replace(cfg, reflections=0)

    def f(s, g):
        img, vjp = jax.vjp(lambda x: render_jnp_vec(x, cfg), s)
        return img, vjp(g)[0], render_jnp_vec(s, cfg0)
    return jax.jit(f).lower(jconfigs.config10_chrome_field(SIZE, **CUT)[0],
                            jnp.zeros((SIZE, SIZE, 3))).compile(
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


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _pair(perturbed=None, size=SIZE):
    """JAX's cut (its trained leaves moved by perturb(scale=0.2, seed=
    ``perturbed``) if given) and the port's twin bridged through numpy."""
    js, jspec, _ = jconfigs.config10_chrome_field(size, **CUT)
    if perturbed is not None:
        js = jconfigs.perturb(js, jspec, scale=0.2, seed=perturbed)
    like = configs.config10_chrome_field(size, device="cpu", **CUT)[0]
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


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("cut", [{}, CUT], ids=["full", "cut"])
def test_config10_and_perturb_match_jax(seed, cut):
    js, jspec, jcfg = jconfigs.config10_chrome_field(24, **cut)
    ts, tspec, tcfg = configs.config10_chrome_field(24, device="cpu", **cut)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for a, b in zip(_np_leaves(js), tree_leaves(ts)):
        np.testing.assert_array_equal(a, b.numpy())
    assert [bool(t) for t in jax.tree_util.tree_leaves(jspec.trainable)] == list(
        tree_leaves(tspec.trainable))
    jp = jconfigs.perturb(js, jspec, scale=0.2, seed=seed)
    tp = configs.perturb(ts, tspec, scale=0.2, seed=seed)
    for path, a, b in zip(leaf_paths(tp), _np_leaves(jp), tree_leaves(tp)):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=path)


def test_globals_end_with_the_env():
    """The packed globals hold the env last (its ke^2 texels after the
    lights, `globals_offsets`), and `unpack_grads` is the packing's
    transpose: a packed vector unpacks to the leaves it was packed from."""
    _, ts = _pair()
    glob = fused_vec.flatten_globals(ts)
    off = fused_vec.globals_offsets(ts.lights.count, 8)
    assert off["Sg"] == glob.numel() == 22 + 3 * 64 and off["env"] == 22
    np.testing.assert_array_equal(glob[off["env"]:].numpy(), ts.env.reshape(-1).numpy())
    np.testing.assert_array_equal(glob[off["l_pos"]:off["l_pos"] + 3].numpy(),
                                  ts.lights.position[0].numpy())
    ns_pad, nr_pad = fused_vec.row_plan(ts)
    sph = fused_vec.pad_rows(fused_vec.pack_spheres(ts), ns_pad, fused_vec.SPH_PAD_ROW)
    rct = fused_vec.pad_rows(fused_vec.pack_rects(ts), nr_pad, fused_vec.RCT_PAD_ROW)
    back = fused_vec.unpack_grads(ts, glob, sph, rct)
    for path, a, b in zip(leaf_paths(ts), tree_leaves(ts), tree_leaves(back)):
        if "texture" not in path:
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=path)


@pytest.mark.parametrize("reflections", [0, 1])
def test_culled_twin_matches_plain(reflections):
    """Row 4's eager twin (the primary cone at level 0, every sphere at level
    1, the shadow balls at both) gives the plain version's image bit for bit,
    and its planes on the pixels each level hit (level 1's where both did),
    0 elsewhere."""
    _, ts = _pair(perturbed=1)
    cfg = RenderConfig(height=SIZE, width=SIZE, reflections=reflections)
    img, vis = fused_vec.render_vec_culled(ts, cfg)
    img_p, vis_p = fused_vec.render_vec_plain(ts, cfg)
    assert torch.equal(img, img_p)
    assert vis.shape == vis_p.shape == (1 + reflections, SIZE, SIZE)
    hits = fused_vec.level_hits(ts, cfg)
    for lv, hit in enumerate(hits):
        assert torch.equal(vis[lv][hit], vis_p[lv][hit]) and not vis[lv][~hit].any()
    assert bool((~hits[-1]).any()) and bool(hits[-1].any())


def _moved():
    """The cut in float64 at 4 texels a side, and a start with the sky, the
    mirror coefficients, geometry, a light, the camera and materials
    moved."""
    _, ts = _pair()
    ts = dataclasses.replace(ts, env=ts.env[::2, ::2].contiguous())
    spec = ParamSpec.none(ts)
    for path in ("env", "spheres.center", "spheres.radius", "spheres.material.mirror",
                 "spheres.material.ks", "spheres.material.color", "rects.origin",
                 "rects.edge_u", "lights.position", "camera.eye", "camera.look_at",
                 "camera.fov_deg", "ambient"):
        spec = spec.train(path, lower=-20.0, upper=20.0)
    start = configs.perturb(ts, spec, scale=0.02, seed=1)
    f64 = lambda s: tree_map(lambda x: x.to(torch.float64), s)  # noqa: E731
    return f64(ts), f64(start)


@pytest.mark.parametrize("reflections", [0, 1])
@pytest.mark.parametrize("shadows, clip", [(True, True), (False, False)])
def test_twins_match_autograd_float64(reflections, shadows, clip):
    scene, start = _moved()
    cfg = RenderConfig(height=20, width=24, shadows=shadows, clip=clip, reflections=reflections)
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(20, 24, 3)))
    got = fused_vec.render_vec_bwd_adjoint_eager(start, cfg, g,
                                                 fused_vec.render_vec_plain(start, cfg)[1])
    want = fused_vec.render_vec_bwd_plain(start, cfg, g)
    errs = _errors([x.numpy() for x in tree_leaves(want)], got)
    assert max(errs.values()) <= 1e-9, errs
    target = render_eager_vec(scene, cfg)
    l_t, g_t = fused_vec.loss_grad_vec_adjoint_eager(start, cfg, target)
    l_a, g_a = fused_vec.loss_grad_vec_plain(start, cfg, target)
    assert abs(float(l_t) - float(l_a)) <= 1e-12 * float(l_a)
    errs = _errors([x.numpy() for x in tree_leaves(g_a)], g_t)
    assert max(errs.values()) <= 1e-9, errs
    assert not g_t.background.any()
    if reflections:  # the bounce's misses see the sky; the coefficients blend it in
        assert float(g_t.env.abs().max()) > 0.0
        assert float(g_t.spheres.material.mirror.abs().min()) > 0.0


def test_routes_take_env_and_bounce():
    """Config 10 (env and one bounce, 26 objects) and config 5 with a bounce
    pass the object-chunked kernels' check; on the CPU both render through
    `render_eager_vec`."""
    _, ts = _pair()
    cfg = RenderConfig(height=SIZE, width=SIZE, reflections=1)
    assert resolve_impl(ts, cfg) == "eager_vec"
    for refl in (0, 1):
        fused_vec.check_vec_kernel_config(ts, dataclasses.replace(cfg, reflections=refl))
    c5, _, cfg5 = configs.config5_many_spheres(16, n_spheres=25, device="cpu")
    fused_vec.check_vec_kernel_config(c5, dataclasses.replace(cfg5, reflections=1))
    assert fused_vec.levels(ts, cfg) == (1, 8) and fused_vec.levels(c5, cfg5) == (0, 0)


@pytest.mark.parametrize("what, kw, why", [
    # object textures (spp 1 and 4, up to three bounces) are covered: this case
    # holds the refusal that remains beside them, four bounces (its id kept)
    pytest.param("textures", dict(spp=4, reflections=4), "reflections > 3",
                 id="textures-kw0-object textures"),
    # spp 4 with the env and up to three bounces is covered: four at spp 4 stay refused
    ("spp4", dict(spp=4, reflections=4), "reflections > 3"),
    ("two_bounces", dict(reflections=4), "reflections > 3"),
])
def test_vec_kernels_refuse_by_name(what, kw, why):
    _, ts = _pair()
    cfg = dataclasses.replace(RenderConfig(height=SIZE, width=SIZE, reflections=1), **kw)
    if what == "textures":
        ts = dataclasses.replace(ts, rects=dataclasses.replace(
            ts.rects, texture=torch.full((1, 4, 4, 3), 0.5)))
    with pytest.raises(NotImplementedError, match=why):
        fused_vec.check_vec_kernel_config(ts, cfg)
    if what == "spp4":  # the env at spp 4, with its bounces and without
        for refl in (0, 1, 2, 3):
            fused_vec.check_vec_kernel_config(ts, dataclasses.replace(cfg, reflections=refl))


def test_cli_invert_config10_on_cpu():
    out = cli.main(["invert", "--device", "cpu", "--config", "10", "--size", "24", "--iters",
                    "4", "--perturb", "0.2", "--lr", "2e-2", "--seed", "10", "--log-every", "1",
                    "--quiet"])
    hist = out["history"]
    assert len(hist) == 4 and hist[-1]["loss"] < hist[0]["loss"]
    assert hist[-1]["param_err"] < hist[0]["param_err"]
    final = out["scene"]
    start = configs.perturb(*configs.config10_chrome_field(24, device="cpu")[:2], scale=0.2,
                            seed=10)
    assert float((final.spheres.material.mirror - start.spheres.material.mirror).abs().max()) > 0
    assert float((final.env - start.env).abs().max()) > 0


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def _jax_fn():
    return _COMPILED["f"].result()


@pytest.mark.parametrize("reflections", [0, 1])
def test_eager_vec_render_matches_jax(reflections):
    js, ts = _pair(perturbed=1)
    out = _jax_fn()(js, jnp.zeros((SIZE, SIZE, 3)))
    img = np.asarray(out[0] if reflections else out[2])
    cfg = RenderConfig(height=SIZE, width=SIZE, reflections=reflections)
    err = np.abs(img - render_eager_vec(ts, cfg).numpy())
    assert (err > 2e-3).mean() < 1e-3 and err.mean() < 1e-4, (err.max(), err.mean())


def _edge_mask(scene, cfg, dilate=1):
    """Pixels next to an edge of either level's winners (an object's
    silhouette seen directly or in a mirror) or of a shadow, at either
    level."""
    o, d = primary_rays(scene, cfg)
    t, k = nearest_vec(scene, o, d)
    zero = torch.zeros(cfg.shape)
    w = fused.winner_surface(scene, fused.winner_geometry(scene, k, zero), o, d, t, zero)
    k1 = nearest_vec(scene, shadow_origin(o, d, t, w.n), reflect_dir(d, w.n))[1]
    ids = (k * 64 + torch.where(k >= 0, k1, -1)).numpy()
    vis = fused_vec.render_vec_culled(scene, cfg)[1].numpy()
    e = np.zeros(ids.shape, bool)
    for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)):
        e |= ids != np.roll(ids, sh, axis=ax)
        e |= (vis != np.roll(vis, sh, axis=ax + 1)).any(0)
    for _ in range(dilate):
        for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)):
            e |= np.roll(e, sh, axis=ax)
    return e


def test_step_twin_matches_jax_value_and_grad():
    """Row 6's twin against the value and gradient of the mse of
    `render_jnp_vec` (each package's target its own render of the truth),
    from perturb(scale=0.2, seed=0) of the mirror coefficients and the sky:
    every leaf within 1e-2 of its scale."""
    js, ts = _pair()
    jstart, tstart = _pair(perturbed=0)
    zero = jnp.zeros((SIZE, SIZE, 3))
    cfg = RenderConfig(height=SIZE, width=SIZE, reflections=1)
    target, img = _jax_fn()(js, zero)[0], _jax_fn()(jstart, zero)[0]
    resid = img - target
    g_ref = _jax_fn()(jstart, 2.0 * resid / resid.size)[1]
    l_t, g_t = fused_vec.loss_grad_vec_adjoint_eager(tstart, cfg, render_eager_vec(ts, cfg))
    l_ref = float(jnp.mean(resid * resid))
    assert abs(float(l_t) - l_ref) <= 1e-4 * l_ref
    errs = _errors(jax.tree_util.tree_leaves(g_ref), g_t)
    assert max(errs.values()) <= 1e-2, errs
    assert float(g_t.env.abs().max()) > 0.0
    assert float(g_t.spheres.material.mirror.abs().max()) > 0.0


def test_bwd_twin_matches_jax_vjp():
    """Row 5's twin against `jax.vjp` of a seeded normal cotangent zero next
    to an edge (`_edge_mask`, undilated), every leaf within 1e-2 of its
    scale. At 32^2 every sphere's pixels lie next to an edge of one level or
    the other, so the mirror coefficients' gradient is held by the step's
    test above."""
    jstart, tstart = _pair(perturbed=0)
    cfg = RenderConfig(height=SIZE, width=SIZE, reflections=1)
    keep = ~_edge_mask(tstart, cfg, dilate=0)
    assert keep.mean() > 0.5
    g = np.random.default_rng(0).normal(size=(SIZE, SIZE, 3)).astype(np.float32)
    g = g * keep[..., None]
    ref_g = _jax_fn()(jstart, jnp.asarray(g))[1]
    got = fused_vec.render_vec_bwd_adjoint_eager(tstart, cfg, torch.from_numpy(g),
                                                 fused_vec.render_vec_plain(tstart, cfg)[1])
    errs = _errors(jax.tree_util.tree_leaves(ref_g), got)
    assert max(errs.values()) <= 1e-2, errs
    assert float(got.env.abs().max()) > 0.0 and float(got.camera.eye.abs().max()) > 0.0
