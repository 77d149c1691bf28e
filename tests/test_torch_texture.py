"""Object textures (configs 7 and 8: a textured floor, a textured globe) in
the port, on the CPU, against the JAX package.

- `vecmath.atan2` / `asin` against the JAX package's on a grid holding +-0,
  the axes, the diagonals and the azimuth seam (x < 0, y = +-0): the same
  values within 2 ulp, and atan2(-0, x < 0) = +pi in both;
- configs 7 and 8 and their `perturb` leaf for leaf against the JAX
  package's (the texels bit for bit);
- the eager render (`render_eager`, the where chain with the 4-corner
  bilinear gather) against the float64 numpy oracle at 16 texels a side, the
  rule of tests/test_texture.py (max < 1e-3, mean < 1e-5): the default views,
  the floor's clamped edges at 4 texels, the globe's atan2 seam, 1 texel;
- the eager twins of rows 1 and 3 (`loss_grad_adjoint_eager`,
  `render_bwd_adjoint_eager`: the texel scatter, the weights' gradient
  through a rect's (a, b) or a sphere's lat-long coordinates) against torch
  autograd of `render_eager` in float64, from a start with the texels,
  camera and geometry moved: every leaf within 1e-9 of its scale;
- a texel leaf through the numpy bridge, scene JSON and the npz checkpoint,
  both ways with the JAX package's;
- the CUDA route's refusals by name (`fused.uncovered`), the dispatch, and
  the CLI on the CPU;
- against the JAX package at 32^2, 4 texels a side: the image of
  `render_jnp` by the oracle's rule, the twin of row 1 against the value and
  gradient of the mean squared error (the loss within 1e-4 relative) and
  the twin of row 3 against `jax.vjp` of a seeded normal cotangent zero next
  to a silhouette or a shadow's edge (`_edge_mask`), every
  leaf within 1e-2 of its scale: texels, camera and geometry. One compiled
  JAX function serves every case, the render of both configs and their
  vjps; it compiles in a thread from the file's first test on (at XLA's
  backend optimization level 0), and the JAX tests come last.

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
from reversible_raytracer_tpu.ops import vecmath as jvm
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
from reversible_raytracer_tpu_torch.ops import vecmath as vm
from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec
from reversible_raytracer_tpu_torch.ops.pipeline import RenderConfig
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


# name: (config, its texels' side, a camera (eye, look_at) or None)
VIEWS = {
    "config7": (7, 16, None),
    "config7_edges": (7, 4, ((0.0, 8.0, 10.0), (0.0, -0.7, 0.0))),
    "config8": (8, 16, None),
    "config8_seam": (8, 16, ((-3.6, 0.9, 0.0), (0.0, 0.1, 0.0))),
    "config8_k1": (8, 1, None),
}


def _pair(name, size=32, tex_k=None, perturbed=None):
    """JAX's scene of the view (its texels moved by perturb(scale=0.4,
    seed=``perturbed``) if given) and the port's twin bridged through
    numpy."""
    num, k, cam = VIEWS[name]
    k = tex_k or k
    js, jspec, _ = jconfigs.CONFIGS[num](size, tex_k=k)
    if cam is not None:
        js = dataclasses.replace(js, camera=dataclasses.replace(
            js.camera, eye=jnp.asarray(cam[0], jnp.float32),
            look_at=jnp.asarray(cam[1], jnp.float32)))
    if perturbed is not None:
        js = jconfigs.perturb(js, jspec, scale=0.4, seed=perturbed)
    like = configs.CONFIGS[num](size, tex_k=k, device="cpu")[0]
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


# ---------------------------------------------------------------------------
# atan2 and asin, the configs, perturb
# ---------------------------------------------------------------------------


def _grid():
    v = np.array([0.0, -0.0, 1.0, -1.0, 0.3, -0.3, 2.5, -2.5, 1e-8, -1e-8, 0.4142135, 7.0],
                 np.float32)
    y, x = np.meshgrid(v, v, indexing="ij")
    return y.ravel(), x.ravel()


def test_atan2_and_asin_match_jax():
    y, x = _grid()
    got = vm.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    want = np.asarray(jvm.atan2(jnp.asarray(y), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * np.spacing(np.float32(np.pi)))
    # libm but for the selects on y < 0 and x < 0: +pi at y = -0, x < 0, and 0 at x = -0, y = 0
    libm = np.where((y == 0) & (x < 0), np.float32(np.pi),
                    np.where((y == 0) & (x == 0), 0.0, np.arctan2(y, x)))
    np.testing.assert_allclose(got, libm, rtol=0, atol=2e-6)
    seam = vm.atan2(torch.tensor([-0.0, 0.0]), torch.tensor([-1.0, -1.0])).numpy()
    assert (seam == np.float32(np.pi)).all()  # the y < 0 select: +pi on both sides of -0
    assert float(vm.atan2(torch.tensor(0.0), torch.tensor(0.0))) == 0.0
    t = np.linspace(-1 + 1e-6, 1 - 1e-6, 101).astype(np.float32)
    t = np.concatenate([t, np.float32([0.0, -0.0, 0.5, -0.5])])
    got = vm.asin(torch.from_numpy(t)).numpy()
    want = np.asarray(jvm.asin(jnp.asarray(t)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * np.spacing(np.float32(np.pi / 2)))
    np.testing.assert_allclose(got, np.arcsin(t.astype(np.float64)), atol=2e-6)


@pytest.mark.parametrize("num", [7, 8])
def test_configs_and_perturb_match_jax(num):
    js, jspec, jcfg = jconfigs.CONFIGS[num](24)
    ts, tspec, tcfg = configs.CONFIGS[num](24, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for a, b in zip(_np_leaves(js), tree_leaves(ts)):
        np.testing.assert_array_equal(a, b.numpy())
    assert [bool(t) for t in jax.tree_util.tree_leaves(jspec.trainable)] == list(
        tree_leaves(tspec.trainable))
    for seed in (0, 11):
        jp = jconfigs.perturb(js, jspec, scale=0.4, seed=seed)
        tp = configs.perturb(ts, tspec, scale=0.4, seed=seed)
        for path, a, b in zip(leaf_paths(tp), _np_leaves(jp), tree_leaves(tp)):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=path)


# ---------------------------------------------------------------------------
# The eager render against the float64 oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(VIEWS))
def test_eager_render_matches_f64_oracle(name):
    _, ts = _pair(name)
    img = render_eager(ts, RenderConfig(height=32, width=32)).numpy()
    orc = ref.render(ts, 32, 32)
    assert np.abs(img - orc).max() < 1e-3
    assert np.abs(img - orc).mean() < 1e-5


def test_views_cover_the_seam_and_the_clamps():
    """The seam view's globe straddles the atan2 seam, and the edges view's
    floor samples the clamped half-texel band of both axes."""
    from reversible_raytracer_tpu_torch.ops.pipeline import (
        intersect_rect, primary_rays, sphere_uv, trace_nearest)

    cfg = RenderConfig(height=32, width=32)
    _, ts = _pair("config8_seam")
    o, d = primary_rays(ts, cfg)
    t, hit, at = trace_nearest(ts, o, d, cfg.shape)
    u = sphere_uv((at["nx"], at["ny"], at["nz"]))[0][hit & (at["ny"].abs() < 0.9)]
    assert (u < 0.05).any() and (u > 0.95).any()
    _, ts = _pair("config7_edges")
    o, d = primary_rays(ts, cfg)
    rc = ts.rects
    tr, a, b, _ = intersect_rect(o, d, rc.origin[0], rc.edge_u[0], rc.edge_v[0])
    on = tr < 1e9
    for c in (a[on], b[on]):
        assert (c < 0.125).any() and (c > 0.875).any()  # half a texel at K = 4


# ---------------------------------------------------------------------------
# The adjoint twins against autograd (float64)
# ---------------------------------------------------------------------------


def _moved(name):
    """The view at 20x24 in float64 with 4 texels a side, and a start with its
    texels, camera, geometry, materials and light moved, so that every leaf
    the render reads has a gradient."""
    _, ts = _pair(name, tex_k=4 if VIEWS[name][1] != 1 else 1)
    spec = ParamSpec.none(ts)
    for path in ("rects.texture" if ts.rects.textured else "spheres.texture", "spheres.center", "spheres.radius", "spheres.material.color",
                 "spheres.material.ks", "rects.origin", "rects.edge_u", "rects.edge_v",
                 "rects.material.kd", "lights.position", "camera.eye", "camera.look_at",
                 "camera.fov_deg", "ambient"):
        spec = spec.train(path, lower=-20.0, upper=20.0)
    start = configs.perturb(ts, spec, scale=0.02, seed=1)
    f64 = lambda s: tree_map(lambda x: x.to(torch.float64), s)  # noqa: E731
    return f64(ts), f64(start)


@pytest.mark.parametrize("name", ["config7", "config7_edges", "config8", "config8_seam",
                                  "config8_k1"])
@pytest.mark.parametrize("shadows, clip", [(True, True), (False, False)])
def test_adjoint_twins_match_autograd_float64(name, shadows, clip):
    scene, start = _moved(name)
    cfg = RenderConfig(height=20, width=24, shadows=shadows, clip=clip)
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
    tex = g_t.rects.texture if scene.rects.textured else g_t.spheres.texture
    assert float(tex.abs().max()) > 0.0
    assert float(g_t.rects.material.color.abs().max()) == (0.0 if scene.rects.textured else
                                                           float(g_a.rects.material.color
                                                                 .abs().max()))


# ---------------------------------------------------------------------------
# The texel leaves through the bridge, JSON and checkpoints; refusals; CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num", [7, 8])
def test_texel_leaf_round_trips_with_jax(tmp_path, num):
    js, jspec, _ = jconfigs.CONFIGS[num](16, tex_k=4)
    ts, tspec, _ = configs.CONFIGS[num](16, tex_k=4, device="cpu")
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
    ts, spec, cfg = configs.config7_texture(16, tex_k=4, device="cpu")
    assert resolve_impl(ts, cfg) == "eager"
    assert fused.uncovered(ts, cfg, texels=True) is None
    assert fused.uncovered(ts, cfg) == "object textures"
    # spp 4 is covered as spp 1 is, in both hard families; a bounce beside
    # object textures is the unrolled kernels' refusal at either spp
    spp4 = dataclasses.replace(cfg, spp=4)
    assert fused.uncovered(ts, spp4, texels=True) is None
    fused.check_kernel_config(ts, spp4)
    fused_vec.check_vec_kernel_config(ts, spp4)
    for kw in (dict(reflections=1), dict(spp=4, reflections=1)):
        assert "object textures with mirror reflections" in fused.uncovered(
            ts, dataclasses.replace(cfg, **kw), texels=True)
    with pytest.raises(NotImplementedError, match="reflections > 3"):
        fused_vec.check_vec_kernel_config(ts, dataclasses.replace(spp4, reflections=4))
    fused_vec.check_vec_kernel_config(ts, dataclasses.replace(spp4, reflections=2))
    big = configs.config7_texture(16, tex_k=48, device="cpu")[0]
    assert "a texel grid this large" in fused.uncovered(big, cfg, texels=True)
    assert fused.step_smem_bytes(1, 1, 1, 0, 16, 0) <= fused.MAX_BLOCK_SMEM
    # the soft kernels take the grid with the hard checker (the render at spp
    # 4 too, the step at spp 1 only); the
    # anneal's soft stages refuse a bounce by name, as the JAX package does
    from reversible_raytracer_tpu_torch.ops.kernels import fused_vec_soft
    from reversible_raytracer_tpu_torch.optim import OptConfig, optimize_annealed

    soft = dataclasses.replace(cfg, soft_tau=0.05)
    fused_vec_soft.check_soft_kernel_config(ts, soft, step=True)
    fused_vec_soft.check_soft_kernel_config(ts, dataclasses.replace(soft, spp=4))
    for kw, step, why in ((dict(spp=4), True, "spp=4 in the soft step"),
                          (dict(checker_tau=0.5), False, "the soft checker")):
        with pytest.raises(NotImplementedError, match=why):
            fused_vec_soft.check_soft_kernel_config(ts, dataclasses.replace(soft, **kw), step)
    with pytest.raises(NotImplementedError, match="mirror reflections"):
        optimize_annealed(ts, render_eager(ts, cfg), spec,
                          dataclasses.replace(cfg, reflections=1), OptConfig(iters=1),
                          taus=(0.05, 0.0))


def test_flat_offsets_place_the_texels():
    ts = configs.config8_globe(8, tex_k=4, device="cpu")[0]
    off = fused.flat_offsets(1, 1, 1, *fused.texel_sizes(ts))
    flat = fused.flatten_scene(ts)
    assert off["S"] == flat.numel() == 61 + 48
    assert torch.equal(flat[off["s_tex"]:off["s_tex"] + 48], ts.spheres.texture.reshape(-1))
    assert torch.equal(flat[off["r_origin"]:off["r_origin"] + 3], ts.rects.origin[0])
    assert torch.equal(flat[off["background"]:off["background"] + 3], ts.background)


def test_cli_configs_7_and_8_on_cpu(tmp_path):
    from PIL import Image

    png = tmp_path / "r.png"
    cli.main(["render", "--device", "cpu", "--config", "8", "--size", "24", "-o", str(png)])
    scene, _, cfg = configs.config8_globe(24, device="cpu")
    want = np.clip(np.round(render_eager(scene, cfg).numpy() * 255.0), 0, 255)
    assert np.abs(np.asarray(Image.open(png)).astype(np.int32) - want).max() <= 1
    out = cli.main(["invert", "--device", "cpu", "--config", "7", "--size", "24", "--lr", "3e-2",
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
    """``f(s7, g7, s8, g8) -> (image, vjp of g) of each``: `render_jnp` of
    config 7's and config 8's structures, compiled at XLA's backend
    optimization level 0."""
    cfg = JRenderConfig(height=JAX_SIZE, width=JAX_SIZE, shadows=True)

    def one(s, g):
        img, vjp = jax.vjp(lambda x: render_jnp(x, cfg), s)
        return img, vjp(g)[0]

    def f(s7, g7, s8, g8):
        return one(s7, g7), one(s8, g8)
    zero = jnp.zeros((JAX_SIZE, JAX_SIZE, 3))
    return jax.jit(f).lower(jconfigs.config7_texture(JAX_SIZE, tex_k=JAX_K)[0], zero,
                            jconfigs.config8_globe(JAX_SIZE, tex_k=JAX_K)[0], zero).compile(
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


def _jax(num, js, g):
    """(image, vjp of g) of `render_jnp` for config ``num``'s structure."""
    zero = jnp.zeros((JAX_SIZE, JAX_SIZE, 3))
    other = jconfigs.CONFIGS[{7: 8, 8: 7}[num]](JAX_SIZE, tex_k=JAX_K)[0]
    args = (js, g, other, zero) if num == 7 else (other, zero, js, g)
    out = _COMPILED["f"].result()(*args)
    return out[0] if num == 7 else out[1]


def _edge_mask(scene, cfg, dilate=1):
    """Pixels next to a silhouette or a shadow's edge: a neighbour whose ray
    hits another object, or whose visibility differs (the steep but
    continuous texture is no edge, as tests/test_fused_vec.py's image rule
    would take it)."""
    from reversible_raytracer_tpu_torch.ops.pipeline import primary_rays

    o, d = primary_rays(scene, cfg)
    k = fused._nearest_chain(scene, o, d)[1].numpy()
    vis = fused.render_fused_plain(scene, cfg)[1]  # each level's, where it hit
    L = scene.lights.count
    vis = torch.cat([vis[lv * L:(lv + 1) * L] * hit
                     for lv, hit in enumerate(fused.level_hits(scene, cfg))]).numpy()
    e = np.zeros(k.shape, bool)
    for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)):
        e |= k != np.roll(k, sh, axis=ax)
        e |= (vis != np.roll(vis, sh, axis=ax + 1)).any(0)
    for _ in range(dilate):
        for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)):
            e |= np.roll(e, sh, axis=ax)
    return e


JAX_VIEWS = ["config7", "config7_edges", "config8", "config8_seam"]


@pytest.mark.parametrize("name", JAX_VIEWS)
def test_twins_match_jax(name):
    """The image against `render_jnp` by the oracle's rule; row 1's twin
    against the mse's value and gradient (the vjp of 2 (img - target) / n;
    each package's target its own render of the truth, so that the pixels
    the texels do not reach have a residual of exactly 0 in both), row 3's
    against `jax.vjp` of an edge-masked seeded cotangent, every leaf within
    1e-2 of its scale (texels, camera and geometry)."""
    num = VIEWS[name][0]
    js, ts = _pair(name, JAX_SIZE, JAX_K)
    jstart, tstart = _pair(name, JAX_SIZE, JAX_K, perturbed=5)
    zero = jnp.zeros((JAX_SIZE, JAX_SIZE, 3))
    cfg = RenderConfig(height=JAX_SIZE, width=JAX_SIZE)
    target = _jax(num, js, zero)[0]
    img, _ = _jax(num, jstart, zero)
    err = np.abs(np.array(img) - render_eager(tstart, cfg).numpy())
    assert err.max() < 1e-3 and err.mean() < 1e-5
    resid = img - target
    g_ref = _jax(num, jstart, 2.0 * resid / resid.size)[1]
    l_t, g_t = fused.loss_grad_adjoint_eager(tstart, cfg, render_eager(ts, cfg))
    assert abs(float(l_t) - float(jnp.mean(resid * resid))) <= 1e-4 * float(jnp.mean(resid ** 2))
    errs = _errors(jax.tree_util.tree_leaves(g_ref), g_t)
    assert max(errs.values()) <= 1e-2, errs
    g = np.random.default_rng(0).normal(size=(JAX_SIZE, JAX_SIZE, 3)).astype(np.float32)
    plain = fused.render_fused_plain(tstart, cfg)
    g = g * ~_edge_mask(tstart, cfg)[..., None]
    ref_g = _jax(num, jstart, jnp.asarray(g))[1]
    got = fused.render_bwd_adjoint_eager(tstart, cfg, torch.from_numpy(g), plain[1])
    errs = _errors(jax.tree_util.tree_leaves(ref_g), got)
    assert max(errs.values()) <= 1e-2, errs
    tex = got.rects.texture if num == 7 else got.spheres.texture
    assert float(tex.abs().max()) > 0.0 and float(got.camera.eye.abs().max()) > 0.0
