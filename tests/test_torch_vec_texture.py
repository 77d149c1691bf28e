"""Object texel grids in the object-chunked family, on the CPU, against the
JAX package.

The cut: config 5 at 32^2 with 25 spheres (26 objects: past the unrolled
kernels' 24), each sphere with an (8, 8, 3) texel grid drawn uniform(0.1,
0.9) from default_rng(3), as the JAX package's tests/test_texture.py
`_big_textured_scene` builds it; with a bounce, mirror coefficients of 0.4.
Beside it config 7 (a textured floor) at 32^2 with one bounce.

- the cut leaf for leaf against the JAX package's, through the bridge;
- the object-vectorized eager render (`render_eager_vec`: each winner's grid
  gathered at a sphere's lat-long coordinates or a rect's (a, b)) against
  `render_eager` bit for bit and against `render_jnp_vec` by the oracle's
  rule, with and without the bounce; the forward kernel's eager twin
  (`render_vec_culled`) against its plain version, bit for bit;
- the eager twins of rows 5 and 6 (the texel records of both levels'
  winners) against torch autograd of `render_eager_vec` in float64: every
  leaf within 1e-9 of its scale, the texels' gradient not 0;
- the same twins against the JAX package on the cut without the bounce:
  row 6's against the value and gradient of the mean squared error, row 5's
  against `jax.vjp` of a seeded normal cotangent zero next to an edge, every
  leaf within 1e-2 of its scale (the bounce's vjp took 24 s to compile: the
  bounce's twins are held to float64 autograd above, and its render to
  JAX's);
- the packing of the texel grids and the transpose of it;
- the routes: the object-chunked kernels take object textures at spp 1 and
  4 with 0 to 3 bounces (and refuse, by name, four bounces at either spp,
  the soft kernels, and grids whose gradient does not fit a block); object
  textures with a bounce take the object-vectorized family at any count;
- the CLI: `invert --config 8 --reflections 1` on the CPU.

One JAX compile (the cut's render and vjp without the bounce, its render
with the bounce and config 7's with the bounce, at XLA's backend
optimization level 0 without LLVM's expensive passes: about 9 s) runs in a
thread from the file's first test on; the JAX tests come last. The kernels
themselves are held to these plain versions on a card in
tests/test_torch_kernels.py and chip_smoke.py (phases globes, globes_main).
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
from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec, fused_vec_soft
from reversible_raytracer_tpu_torch.ops.pipeline import (
    RenderConfig,
    primary_rays,
    reflect_dir,
    shadow_origin,
)
from reversible_raytracer_tpu_torch.ops.pipeline_vec import nearest_vec, render_eager_vec
from reversible_raytracer_tpu_torch.ops.render import render_eager, resolve_impl

SIZE = 32
N_SPHERES, TEX_K, MIRROR = 25, 8, 0.4
CASES = ("cut", "cut_bounce", "config7_bounce")


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
    """The JAX package's scene of a case, and its RenderConfig."""
    if case == "config7_bounce":
        js, _, cfg = jconfigs.config7_texture(SIZE)
        return js, dataclasses.replace(cfg, reflections=1)
    js, _, cfg = jconfigs.config5_many_spheres(SIZE, n_spheres=N_SPHERES)
    rng = np.random.default_rng(3)
    tex = jnp.asarray(rng.uniform(0.1, 0.9, (js.spheres.count, TEX_K, TEX_K, 3)), jnp.float32)
    sp = dataclasses.replace(js.spheres, texture=tex)
    if case == "cut_bounce":
        sp = dataclasses.replace(sp, material=dataclasses.replace(
            sp.material, mirror=jnp.full((js.spheres.count,), MIRROR, jnp.float32)))
    return (dataclasses.replace(js, spheres=sp),
            JRenderConfig(height=SIZE, width=SIZE, shadows=True,
                          reflections=int(case == "cut_bounce")))


def _compile():
    """``f(cut, cut_bounce, config7_bounce, g) -> (the cut's image, its vjp
    of g, the other two's images)``: `render_jnp_vec` compiled at XLA's
    backend optimization level 0, without LLVM's expensive passes."""
    (s0, c0), (s1, c1), (s7, c7) = (_jax_scene(c) for c in CASES)

    def f(a, b, c, g):
        img, vjp = jax.vjp(lambda x: render_jnp_vec(x, c0), a)
        return img, vjp(g)[0], render_jnp_vec(b, c1), render_jnp_vec(c, c7)
    return jax.jit(f).lower(s0, s1, s7, jnp.zeros((SIZE, SIZE, 3))).compile(
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


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _like(case):
    """The port's scene of a case's structure (its values come from the
    bridge), its texel spec and RenderConfig."""
    if case == "config7_bounce":
        ts, spec, cfg = configs.config7_texture(SIZE, device="cpu")
        return ts, spec, dataclasses.replace(cfg, reflections=1)
    ts, _, cfg = configs.config5_many_spheres(SIZE, n_spheres=N_SPHERES, device="cpu")
    ts = dataclasses.replace(ts, spheres=dataclasses.replace(
        ts.spheres, texture=torch.zeros((ts.spheres.count, TEX_K, TEX_K, 3))))
    spec = ParamSpec.none(ts).train("spheres.texture", lower=0.0, upper=1.0)
    return ts, spec, dataclasses.replace(cfg, reflections=int(case == "cut_bounce"))


def _pair(case, perturbed=None):
    """(JAX scene, the port's twin through the bridge, the port's cfg); with
    ``perturbed`` both at the port's perturb(scale=0.4, seed=perturbed) of
    the texels."""
    js, _ = _jax_scene(case)
    like, spec, cfg = _like(case)
    ts = scene_from_numpy(_np_leaves(js), like=like, device="cpu")
    if perturbed is not None:
        ts = configs.perturb(ts, spec, scale=0.4, seed=perturbed)
        js = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(js),
                                          [jnp.asarray(x.numpy()) for x in tree_leaves(ts)])
    return js, ts, cfg


def _errors(ref_leaves, got):
    """Worst |got - ref| / scale(ref) per non-empty leaf."""
    out = {}
    for path, a, b in zip(leaf_paths(got), ref_leaves, tree_leaves(got)):
        a = np.asarray(a, np.float64)
        if a.size:
            b = b.detach().numpy().astype(np.float64)
            out[path] = np.abs(b - a).max() / max(np.abs(a).max(), 1e-6)
    return out


def _texels(grads):
    return torch.cat([grads.spheres.texture.reshape(-1), grads.rects.texture.reshape(-1)])


@pytest.mark.parametrize("case", CASES)
def test_cut_matches_jax_leaf_for_leaf(case):
    js, ts, cfg = _pair(case)
    assert ts.spheres.count + ts.rects.count == (26 if case != "config7_bounce" else 2)
    for path, a, b in zip(leaf_paths(ts), _np_leaves(js), tree_leaves(ts)):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=path)
    assert fused_vec.object_textured(ts)


@pytest.mark.parametrize("case", CASES)
def test_eager_vec_render_is_render_eager(case):
    """The object-vectorized render of a textured scene is the where chain's
    bit for bit (same gather, same weights, same arithmetic)."""
    _, ts, cfg = _pair(case, perturbed=1)
    assert torch.equal(render_eager_vec(ts, cfg), render_eager(ts, cfg))


@pytest.mark.parametrize("case", CASES)
def test_culled_twin_matches_plain(case):
    """Row 4's eager twin gives the plain version's image bit for bit, and
    its planes on the pixels each level hit, 0 elsewhere."""
    _, ts, cfg = _pair(case, perturbed=1)
    img, vis = fused_vec.render_vec_culled(ts, cfg)
    img_p, vis_p = fused_vec.render_vec_plain(ts, cfg)
    assert torch.equal(img, img_p)
    for lv, hit in enumerate(fused_vec.level_hits(ts, cfg)):
        assert torch.equal(vis[lv][hit], vis_p[lv][hit]) and not vis[lv][~hit].any()


def _moved(case):
    """A case in float64, and a start with the texels, geometry, the mirror
    coefficients, a light and the camera moved."""
    _, ts, cfg = _pair(case)
    spec = ParamSpec.none(ts)
    paths = ["spheres.center", "spheres.radius", "spheres.material.mirror", "rects.origin",
             "rects.edge_u", "lights.position", "camera.eye", "camera.look_at", "camera.fov_deg"]
    for path in paths + [f"{g}.texture" for g in ("spheres", "rects")
                         if getattr(ts, g).textured]:
        spec = spec.train(path, lower=-20.0, upper=20.0)
    start = configs.perturb(ts, spec, scale=0.02, seed=1)
    f64 = lambda s: tree_map(lambda x: x.to(torch.float64), s)  # noqa: E731
    return f64(ts), f64(start), cfg


@pytest.mark.parametrize("case", CASES)
def test_twins_match_autograd_float64(case):
    scene, start, cfg = _moved(case)
    cfg = dataclasses.replace(cfg, height=20, width=24)
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(20, 24, 3)))
    got = fused_vec.render_vec_bwd_adjoint_eager(start, cfg, g,
                                                 fused_vec.render_vec_plain(start, cfg)[1])
    want = fused_vec.render_vec_bwd_plain(start, cfg, g)
    errs = _errors([x.numpy() for x in tree_leaves(want)], got)
    assert max(errs.values()) <= 1e-9, errs
    assert bool(_texels(got).any())
    target = render_eager_vec(scene, cfg)
    l_t, g_t = fused_vec.loss_grad_vec_adjoint_eager(start, cfg, target)
    l_a, g_a = fused_vec.loss_grad_vec_plain(start, cfg, target)
    assert abs(float(l_t) - float(l_a)) <= 1e-12 * float(l_a)
    errs = _errors([x.numpy() for x in tree_leaves(g_a)], g_t)
    assert max(errs.values()) <= 1e-9, errs
    assert bool(_texels(g_t).any())


def test_pack_and_unpack_texels():
    """`pack_texels` lays the spheres' grids, then the rects', out flat;
    `unpack_grads` takes a vector of that layout back to both texture leaves
    (and the rows and globals to theirs): the packing's transpose."""
    _, ts, _ = _pair("cut", perturbed=0)
    tex = dataclasses.replace(ts, rects=dataclasses.replace(
        ts.rects, texture=torch.rand((1, 4, 4, 3), generator=torch.Generator().manual_seed(0))))
    stex, rtex = fused_vec.pack_texels(tex)
    assert stex.numel() == N_SPHERES * TEX_K * TEX_K * 3 and rtex.numel() == 48
    assert fused_vec.texel_row(tex) == stex.numel() + rtex.numel()
    ns_pad, nr_pad = fused_vec.row_plan(tex)
    glob = fused_vec.flatten_globals(tex)
    sph = fused_vec.pad_rows(fused_vec.pack_spheres(tex), ns_pad, fused_vec.SPH_PAD_ROW)
    rct = fused_vec.pad_rows(fused_vec.pack_rects(tex), nr_pad, fused_vec.RCT_PAD_ROW)
    assert sph.shape == (ns_pad, fused_vec.P_SPH) and rct.shape == (nr_pad, fused_vec.P_RCT)
    back = fused_vec.unpack_grads(tex, glob, sph, rct, torch.cat([stex, rtex]))
    for path, a, b in zip(leaf_paths(tex), tree_leaves(tex), tree_leaves(back)):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=path)
    zeros = fused_vec.unpack_grads(tex, glob, sph, rct)
    assert not zeros.spheres.texture.any() and not zeros.rects.texture.any()
    with pytest.raises(ValueError, match="dtex has"):
        fused_vec.unpack_grads(tex, glob, sph, rct, stex)


@pytest.mark.parametrize("case", CASES)
def test_routes_take_object_textures(case):
    """Object textures pass the object-chunked kernels' check at spp 1 with
    0 or 1 bounce; with a bounce they take the object-vectorized family on
    either device at any object count (the unrolled kernels refuse the
    pair, as the JAX package's do)."""
    _, ts, cfg = _pair(case)
    for refl in (0, 1):
        fused_vec.check_vec_kernel_config(ts, dataclasses.replace(cfg, reflections=refl))
    assert resolve_impl(ts, cfg) == "eager_vec"
    assert resolve_impl(ts, dataclasses.replace(cfg, reflections=0)) == (
        "eager" if case == "config7_bounce" else "eager_vec")
    assert fused_vec.tex_levels(ts, cfg)[2:] == ((TEX_K, 0) if case != "config7_bounce"
                                                 else (0, 16))


@pytest.mark.parametrize("what, kw, why", [
    ("spp4_two_bounces", dict(spp=4, reflections=4), "reflections > 3"),
    ("two_bounces", dict(reflections=4), "reflections > 3"),
    ("soft", dict(soft_tau=0.05, reflections=0), "soft_tau"),
])
def test_vec_kernels_refuse_by_name(what, kw, why):
    _, ts, cfg = _pair("cut_bounce")
    bad = dataclasses.replace(cfg, **kw)
    with pytest.raises(NotImplementedError, match=why):
        fused_vec.check_vec_kernel_config(ts, bad)
    if what == "soft":  # the soft kernels take the grids (the render at spp 4 too), but
        # not the bounce, nor the soft step at spp 4
        with pytest.raises(NotImplementedError, match="mirror reflections"):
            fused_vec_soft.check_soft_kernel_config(ts, dataclasses.replace(bad, reflections=1))
        with pytest.raises(NotImplementedError, match="spp=4 in the soft step"):
            fused_vec_soft.check_soft_kernel_config(ts, dataclasses.replace(bad, spp=4), True)
        fused_vec_soft.check_soft_kernel_config(ts, dataclasses.replace(bad, spp=4))
        fused_vec_soft.check_soft_kernel_config(ts, bad)
        with pytest.raises(NotImplementedError, match="mirror reflections"):
            render_eager_vec(ts, dataclasses.replace(bad, reflections=1))


def test_shared_memory_refuses_grids_too_large():
    """The 64 globes' 16 x 16 grids fit the textured step's block (211,448
    bytes of the 232,448); beside a 16 x 16 sky they do not, and the check
    says so with the numbers."""
    ts, _, cfg = configs.config5_many_spheres(16, device="cpu")
    ts = dataclasses.replace(ts, spheres=dataclasses.replace(
        ts.spheres, texture=torch.full((64, 16, 16, 3), 0.5)))
    assert fused_vec.texel_step_smem_bytes(ts) == 211448 <= fused.MAX_BLOCK_SMEM
    fused_vec.check_vec_kernel_config(ts, dataclasses.replace(cfg, reflections=1))
    sky = dataclasses.replace(ts, env=torch.full((16, 16, 3), 0.5))
    assert fused_vec.texel_step_smem_bytes(sky) > fused.MAX_BLOCK_SMEM
    with pytest.raises(NotImplementedError, match="object texel grids this large: 49152"):
        fused_vec.check_vec_kernel_config(sky, cfg)


def test_cli_invert_config8_with_a_bounce_on_cpu():
    out = cli.main(["invert", "--device", "cpu", "--config", "8", "--reflections", "1", "--size",
                    "16", "--iters", "3", "--lr", "3e-2", "--perturb", "0.4", "--log-every", "1",
                    "--quiet"])
    hist = out["history"]
    assert len(hist) == 3 and hist[-1]["loss"] < hist[0]["loss"]
    start = configs.perturb(*configs.config8_globe(16, device="cpu")[:2], scale=0.4, seed=0)
    assert float((out["scene"].spheres.texture - start.spheres.texture).abs().max()) > 0


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def _jax_fn(case="cut", scene=None, g=None):
    """The compiled function's outputs with ``scene`` in ``case``'s place
    (the others the JAX package's scenes) and the cotangent ``g``."""
    args = [scene if c == case else _jax_scene(c)[0] for c in CASES]
    return _COMPILED["f"].result()(*args, jnp.zeros((SIZE, SIZE, 3)) if g is None else g)


@pytest.mark.parametrize("case", CASES)
def test_eager_vec_render_matches_jax(case):
    js, ts, cfg = _pair(case, perturbed=1)
    img = np.asarray(_jax_fn(case, js)[{"cut": 0, "cut_bounce": 2, "config7_bounce": 3}[case]])
    err = np.abs(img - render_eager_vec(ts, cfg).numpy())
    assert (err > 2e-3).mean() < 1e-3 and err.mean() < 1e-4, (err.max(), err.mean())


def _edge_mask(scene, cfg):
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
    return e


def test_step_twin_matches_jax_value_and_grad():
    """Row 6's twin against the value and gradient of the mse of
    `render_jnp_vec` on the cut (each package's target its own render of the
    truth), from perturb(scale=0.4, seed=0) of the texels: every leaf within
    1e-2 of its scale, the texels' gradient not 0."""
    js, ts, cfg = _pair("cut")
    jstart, tstart, _ = _pair("cut", perturbed=0)
    target, img = _jax_fn("cut", js)[0], _jax_fn("cut", jstart)[0]
    resid = img - target
    g_ref = _jax_fn("cut", jstart, 2.0 * resid / resid.size)[1]
    l_t, g_t = fused_vec.loss_grad_vec_adjoint_eager(tstart, cfg, render_eager_vec(ts, cfg))
    l_ref = float(jnp.mean(resid * resid))
    assert abs(float(l_t) - l_ref) <= 1e-4 * l_ref
    errs = _errors(jax.tree_util.tree_leaves(g_ref), g_t)
    assert max(errs.values()) <= 1e-2, errs
    assert bool(_texels(g_t).any())


def test_bwd_twin_matches_jax_vjp():
    """Row 5's twin against `jax.vjp` of a seeded normal cotangent zero next
    to an edge (`_edge_mask`) on the cut, every leaf within 1e-2 of its
    scale. At 32^2 every sphere's pixels lie next to an edge, so the texels'
    gradient is held by the step's test above."""
    jstart, tstart, cfg = _pair("cut", perturbed=0)
    keep = ~_edge_mask(tstart, cfg)
    assert keep.mean() > 0.4
    g = np.random.default_rng(0).normal(size=(SIZE, SIZE, 3)).astype(np.float32)
    g = g * keep[..., None]
    ref_g = _jax_fn("cut", jstart, jnp.asarray(g))[1]
    got = fused_vec.render_vec_bwd_adjoint_eager(tstart, cfg, torch.from_numpy(g),
                                                 fused_vec.render_vec_plain(tstart, cfg)[1])
    errs = _errors(jax.tree_util.tree_leaves(ref_g), got)
    assert max(errs.values()) <= 1e-2, errs
