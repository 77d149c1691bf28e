"""Two and three mirror bounces (``RenderConfig.reflections`` = 2, 3) in the
port's hard families, on the CPU, against the JAX package's float64 oracle.

The cases, each at 48x48 or less: config 6 (a chrome sphere, a diffuse one,
a reflective checkered floor), config 10 cut to 16 chrome spheres (17
objects) under a 4 x 4 sky, and config 8's globe with mirror coefficients
(the globe 0.3, the floor 0.4), so that a textured winner is seen at every
bounce level.

- the eager renders, `render_eager` (the where chain) and `render_eager_vec`
  (objects on a leading axis), in float64, at K = 2 and 3 against
  `oracle.reference_np.render(..., reflections=K)` by the rule of
  tests/test_reflections.py (max < 1e-3, mean < 1e-5);
- the eager twins of the kernels' adjoints (`fused.loss_grad_adjoint_eager`,
  `fused.render_bwd_adjoint_eager` and their object-chunked counterparts) at
  K = 2 and 3, spp 1 and 4, against torch autograd of the eager render in
  float64, from a start with geometry, materials, lights, the camera and the
  sky moved: every leaf within 1e-9 of its scale;
- the twin's gradient at K = 2 against central finite differences of the
  oracle's mean squared error (`test_grads_match_oracle_fd`'s rule, 2%
  relative) on the chrome sphere's and the floor's mirror coefficients and on
  the diffuse sphere's centre, which the second bounce sees;
- the object-chunked forward's twin (`render_vec_culled`) against its plain
  version at K = 2 and 3: the image bit for bit, each level's planes on the
  pixels where it and every level above hit, 0 elsewhere;
- the kernels' checks take K = 2 and 3 at spp 1 and 4 on every branch that
  takes one bounce, and refuse K = 4 by name with the numbers;
- the CLI: `invert --config 6 --reflections 2` at 32x32 on the CPU, whose
  mirror RMS error falls;
- `vecmath.safe_pow`'s capped exponent, which keeps the adjoint finite where
  a stretched bounce level's specular term would overflow.

Nothing here compiles a JAX function: the oracle is numpy, and the port's
scenes go to it as they are. The kernels are held to these plain versions on
a card in tests/test_torch_kernels.py and chip_smoke.py (phases bounces,
bounces_main).
"""

import dataclasses

import numpy as np
import pytest
import torch

from reversible_raytracer_tpu.oracle import reference_np as ref
from reversible_raytracer_tpu_torch import cli
from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.models.scene import (
    ParamSpec,
    leaf_paths,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from reversible_raytracer_tpu_torch.ops import vecmath as vm
from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec
from reversible_raytracer_tpu_torch.ops.pipeline import RenderConfig
from reversible_raytracer_tpu_torch.ops.pipeline_vec import render_eager_vec
from reversible_raytracer_tpu_torch.ops.render import render_eager

CASES = ("config6", "config10_cut", "config8_mirrors")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six test
    processes at once, and torch's default of a thread per core slows this
    file and the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _with_mirrors(scene, sphere_m, rect_m):
    sp, rc = scene.spheres, scene.rects
    return dataclasses.replace(
        scene,
        spheres=dataclasses.replace(sp, material=dataclasses.replace(
            sp.material, mirror=torch.full_like(sp.material.mirror, sphere_m))),
        rects=dataclasses.replace(rc, material=dataclasses.replace(
            rc.material, mirror=torch.full_like(rc.material.mirror, rect_m))))


def _case(name, size):
    """(scene, the leaves a start moves) of a case at ``size``^2."""
    if name == "config6":
        scene = configs.config6_mirror(size, device="cpu")[0]
        moved = ("spheres.center", "spheres.radius", "spheres.material.color",
                 "spheres.material.ks", "spheres.material.mirror", "rects.origin",
                 "rects.material.color", "rects.material.mirror", "lights.position",
                 "lights.color", "camera.eye", "ambient")
    elif name == "config10_cut":
        scene = configs.config10_chrome_field(size, n_spheres=16, env_k=4, device="cpu")[0]
        moved = ("env", "spheres.center", "spheres.radius", "spheres.material.mirror",
                 "spheres.material.ks", "spheres.material.color", "rects.origin",
                 "rects.edge_u", "lights.position", "camera.eye", "camera.look_at",
                 "camera.fov_deg", "ambient")
    else:
        scene = _with_mirrors(configs.config8_globe(size, tex_k=8, device="cpu")[0], 0.3, 0.4)
        moved = ("spheres.texture", "spheres.center", "spheres.material.mirror",
                 "rects.material.mirror", "rects.origin", "lights.position", "camera.eye",
                 "ambient")
    return scene, moved


def _f64(scene):
    return tree_map(lambda x: x.to(torch.float64), scene)


def _moved(name, size):
    """A case in float64 and a start with its ``moved`` leaves perturbed."""
    scene, moved = _case(name, size)
    spec = ParamSpec.none(scene)
    for path in moved:
        spec = spec.train(path, lower=-20.0, upper=20.0)
    return _f64(scene), _f64(configs.perturb(scene, spec, scale=0.02, seed=1))


def _errors(want, got):
    """Worst |got - want| / scale(want) per non-empty leaf."""
    out = {}
    for path, a, b in zip(leaf_paths(got), tree_leaves(want), tree_leaves(got)):
        if a.numel():
            out[path] = float((b - a).abs().max()) / max(float(a.abs().max()), 1e-6)
    return out


# ---------------------------------------------------------------------------
# The eager renders against the float64 oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reflections", [2, 3])
@pytest.mark.parametrize("render_fn", [render_eager, render_eager_vec],
                         ids=["where_chain", "object_axis"])
@pytest.mark.parametrize("name", CASES)
def test_eager_render_matches_f64_oracle(name, render_fn, reflections):
    """In float64, as the oracle renders (in float32 one grazing pixel of
    config 10's cut at 48x48 is 3.4e-3 off the oracle at one level already)."""
    scene = _f64(_case(name, 48)[0])
    img = render_fn(scene, RenderConfig(height=48, width=48, reflections=reflections)).numpy()
    orc = ref.render(scene, 48, 48, reflections=reflections)
    assert np.abs(img - orc).max() < 1e-3
    assert np.abs(img - orc).mean() < 1e-5
    # the deeper level shows: the image is not the one of a level fewer
    fewer = ref.render(scene, 48, 48, reflections=reflections - 1)
    assert np.abs(fewer - orc).max() > 1e-3


# ---------------------------------------------------------------------------
# The adjoint twins against autograd (float64)
# ---------------------------------------------------------------------------


def _twins(name):
    """The case's step and render backward twins with their plain versions,
    by family: config 6 the unrolled one's, the others the object-chunked
    one's (config 8's globe with a bounce takes it at any object count)."""
    if name == "config6":
        return (fused.loss_grad_adjoint_eager, fused.loss_grad_fused_plain,
                fused.render_bwd_adjoint_eager, fused.render_fused_bwd_plain,
                fused.render_fused_plain, render_eager)
    return (fused_vec.loss_grad_vec_adjoint_eager, fused_vec.loss_grad_vec_plain,
            fused_vec.render_vec_bwd_adjoint_eager, fused_vec.render_vec_bwd_plain,
            fused_vec.render_vec_plain, render_eager_vec)


@pytest.mark.parametrize("spp", [1, 4])
@pytest.mark.parametrize("reflections", [2, 3])
@pytest.mark.parametrize("name", CASES)
def test_twins_match_autograd_float64(name, reflections, spp):
    scene, start = _moved(name, 16)
    step_twin, step_plain, bwd_twin, bwd_plain, fwd_plain, render_fn = _twins(name)
    cfg = RenderConfig(height=12, width=16, reflections=reflections, spp=spp)
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(12, 16, 3)))
    got = bwd_twin(start, cfg, g, fwd_plain(start, cfg)[1])
    errs = _errors(bwd_plain(start, cfg, g), got)
    assert max(errs.values()) <= 1e-9, errs
    target = render_fn(scene, cfg)
    l_t, g_t = step_twin(start, cfg, target)
    l_a, g_a = step_plain(start, cfg, target)
    assert abs(float(l_t) - float(l_a)) <= 1e-12 * float(l_a)
    errs = _errors(g_a, g_t)
    assert max(errs.values()) <= 1e-9, errs
    # the levels above the deepest blend: the mirror coefficients have a gradient
    assert float(g_t.spheres.material.mirror.abs().max()) > 0.0
    if name == "config8_mirrors":  # textured winners at the bounce levels
        assert float(g_t.spheres.texture.abs().max()) > 0.0


def test_twin_gradient_matches_oracle_fd():
    """At K = 2, the twin's mse gradient against central differences of the
    oracle's: the chrome sphere's and the floor's mirror coefficients, and the
    x of the diffuse sphere's centre, seen in the chrome sphere directly and
    through the floor's reflection."""
    H = W = 40
    scene = _f64(configs.config6_mirror(H, device="cpu")[0])
    cfg = RenderConfig(height=H, width=W, reflections=2)
    tgt = ref.render(scene, H, W, reflections=2) * 0.9
    _, g = fused.loss_grad_adjoint_eager(scene, cfg, torch.from_numpy(tgt))

    def oracle_loss(s):
        return ref.mse_loss(ref.render(s, H, W, reflections=2), tgt)

    def moved(path, index, d):
        leaves = [x.clone() for x in tree_leaves(scene)]
        at = leaf_paths(scene).index(path)
        leaves[at].view(-1)[index] += d
        return tree_unflatten(scene, leaves)

    eps = 1e-5
    for path, index, an in (
            ("spheres.material.mirror", 0, g.spheres.material.mirror[0]),
            ("rects.material.mirror", 0, g.rects.material.mirror[0]),
            ("spheres.center", 3, g.spheres.center[1, 0])):
        fd = (oracle_loss(moved(path, index, eps)) - oracle_loss(moved(path, index, -eps))) / (
            2 * eps)
        assert abs(float(an) - fd) / max(abs(fd), 1e-9) < 0.02, (path, float(an), fd)


# ---------------------------------------------------------------------------
# The object-chunked forward's twin, the checks and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reflections", [2, 3])
def test_culled_twin_matches_plain(reflections):
    """Row 4's eager twin gives the plain version's image bit for bit, and
    each level's planes on the pixels where that level and every level above
    hit (`fused_vec.level_hits`), 0 elsewhere."""
    scene, _ = _case("config10_cut", 32)
    cfg = RenderConfig(height=32, width=32, reflections=reflections)
    img, vis = fused_vec.render_vec_culled(scene, cfg)
    img_p, vis_p = fused_vec.render_vec_plain(scene, cfg)
    assert torch.equal(img, img_p)
    assert vis.shape == vis_p.shape == (1 + reflections, 32, 32)
    hits = fused_vec.level_hits(scene, cfg)
    assert len(hits) == 1 + reflections
    for lv, hit in enumerate(hits):
        assert torch.equal(vis[lv][hit], vis_p[lv][hit]) and not vis[lv][~hit].any()
    assert bool(hits[-1].any()) and bool((hits[-2] & ~hits[-1]).any())


@pytest.mark.parametrize("name", CASES)
def test_checks_take_two_and_three_levels(name):
    """Both hard families' checks pass at K = 2 and 3, spp 1 and 4, where
    they pass at one level (the unrolled family refuses object textures
    beside a bounce, as the JAX package's kernels do); K = 4 is refused by
    name, with the numbers."""
    scene, _ = _case(name, 16)
    flat = not fused_vec.object_textured(scene)
    for refl in (2, 3):
        for spp in (1, 4):
            cfg = RenderConfig(height=16, width=16, reflections=refl, spp=spp)
            fused_vec.check_vec_kernel_config(scene, cfg)
            if flat:
                fused.check_kernel_config(scene, cfg)
    four = RenderConfig(height=16, width=16, reflections=4)
    for check in (fused.check_kernel_config, fused_vec.check_vec_kernel_config):
        with pytest.raises(NotImplementedError, match=r"reflections > 3 \(reflections=4; .* "
                                                      r"= 80 > 64\)"):
            check(scene, four)


def test_cli_invert_config6_two_bounces_on_cpu():
    out = cli.main(["invert", "--device", "cpu", "--config", "6", "--size", "32",
                    "--reflections", "2", "--perturb", "0.3", "--lr", "2e-2", "--iters", "15",
                    "--seed", "3", "--log-every", "14"])
    errs = [h["param_err"] for h in out["history"]]
    assert errs[-1] < 0.5 * errs[0] and out["param_err"] < 0.5 * errs[0]


def test_capped_specular_keeps_the_adjoint_finite():
    """`vecmath.safe_pow` caps its exponent at `POW_LOG_MAX`. Past a
    near-tangent hit a bounce level's normal and reflected ray lose their
    unit length (config 10 at K = 3, 512^2, on the card: |n| 3.3 and |d| 1.6
    at level 3), shin log x passes float32's range, and the clipped pixel's
    zero cotangent times exp's infinity would be NaN in the gradient. Here,
    of a unit normal and ray and of ones so stretched: below the cap the
    value is exp(p log x) to the bit; past it e^64, and the twin's light
    adjoint and autograd of `safe_pow` stay finite, zero for a zero
    cotangent, with no shin or direction gradient through the capped term."""
    scene, _, _ = configs.config6_mirror(size=8, device="cpu")
    lp = scene.lights.position[0]
    ldir = lp / torch.linalg.norm(lp)
    so = tuple(torch.zeros(2) for _ in range(3))
    n = tuple(torch.stack([ldir[c], 3.26 * ldir[c]]) for c in range(3))
    d = tuple(torch.stack([-ldir[c], -1.65 * ldir[c]]) for c in range(3))
    base = tuple(torch.full((2,), 0.5) for _ in range(3))
    kd, ksp, shin = torch.tensor(0.35), torch.tensor(0.4), torch.tensor(60.0)
    f = fused.light_terms(scene.lights, 0, so, n, d, base, kd, ksp, shin)
    assert float(f.rdotv[1]) > 30.0 and float(shin * torch.log(f.rdotv[1])) > vm.POW_LOG_MAX
    assert f.pw[0] == torch.exp(shin * torch.log(f.rdotv[0]))
    assert f.pw[1] == torch.exp(torch.tensor(vm.POW_LOG_MAX))
    for scale in (0.0, 1.0):
        gh = tuple(torch.full((2,), scale) for _ in range(3))
        g = fused.light_adjoint(f, gh, torch.ones(2), n, d, base, kd, ksp, shin)
        leaves = [g.kd, g.ks, g.shin, g.vis, *g.d, *g.n, *g.ldir, *g.base, *g.lcol]
        assert all(bool(torch.isfinite(x).all()) for x in leaves)
        assert scale or not any(bool(x.any()) for x in leaves)
    assert g.shin[1] == 0 and all(c[1] == 0 and c[0] != 0 for c in g.d)

    x = torch.tensor([0.5, 34.0], requires_grad=True)
    p = torch.tensor(60.0, requires_grad=True)
    y = vm.safe_pow(x, p)
    assert y[0] == torch.exp(p * torch.log(x[0])) and torch.isfinite(y).all()
    (y * 0.0).sum().backward()
    assert not x.grad.any() and not p.grad.any()
    x.grad, p.grad = None, None
    vm.safe_pow(x, p).sum().backward()
    assert x.grad[1] == 0 and x.grad[0] > 0 and torch.isfinite(p.grad)
