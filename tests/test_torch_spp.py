"""spp 4 (2x2 supersampling) on the CPU against the JAX package.

A pixel is the average of four clipped subsamples at quarter-pixel offsets
(JAX `pipeline_vec.py:101` SPP4_OFFSETS), ((c0 + c1) + c2) + c3 times 0.25.
On config 5 cut to 9 spheres and its ground (10 objects: the unrolled and
the object-chunked families both take it) at 24x24, with shadows, from
perturb(scale=0.1, seed):

- the spp-4 images against the JAX package's, by the oracle rule of
  tests/test_render_vs_oracle.py (the two frameworks differ on a few limb
  and highlight pixels by up to 5e-4 at spp 4, as by up to 2e-3 at spp 1);
- the eager twins of the kernels that take spp 4, against the JAX
  package's vjp of its spp-4 render, by the rules that
  tests/test_torch_vec_step.py and tests/test_torch_render_grad.py hold at
  spp 1: rows 1 and 6 (`loss_grad_adjoint_eager`,
  `loss_grad_vec_adjoint_eager`: the residual of the average) the loss
  within 1e-4 relative and every trained leaf within 1e-2 of its scale at
  seeds 0-2 (the untrained leaves are printed, run with -s: the dense
  residual's limb pixels take camera.up to 2.2e-2 of scale at seed 0, as
  at spp 1); rows 3 and 5 (`render_bwd_adjoint_eager`,
  `render_vec_bwd_adjoint_eager`, with the forwards' 4 L planes) and row 8
  (`render_vec_soft_bwd_adjoint_eager`, tau 0.05) every leaf within 1e-2
  of its scale for a normal cotangent that is zero next to an edge in
  either image;
- `optim.anneal_stage_uses_step` against the JAX package's for every
  implementation and spp;
- `optimize_annealed` at spp 4, a soft stage (tau 0.05, autograd of the
  render) and the hard polish, 3 steps each, against the JAX package's
  stages driven step by step (value and gradient, and `make_flat_update`);
- `--spp 4` through `cli.main` (``render``, ``invert`` with its loss
  falling, ``invert --anneal``) and the CPU dispatch of a spp-4 soft step.

The JAX side compiles one function, shared by every test: JAX's hard and
soft renders of one subsample (`_render_hard_once`, `_render_soft`, the
bodies of `render_jnp_vec`) with their vjps, the offset an argument; its
spp-4 image and vjps are the four calls averaged and summed as
`spp_average` averages them. The kernels are held to these eager twins on
a card in tests/test_torch_kernels.py.
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
from reversible_raytracer_tpu.ops.pipeline_vec import SPP4_OFFSETS, _render_hard_once, _render_soft
from reversible_raytracer_tpu_torch import cli, optim
from reversible_raytracer_tpu_torch.bridge import scene_from_numpy, scene_to_numpy
from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.models.scene import leaf_paths, tree_leaves
from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec, fused_vec_soft
from reversible_raytracer_tpu_torch.ops.pipeline import SPP_OFFSETS, RenderConfig
from reversible_raytracer_tpu_torch.ops.render import loss_and_grad_fn, render, resolve_impl

SIZE, N_SPHERES, TAU, SCALE = 24, 9, 0.05, 0.1


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


def _pair(seed=None, scale=SCALE):
    """JAX's config 5 cut to 9 spheres (perturbed by ``seed`` if given), its
    spec, and the port's twin bridged through numpy."""
    js, jspec, _ = jconfigs.config5_many_spheres(SIZE, n_spheres=N_SPHERES)
    if seed is not None:
        js = jconfigs.perturb(js, jspec, scale=scale, seed=seed)
    like, _, _ = configs.config5_many_spheres(SIZE, n_spheres=N_SPHERES, device="cpu")
    return js, jspec, scene_from_numpy(_np_leaves(js), like=like, device="cpu")


def _cfg(**kw):
    return RenderConfig(height=SIZE, width=SIZE, shadows=True, spp=4, **kw)


@functools.lru_cache(maxsize=None)
def _jax_subsample():
    """``f(scene, oi, oj, g_hard, g_soft) -> (hard image, its vjp of g_hard,
    soft image, its vjp of g_soft)`` of one subsample at (oi, oj), jitted
    once. The row offset rides in ``row0``: JAX's renders form the rows as
    (row0 + iota) + oi, and (oi - 0.5 + i) + 0.5 is i + oi exactly for
    quarter offsets; the nonzero 0.5 also takes their offset branch without
    a test of the traced column offset."""
    cfg = JRenderConfig(height=SIZE, width=SIZE, shadows=True)
    soft = dataclasses.replace(cfg, soft_tau=TAU)

    def f(s, oi, oj, g_hard, g_soft):
        img, vjp = jax.vjp(lambda x: _render_hard_once(x, cfg, oi - 0.5, None, 0.5, oj), s)
        simg, svjp = jax.vjp(lambda x: _render_soft(x, soft, oi - 0.5, None, 0.5, oj), s)
        return img, vjp(g_hard)[0], simg, svjp(g_soft)[0]

    return jax.jit(f)


def _jax_spp4(js, soft=False, target=None, g=None):
    """The JAX package's spp-4 image of ``js`` and, for an image cotangent
    ``g`` or the mean squared error against ``target``, its loss and
    gradient: the four subsamples averaged as `spp_average` averages them,
    each subsample's vjp of a quarter of the average's cotangent, summed."""
    f = _jax_subsample()
    zero = jnp.zeros((SIZE, SIZE, 3))
    imgs = [np.asarray(f(js, oi, oj, zero, zero)[2 if soft else 0]) for oi, oj in SPP4_OFFSETS]
    img = ((imgs[0] + imgs[1]) + imgs[2]) + imgs[3]
    img = img * np.float32(0.25)
    if target is None and g is None:
        return img
    loss = None
    if target is not None:
        loss = float(np.mean((img - target) ** 2))
        g = 2.0 * (img - target) / img.size
    q = jnp.asarray(np.float32(0.25) * g, jnp.float32)
    grads = None
    for oi, oj in SPP4_OFFSETS:
        out = f(js, oi, oj, q, q)[3 if soft else 1]
        grads = out if grads is None else jax.tree_util.tree_map(jnp.add, grads, out)
    return img, loss, grads


def _errors_to_jax(jgrads, tgrads, like):
    """Each leaf's largest difference over its scale (the JAX side's largest
    magnitude), by path."""
    out = {}
    for path, a, b in zip(leaf_paths(like), _np_leaves(jgrads), tree_leaves(tgrads)):
        if a.size:
            out[path] = float(np.abs(b.numpy() - a).max()) / max(float(np.abs(a).max()), 1e-6)
    return out


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


def test_spp4_images_match_jax():
    """The port's spp-4 renders (the where chain, the object-vectorized hard
    render and the soft one) against the JAX package's."""
    js, _, ts = _pair()
    for soft, img in ((False, render(ts, _cfg())), (False, fused_vec.render_vec(ts, _cfg())[0]),
                      (True, render(ts, _cfg(soft_tau=TAU)))):
        err = np.abs(img.numpy() - _jax_spp4(js, soft))
        assert float((err > 2e-3).mean()) < 1e-3 and float(err.mean()) < 1e-4


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("row", [1, 6])
def test_spp4_step_twins_match_jax(row, seed):
    """Rows 1 and 6: the loss of the subsamples' average against the true
    scene's spp-4 image, and its gradient."""
    js, jspec, ts = _pair()
    target = _jax_spp4(js)
    jstart, _, tstart = _pair(seed=seed)
    _, j_loss, j_grads = _jax_spp4(jstart, target=target)
    twin = fused.loss_grad_adjoint_eager if row == 1 else fused_vec.loss_grad_vec_adjoint_eager
    t_loss, t_grads = twin(tstart, _cfg(), torch.from_numpy(target))
    assert abs(float(t_loss) - j_loss) <= 1e-4 * j_loss
    errs = _errors_to_jax(j_grads, t_grads, ts)
    trained = dict(zip(leaf_paths(ts), (bool(t) for t in jax.tree_util.tree_leaves(
        jspec.trainable))))
    held = {p: e for p, e in errs.items() if trained[p]}
    assert max(held.values()) <= 1e-2, held
    for p, e in errs.items():
        if p not in held:
            print(f"row {row} seed {seed} untrained {p}: {e:.3e} of scale")


@pytest.mark.parametrize("row", [3, 5, 8])
def test_spp4_render_bwd_twins_match_jax(row):
    """Rows 3 and 5 (with the forwards' 4 L planes) and row 8 (soft, tau
    0.05) for a normal cotangent of the average, zero next to an edge in
    the JAX package's image or the port's, at seed 0."""
    _, _, ts = _pair()
    jstart, _, tstart = _pair(seed=0)
    soft = row == 8
    cfg = _cfg(soft_tau=TAU if soft else 0.0)
    g = np.random.default_rng(0).normal(size=(SIZE, SIZE, 3)).astype(np.float32)
    g = g * ~_edge_mask(_jax_spp4(jstart, soft), render(tstart, cfg).numpy())[..., None]
    gt = torch.from_numpy(g)
    if row == 3:
        got = fused.render_bwd_adjoint_eager(tstart, _cfg(), gt, fused.render_fused(tstart,
                                                                                     _cfg())[1])
    elif row == 5:
        got = fused_vec.render_vec_bwd_adjoint_eager(tstart, _cfg(), gt,
                                                     fused_vec.render_vec(tstart, _cfg())[1])
    else:
        got = fused_vec_soft.render_vec_soft_bwd_adjoint_eager(tstart, cfg, gt)
    errs = _errors_to_jax(_jax_spp4(jstart, soft, g=g)[2], got, ts)
    assert max(errs.values()) <= 1e-2, errs


@pytest.mark.parametrize("spp", [1, 4])
def test_anneal_stage_uses_step_matches_jax(spp):
    """The JAX package's names for the port's: the object-chunked hard and
    soft kernels, and the eager twin (JAX's `render_jnp_vec`). The port's
    small-scene hard step ("cuda", which the JAX anneal never picks) fuses
    spp 1 and 4 as "cuda_vec" does."""
    for port, jax_name in (("cuda_vec", "pallas_vec"), ("cuda_vec_soft", "pallas_vec_soft"),
                           ("eager_vec", "jnp_vec"), ("eager", "jnp_vec")):
        assert optim.anneal_stage_uses_step(port, spp) == joptim.anneal_stage_uses_step(
            jax_name, spp)
    assert optim.anneal_stage_uses_step("cuda", spp)
    assert not optim.anneal_stage_uses_step("cuda_vec_soft", 4)


def test_optimize_annealed_spp4_matches_jax():
    """Two stages, tau 0.05 (each soft stage's target the truth rendered at
    its tau; Adam) and 0 (the hard polish: SGD at lr 0.3 against the hard
    target), 3 steps each, at spp 4, from tests/test_torch_anneal.py's start
    (perturb(scale=0.15, seed=1)): every step's loss within 5e-4 relative
    and the trained leaves within 1e-2 absolute, that file's rule."""
    iters = 3
    js, jspec, ts = _pair()
    _, tspec, _ = configs.config5_many_spheres(SIZE, n_spheres=N_SPHERES, device="cpu")
    jscene, _, tstart = _pair(seed=1, scale=0.15)
    hard_target = _jax_spp4(js)
    ocfg = dict(iters=iters, lr=2e-3)
    jlosses = []
    sgd = dataclasses.replace(joptim.OptConfig(**ocfg), optimizer="sgd", lr=0.3, momentum=0.0)
    for tau, jo in ((TAU, joptim.OptConfig(**ocfg)), (0.0, sgd)):
        target = _jax_spp4(js, soft=True) if tau else hard_target
        jinit, japply = joptim.make_flat_update(jscene, jspec, jo)
        jstate = jinit(jscene)
        for _ in range(iters):
            _, loss, grads = _jax_spp4(jscene, soft=bool(tau), target=target)
            jlosses.append(loss)
            jscene, jstate, _ = japply(jscene, jstate, grads)
    tfinal, tlosses = optim.optimize_annealed(
        tstart, torch.from_numpy(hard_target), tspec, _cfg(), optim.OptConfig(**ocfg),
        taus=(TAU, 0.0), target_scene=ts)
    np.testing.assert_allclose(tlosses.numpy(), jlosses, rtol=5e-4)
    trained = [bool(t) for t in jax.tree_util.tree_leaves(jspec.trainable)]
    for a, b, t in zip(_np_leaves(jscene), scene_to_numpy(tfinal), trained):
        if t:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-2)


def test_spp4_soft_step_on_cpu_is_autograd_of_render():
    """A spp-4 soft training step is autograd of `render` (no step kernel
    takes it, as in the JAX package); a card would reach it through the
    soft forward and backward kernels (`resolve_impl`), and the soft step's
    twin refuses spp 4 by name."""
    _, _, ts = _pair()
    _, _, tstart = _pair(seed=2)
    cfg = _cfg(soft_tau=TAU)
    target = render(ts, cfg)
    l_a, g_a = loss_and_grad_fn(tstart, cfg)(tstart, target)
    l_p, g_p = fused_vec_soft.loss_grad_vec_soft_plain(tstart, cfg, target)
    assert float(l_a) == float(l_p)
    assert torch.equal(fused.flatten_scene(g_a), fused.flatten_scene(g_p))
    assert resolve_impl(tstart, cfg) == "eager_vec"
    with pytest.raises(NotImplementedError, match="spp=4 in the soft step"):
        fused_vec_soft.loss_grad_vec_soft_adjoint_eager(tstart, cfg, target)
    assert SPP_OFFSETS[4] == [tuple(o) for o in SPP4_OFFSETS]


def test_cli_spp4_on_cpu(tmp_path):
    """``--spp 4`` on ``render`` and ``invert`` (config 2, its loss falling)
    and on ``invert --anneal`` (config 5 at 24x24)."""
    png = tmp_path / "r.png"
    cli.main(["render", "--device", "cpu", "--config", "2", "--size", "16", "--spp", "4",
              "-o", str(png)])
    assert png.read_bytes().startswith(b"\x89PNG")
    out = cli.main(["invert", "--device", "cpu", "--config", "2", "--size", "16", "--spp", "4",
                    "--iters", "6", "--log-every", "1", "--quiet", "--lr", "2e-2"])
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 6 and losses[-1] < losses[0]
    ann = cli.main(["invert", "--device", "cpu", "--config", "5", "--size", "24", "--spp", "4",
                    "--anneal", "0.05,0", "--iters", "2", "--quiet"])
    assert len(ann["losses"]) == 4 and np.isfinite(ann["losses"]).all()
    with pytest.raises(SystemExit):
        cli.main(["render", "--device", "cpu", "--spp", "2"])
