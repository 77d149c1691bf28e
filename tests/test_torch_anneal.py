"""The port's annealed inversion on the CPU against the JAX package: the
SGD update, the per-stage dispatch, `optimize_annealed`, and `invert
--anneal`.

- plain SGD in `make_flat_update` against the JAX package's, bit for bit
  on the flat vectors (with and without lr_scales, constant and cosine
  learning rates: the same float32 multiplies in the same order);
- each stage's dispatch, which is `ops.render`'s: the soft kernels for tau
  > 0 and the object-chunked kernels for config 5's tau = 0 polish on
  CUDA, the eager twins on the CPU, a refusal (never a fallback) for what
  the kernels do not take;
- `optimize_annealed` against the JAX package's on the CPU (its stages run
  through `render_jnp_vec` there): config 5 cut to 9 spheres at 16x16,
  without shadows, stages tau 0.05 and 0, 3 steps each, every stage against
  the hard target (no re-rendered stage targets: the JAX side would render
  them op by op). Both cuts only spare the JAX side's compiles; the soft
  shadows' gradient is held to JAX in tests/test_torch_soft.py. From
  perturb(scale=0.15, seed=1): every step's loss within 5e-4 relative (the
  first, of the same scene, already differs by 1.2e-4: the two frameworks'
  rays differ by an ulp, which limb pixels magnify) and the final trained
  leaves within 1e-2 absolute (the hard stage's SGD at lr 0.3 moves a leaf
  by 0.3 times its gradient, where one grazing pixel's differs);
- `optimize`'s per-step losses: one device tensor, the same values that
  its logged history reads;
- the CLI: ``invert --device cpu --config 5 --size 24 --anneal 0.05,0
  --iters 2``.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reversible_raytracer_tpu import optim as joptim
from reversible_raytracer_tpu.models import configs as jconfigs
from reversible_raytracer_tpu.ops.pipeline import RenderConfig as JRenderConfig
from reversible_raytracer_tpu_torch import cli, optim
from reversible_raytracer_tpu_torch.bridge import scene_from_numpy, scene_to_numpy
from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.ops.pipeline import RenderConfig
from reversible_raytracer_tpu_torch.ops.pipeline_vec import render_eager_vec
from reversible_raytracer_tpu_torch.ops.render import resolve_impl


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


@pytest.mark.parametrize("lr_scales, schedule, momentum",
                         [((), "constant", 0.0), ((("spheres.radius", 0.3),), "constant", 0.0),
                          ((), "cosine", 0.0), ((), "cosine", 0.9)],
                         ids=["lr_scales0-constant", "lr_scales1-constant", "lr_scales2-cosine",
                              "lr_scales3-cosine-momentum"])
def test_sgd_update_matches_jax_bitwise(lr_scales, schedule, momentum):
    js, jspec, _ = jconfigs.config5_many_spheres(16, n_spheres=9)
    ts, tspec, _ = configs.config5_many_spheres(16, n_spheres=9, device="cpu")
    kw = dict(iters=5, lr=0.3, optimizer="sgd", schedule=schedule, lr_scales=lr_scales,
              momentum=momentum)
    jinit, japply = joptim.make_flat_update(js, jspec, joptim.OptConfig(**kw))
    tinit, tapply = optim.make_flat_update(ts, tspec, optim.OptConfig(**kw))
    jstate, tstate = jinit(js), tinit(ts)
    rng = np.random.default_rng(0)
    jscene, tscene = js, ts
    for _ in range(3):
        grads = [rng.normal(0.0, 1e-2, size=np.shape(l)).astype(np.float32)
                 for l in _np_leaves(js)]
        jg = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(js),
                                          [jnp.asarray(g) for g in grads])
        tg = scene_from_numpy(grads, like=ts, device="cpu")
        jscene, jstate, jn = japply(jscene, jstate, joptim.mask_grads(jg, jspec))
        tscene, tstate, tn = tapply(tscene, tstate, optim.mask_grads(tg, tspec))
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        for a, b in zip(_np_leaves(jscene), scene_to_numpy(tscene)):
            np.testing.assert_array_equal(b, a)


def test_anneal_stage_decisions():
    cpu_scene, _, _ = configs.config5_many_spheres(16, n_spheres=9, device="cpu")
    soft = RenderConfig(height=16, width=16, soft_tau=0.05)
    hard = RenderConfig(height=16, width=16)
    assert resolve_impl(cpu_scene, soft) == "eager_vec"
    assert resolve_impl(cpu_scene, hard) == "eager"  # 10 objects: the unrolled twin

    def card(textured=False, env=False, device="cuda"):  # what the dispatch reads
        k = 16 if textured else 0
        return SimpleNamespace(device=torch.device(device), env_mapped=env,
                               env=torch.zeros((16, 16, 3) if env else (0, 0, 3)),
                               spheres=SimpleNamespace(count=64, textured=textured,
                                                       texture=torch.zeros((64, k, k, 3))),
                               rects=SimpleNamespace(count=1, textured=False,
                                                     texture=torch.zeros((1, 0, 0, 3))),
                               lights=SimpleNamespace(count=1))

    assert resolve_impl(card(), soft) == "cuda_vec_soft"
    assert resolve_impl(card(), hard) == "cuda_vec"
    # object textures past 24 objects take the hard object-chunked kernels and
    # the soft kernels' texel instances, at spp 1 and 4 (a spp-4 soft stage
    # steps by autograd of the render); four bounces stay refused, and the soft
    # kernels refuse the globes' grids beside a sky (their gradient does not
    # fit a block)
    assert resolve_impl(card(textured=True), soft) == "cuda_vec_soft"
    assert resolve_impl(card(env=True), soft) == "cuda_vec_soft"
    assert resolve_impl(card(textured=True), dataclasses.replace(soft, spp=4)) == "cuda_vec_soft"
    assert not optim.anneal_stage_uses_step("cuda_vec_soft", 4)
    assert resolve_impl(card(textured=True), dataclasses.replace(hard, spp=4)) == "cuda_vec"
    assert resolve_impl(card(textured=True),
                        dataclasses.replace(hard, spp=4, reflections=2)) == "cuda_vec"
    for bad, cfg in ((card(textured=True), dataclasses.replace(hard, spp=4, reflections=4)),
                     (card(textured=True, env=True), soft)):
        with pytest.raises(NotImplementedError):
            resolve_impl(bad, cfg)
    # the hard object-chunked kernels take the environment map (config 10)
    assert resolve_impl(card(env=True), hard) == "cuda_vec"
    # spp 4 renders on the soft kernels (a spp-4 soft step is autograd of
    # that render, optim.anneal_stage_uses_step); any other spp is refused
    assert resolve_impl(card(), dataclasses.replace(soft, spp=4)) == "cuda_vec_soft"
    with pytest.raises(NotImplementedError, match="spp=2"):
        resolve_impl(card(), dataclasses.replace(soft, spp=2))
    with pytest.raises(NotImplementedError):
        resolve_impl(card(device="meta"), soft)


def test_optimize_annealed_matches_jax():
    size, taus, iters = 16, (0.05, 0.0), 3
    js, jspec, _ = jconfigs.config5_many_spheres(size, n_spheres=9)
    ts, tspec, _ = configs.config5_many_spheres(size, n_spheres=9, device="cpu")
    target = render_eager_vec(ts, RenderConfig(height=size, width=size, shadows=False))
    jstart = jconfigs.perturb(js, jspec, scale=0.15, seed=1)
    tstart = scene_from_numpy(_np_leaves(jstart), like=ts, device="cpu")
    jfinal, jlosses = joptim.optimize_annealed(
        jstart, jnp.asarray(target.numpy()), jspec,
        JRenderConfig(height=size, width=size, shadows=False),
        joptim.OptConfig(iters=iters, lr=2e-3), taus=taus)
    tfinal, tlosses = optim.optimize_annealed(
        tstart, target, tspec, RenderConfig(height=size, width=size, shadows=False),
        optim.OptConfig(iters=iters, lr=2e-3), taus=taus)
    assert tlosses.shape == (len(taus) * iters,)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses), rtol=5e-4)
    trained = [bool(t) for t in jax.tree_util.tree_leaves(jspec.trainable)]
    for a, b, t in zip(_np_leaves(jfinal), scene_to_numpy(tfinal), trained):
        if t:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-2)
    assert float(optim.param_error(tfinal, ts, tspec)) < float(
        optim.param_error(tstart, ts, tspec))


def test_optimize_losses_on_device():
    """Per-step losses come back in order in one tensor, whether or not
    steps are logged, and agree with the logged history."""
    ts, tspec, cfg = configs.config5_many_spheres(12, n_spheres=9, device="cpu")
    target = render_eager_vec(ts, cfg)
    start = configs.perturb(ts, tspec, scale=0.1, seed=0)
    ocfg = optim.OptConfig(iters=5, lr=1e-2)
    final, hist, losses = optim.optimize(start, target, tspec, cfg, ocfg, log_every=0)
    assert hist == [] and losses.shape == (5,)
    final1, hist1, losses1 = optim.optimize(start, target, tspec, cfg, ocfg, log_every=1)
    np.testing.assert_array_equal(losses.numpy(), [h["loss"] for h in hist1])
    np.testing.assert_array_equal(losses1.numpy(), losses.numpy())
    for a, b in zip(scene_to_numpy(final), scene_to_numpy(final1)):
        np.testing.assert_array_equal(a, b)


def test_invert_anneal_on_cpu(tmp_path):
    png = tmp_path / "final.png"
    out = cli.main(["invert", "--device", "cpu", "--config", "5", "--size", "24", "--anneal",
                    "0.05,0", "--iters", "2", "-o", str(png)])
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    assert out["taus"] == [0.05, 0.0]
    assert np.isfinite(out["param_err"]) and png.read_bytes().startswith(b"\x89PNG")
    with pytest.raises(SystemExit):
        cli.main(["invert", "--device", "cpu", "--config", "5", "--size", "8", "--anneal",
                  "0.05,x", "--iters", "1"])
