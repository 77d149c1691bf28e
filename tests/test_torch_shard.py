"""The row bands and the sharded inverse render (`parallel.shard`) on the
CPU, against the JAX package and against the whole image.

- JAX's `render_sharded(..., make_ray_mesh(8), impl="jnp")` on the
  conftest's 8 fake devices against the port's single-process 8-band
  `render_sharded` on config 2 at 32^2, by the oracle rule; the port's
  bands put together are its whole-image render to the bit;
- one `make_sharded_step` step of both packages from the same start
  (perturb(scale=0.1, seed=3) of JAX's config 2, bridged), the target JAX's
  render: the loss, the grad norm and every stepped leaf within 1e-5 of its
  scale (measured: the loss 2.7e-7, the grad norm 9.6e-6, the leaves 1.5e-8;
  the two renders differ by an ulp at sphere limbs, tests/test_torch_optim.py);
- the eager twins of rows 2, 4 and 7 in 8 bands put together equal the
  whole image to the bit (image and planes); those of rows 1, 6 and 9 (the
  plain versions and the kernels' adjoint twins) and of rows 3, 5 and 8
  summed over the bands equal the whole image's within 1e-5 of each leaf's
  scale;
- `make_batched_step` on 2 scenes is each scene's own sharded step;
- the ``init``-before-``step`` error and the ``height % n`` error;
- ``invert --sharded --device cpu`` as one rank (a gloo group of one) gives
  the unsharded run's losses to the bit.

One JAX compile (its sharded render and step) runs in a thread from the
file's first test on. Two processes over gloo are in
tests/test_torch_distributed.py; the kernels' bands on a card in
tests/test_torch_kernels.py and chip_smoke.py (phases bands, sharded_main).
"""

import concurrent.futures
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from reversible_raytracer_tpu.models import configs as jconfigs
from reversible_raytracer_tpu.optim import OptConfig as JOptConfig
from reversible_raytracer_tpu.ops.pipeline import RenderConfig as JRenderConfig
from reversible_raytracer_tpu.ops.render import render_jnp
from reversible_raytracer_tpu.parallel import make_ray_mesh as jmake_ray_mesh
from reversible_raytracer_tpu.parallel import make_sharded_step as jmake_sharded_step
from reversible_raytracer_tpu.parallel import render_sharded as jrender_sharded
from reversible_raytracer_tpu_torch import cli
from reversible_raytracer_tpu_torch.bridge import scene_from_numpy
from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.models.scene import tree_leaves
from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec, fused_vec_soft
from reversible_raytracer_tpu_torch.ops.pipeline import RenderConfig, band_config
from reversible_raytracer_tpu_torch.ops.render import render
from reversible_raytracer_tpu_torch.optim import OptConfig, make_eager_step
from reversible_raytracer_tpu_torch.parallel import (
    make_batched_step,
    make_ray_mesh,
    make_scene_ray_mesh,
    make_sharded_step,
    render_sharded,
    stack_scenes,
    unstack_scenes,
)

SIZE = 32
N_BANDS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six test
    processes at once, and torch's default of a thread per core slows this
    file and the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _jax_case():
    """JAX's config 2 at SIZE, its start (perturb(scale=0.1, seed=3)), its
    8-device sharded render and one sharded step from the start against it,
    each compiled at XLA's backend optimization level 0 without LLVM's
    expensive passes (about 10 s; 97 s with them)."""
    js, jspec, _ = jconfigs.config2_four_spheres(SIZE)
    jcfg = JRenderConfig(height=SIZE, width=SIZE, shadows=True)
    mesh = jmake_ray_mesh(N_BANDS)
    render_fn = jax.jit(lambda x: jrender_sharded(x, jcfg, mesh, impl="jnp"))
    img = np.asarray(render_fn.lower(js).compile(compiler_options=_FAST)(js))
    jstart = jconfigs.perturb(js, jspec, scale=0.1, seed=3)
    step, init = jmake_sharded_step(mesh, jcfg, jspec, JOptConfig(iters=4, lr=1e-2))
    s, o, t = init(jstart, img)
    s, o, loss, gnorm = step.lower(s, o, t).compile(compiler_options=_FAST)(s, o, t)
    leaves = lambda tree: [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]  # noqa: E731
    return img, leaves(jstart), float(loss), float(gnorm), leaves(s)


_COMPILED = {}


@pytest.fixture(autouse=True, scope="module")
def _start_jax_compile():
    """Start the file's one JAX compile in a thread as its first test starts:
    XLA compiles without holding the GIL, so the tests before the JAX ones
    run meanwhile."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        _COMPILED["f"] = pool.submit(_jax_case)
        yield


def _oracle_rule(img, ref, atol=2e-3):
    err = np.abs(np.asarray(img) - np.asarray(ref))
    frac_bad = float((err > atol).mean())
    assert frac_bad < 1e-3, f"{frac_bad:.2%} of pixel-channels differ by more than {atol}"
    assert float(err.mean()) < 1e-4


def _assert_close_leaves(got, want, rel=1e-5):
    for a, b in zip(got, want, strict=True):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if b.size:
            scale = max(float(np.abs(b).max()), 1e-30)
            assert float(np.abs(a - b).max()) <= rel * scale, (a, b)


def _leaves(scene):
    return [x.detach().numpy() for x in tree_leaves(scene)]


def _config2():
    scene, spec, _ = configs.config2_four_spheres(SIZE, device="cpu")
    return scene, spec, RenderConfig(height=SIZE, width=SIZE, shadows=True)


def test_render_sharded_matches_jax():
    scene, _, cfg = _config2()
    img = render_sharded(scene, cfg, make_ray_mesh(N_BANDS), impl="eager")
    assert torch.equal(img, render(scene, cfg))
    _oracle_rule(img.numpy(), _COMPILED["f"].result()[0])


def test_sharded_step_matches_jax():
    jimg, jstart, jloss, jgnorm, jstepped = _COMPILED["f"].result()
    like, spec, cfg = _config2()
    start = scene_from_numpy(jstart, like=like, device="cpu")
    step, init = make_sharded_step(make_ray_mesh(N_BANDS), cfg, spec, OptConfig(iters=4, lr=1e-2))
    s, state, rows = init(start, torch.from_numpy(jimg.copy()))
    s, state, loss, gnorm = step(s, state, rows)
    assert abs(float(loss) - jloss) <= 1e-5 * jloss
    assert abs(float(gnorm) - jgnorm) <= 1e-5 * jgnorm
    _assert_close_leaves(_leaves(s), jstepped)


def _family(row):
    """(scene, spec, cfg) of the row's family at SIZE: config 2 (rows 1-3),
    config 5 (rows 4-6), config 5 at tau 0.08 (rows 7-9)."""
    if row <= 3:
        return _config2()
    scene, spec, cfg = configs.config5_many_spheres(SIZE, device="cpu")
    return scene, spec, dataclasses.replace(cfg, soft_tau=0.08 if row >= 7 else 0.0)


def _bands(cfg, n=N_BANDS):
    b = cfg.height // n
    return [(i * b, b) for i in range(n)]


@pytest.mark.parametrize("row, plain", [(2, fused.render_fused_plain),
                                        (4, fused_vec.render_vec_plain),
                                        (7, fused_vec_soft.render_vec_soft_plain)])
def test_band_forwards_put_together_are_the_image(row, plain):
    scene, _, cfg = _family(row)
    whole = plain(scene, cfg)
    parts = [plain(scene, cfg, r0, h) for r0, h in _bands(cfg)]
    if row == 7:
        assert torch.equal(torch.cat(parts), whole)
        return
    assert torch.equal(torch.cat([p[0] for p in parts]), whole[0])
    assert torch.equal(torch.cat([p[1] for p in parts], dim=1), whole[1])


_STEPS = {1: (fused.loss_grad_fused_plain, fused.loss_grad_adjoint_eager),
          6: (fused_vec.loss_grad_vec_plain, fused_vec.loss_grad_vec_adjoint_eager),
          9: (fused_vec_soft.loss_grad_vec_soft_plain,
              fused_vec_soft.loss_grad_vec_soft_adjoint_eager)}


def _sum_bands(fn, cfg, n=N_BANDS):
    """The sum over the bands of ``fn(band_cfg, r0, h) -> (loss, grads)``."""
    loss, total = 0.0, None
    for r0, h in _bands(cfg, n):
        l, g = fn(band_config(cfg, r0, h), r0, h)
        loss = loss + float(l)
        g = tree_leaves(g)
        total = g if total is None else [a + x for a, x in zip(total, g)]
    return loss, [x.numpy() for x in total]


@pytest.mark.parametrize("row", [1, 6, 9])
@pytest.mark.parametrize("twin", ["plain", "adjoint"])
def test_band_steps_sum_to_the_image(row, twin):
    scene, spec, cfg = _family(row)
    target = render(scene, cfg).detach()
    start = configs.perturb(scene, spec, scale=0.05, seed=1)
    fn = _STEPS[row][twin == "adjoint"]
    l, g = fn(start, cfg, target)
    lb, gb = _sum_bands(lambda bcfg, r0, h: fn(start, bcfg, target[r0:r0 + h]), cfg)
    assert abs(lb - float(l)) <= 1e-5 * float(l)
    _assert_close_leaves(gb, _leaves(g))


@pytest.mark.parametrize("row", [3, 5, 8])
def test_band_backwards_sum_to_the_image(row):
    scene, spec, cfg = _family(row)
    start = configs.perturb(scene, spec, scale=0.05, seed=1)
    g_img = torch.from_numpy(np.random.default_rng(row).normal(
        size=(cfg.height, cfg.width, 3)).astype(np.float32))
    if row == 8:
        whole = fused_vec_soft.render_vec_soft_bwd_adjoint_eager(start, cfg, g_img)
        fn = lambda bcfg, r0, h: (0.0, fused_vec_soft.render_vec_soft_bwd_adjoint_eager(  # noqa
            start, bcfg, g_img[r0:r0 + h]))
    else:
        plain = fused.render_fused_plain if row == 3 else fused_vec.render_vec_plain
        adjoint = (fused.render_bwd_adjoint_eager if row == 3
                   else fused_vec.render_vec_bwd_adjoint_eager)
        whole = adjoint(start, cfg, g_img, plain(start, cfg)[1])
        fn = lambda bcfg, r0, h: (0.0, adjoint(start, bcfg, g_img[r0:r0 + h],  # noqa: E731
                                               plain(start, bcfg)[1]))
    _assert_close_leaves(_sum_bands(fn, cfg)[1], _leaves(whole))


def test_batched_step_is_each_scenes_sharded_step():
    scene, spec, cfg = _config2()
    ocfg = OptConfig(iters=2, lr=1e-2)
    truths = [scene, configs.perturb(scene, spec, scale=0.2, seed=5)]
    targets = torch.stack([render(t, cfg).detach() for t in truths])
    starts = [configs.perturb(t, spec, scale=0.1, seed=6 + i) for i, t in enumerate(truths)]
    step, init = make_batched_step(make_scene_ray_mesh(2, 4), cfg, spec, ocfg)
    s, state, rows = init(stack_scenes(starts), targets)
    for _ in range(2):
        s, state, losses, _ = step(s, state, rows)
    assert losses.shape == (2,)
    for i, (start, final) in enumerate(zip(starts, unstack_scenes(s))):
        one, init1 = make_sharded_step(make_ray_mesh(4), cfg, spec, ocfg)
        s1, st1, rows1 = init1(start, targets[i])
        for _ in range(2):
            s1, st1, l1, _ = one(s1, st1, rows1)
        assert torch.equal(losses[i], l1)
        for a, b in zip(tree_leaves(final), tree_leaves(s1)):
            assert torch.equal(a, b)


def test_step_before_init_and_uneven_bands_raise():
    scene, spec, cfg = _config2()
    step, _ = make_sharded_step(make_ray_mesh(N_BANDS), cfg, spec, OptConfig(iters=1))
    with pytest.raises(RuntimeError, match="init"):
        step(scene, None, torch.zeros((SIZE, SIZE, 3)))
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_step(make_ray_mesh(3), cfg, spec, OptConfig(iters=1))
    with pytest.raises(ValueError, match="not divisible"):
        render_sharded(scene, cfg, make_ray_mesh(5))
    with pytest.raises(ValueError, match="does not fit"):
        render(scene, cfg, row0=24, out_height=16)


def test_sharded_step_is_the_eager_step_for_one_band():
    scene, spec, cfg = _config2()
    target = render(scene, cfg).detach()
    start = configs.perturb(scene, spec, scale=0.1, seed=2)
    ocfg = OptConfig(iters=3, lr=1e-2)
    step, init = make_sharded_step(make_ray_mesh(1), cfg, spec, ocfg)
    ref, ref_init = make_eager_step(cfg, spec, ocfg)
    s, st, rows = init(start, target)
    s1, st1 = start, ref_init(start)
    for _ in range(3):
        s, st, l, _ = step(s, st, rows)
        s1, st1, l1, _ = ref(s1, st1, target)
        assert torch.equal(l, l1)
    for a, b in zip(tree_leaves(s), tree_leaves(s1)):
        assert torch.equal(a, b)


def test_cli_sharded_one_rank(tmp_path):
    argv = ["invert", "--config", "2", "--size", str(SIZE), "--iters", "5", "--device", "cpu",
            "--quiet", "--metrics", str(tmp_path / "m.jsonl")]
    plain = cli.main(argv)
    try:
        out = cli.main([*argv, "--sharded"])
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert out["losses"] == plain["losses"]
    assert out["ranks"] == 1 and out["mesh"] == {"rays": 1}
    last = (tmp_path / "m.jsonl").read_text().splitlines()[-1]
    assert '"wall_s"' in last and '"mesh"' in last
