"""The port's object-vectorized renderer and packed rows against the JAX
package, the dispatch of scenes of more than 24 objects, and the config-5
CLI on the CPU.

- `render_eager_vec` vs `render_jnp_vec` (jitted) by the oracle rule of
  tests/test_render_vs_oracle.py, on config 5 cut to 25 spheres + ground
  (26 objects: the vec route) at 26x26;
- on scenes of at most 24 objects `render_eager_vec` gives the bits of the
  port's own `render_eager` (and `render_vec_plain` the visibility planes
  of `render_fused_plain`): the two port paths agree;
- `pack_spheres`, `pack_rects`, the flat globals and the transpose of the
  packing equal the JAX package's.
The vec kernels are held to their plain versions on a card in
tests/test_torch_kernels.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reversible_raytracer_tpu.models import configs as jconfigs
from reversible_raytracer_tpu.ops.kernels import fused_vec as jfused_vec
from reversible_raytracer_tpu.ops.kernels.fused import flatten_scene as jflatten
from reversible_raytracer_tpu.ops.pipeline_vec import render_jnp_vec
from reversible_raytracer_tpu_torch import cli
from reversible_raytracer_tpu_torch.bridge import scene_from_numpy
from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.models.scene import tree_leaves, tree_unflatten
from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec
from reversible_raytracer_tpu_torch.ops.pipeline_vec import render_eager_vec
from reversible_raytracer_tpu_torch.ops.render import (
    loss_and_grad_fn,
    render,
    render_eager,
    resolve_impl,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six test
    processes at once, and torch's default of a thread per core slows this
    file and the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SIZE, N_SPHERES = 26, 25


def _oracle_rule(img, ref, atol=2e-3):
    err = np.abs(np.asarray(img) - np.asarray(ref))
    frac_bad = float((err > atol).mean())
    assert frac_bad < 1e-3, f"{frac_bad:.2%} of pixel-channels differ by more than {atol}"
    assert float(err.mean()) < 1e-4


@pytest.fixture(scope="module")
def pair():
    """The JAX config-5 scene cut to 25 spheres, its port twin (bridged
    through numpy) and both RenderConfigs."""
    js, _, jcfg = jconfigs.config5_many_spheres(size=SIZE, n_spheres=N_SPHERES)
    like, _, tcfg = configs.config5_many_spheres(size=SIZE, n_spheres=N_SPHERES, device="cpu")
    ts = scene_from_numpy([np.asarray(x) for x in jax.tree_util.tree_leaves(js)],
                          like=like, device="cpu")
    return js, jcfg, ts, tcfg


def test_render_eager_vec_matches_jnp_vec(pair):
    js, jcfg, ts, tcfg = pair
    assert ts.spheres.count + ts.rects.count == 26
    ref = np.asarray(jax.jit(lambda s: render_jnp_vec(s, jcfg))(js))
    _oracle_rule(render_eager_vec(ts, tcfg).numpy(), ref)


@pytest.mark.parametrize("num, kw", [
    (1, {}), (2, {}), (3, {}), (5, dict(n_spheres=20)),
    (2, dict(spp=4)), (2, dict(projection="orthographic")), (2, dict(shader="depth")),
    (2, dict(shader="normal")), (2, dict(clip=False, shadows=False)),
])
def test_vec_paths_agree_bitwise(num, kw):
    """Up to 24 objects both port paths run: the vec trace (argmin over the
    object axis) gives the where chain's bits, image and planes."""
    cfg_kw = {k: v for k, v in kw.items() if k != "n_spheres"}
    scene, _, cfg = configs.CONFIGS[num](size=20, device="cpu", **(
        {"n_spheres": kw["n_spheres"]} if "n_spheres" in kw else {}))
    cfg = dataclasses.replace(cfg, height=20, width=24, **cfg_kw)
    torch.testing.assert_close(render_eager_vec(scene, cfg), render_eager(scene, cfg),
                               rtol=0, atol=0)
    img_v, vis_v = fused_vec.render_vec_plain(scene, cfg)
    img_f, vis_f = fused.render_fused_plain(scene, cfg)
    torch.testing.assert_close(img_v, img_f, rtol=0, atol=0)
    torch.testing.assert_close(vis_v, vis_f, rtol=0, atol=0)


def test_packing_matches_jax(pair):
    js, _, ts, _ = pair
    np.testing.assert_array_equal(fused_vec.pack_spheres(ts).numpy(),
                                  np.asarray(jfused_vec.pack_spheres(js)))
    np.testing.assert_array_equal(fused_vec.pack_rects(ts).numpy(),
                                  np.asarray(jfused_vec.pack_rects(js)))
    np.testing.assert_array_equal(fused_vec.flatten_globals(ts).numpy(),
                                  np.asarray(jflatten(jfused_vec.globals_tree(js))))
    ns_pad, nr_pad = fused_vec.row_plan(ts)
    assert (ns_pad, nr_pad) == (32, 16)
    jp = jfused_vec.pad_rows(jfused_vec.pack_spheres(js), ns_pad, jfused_vec._SPH_PAD_ROW)
    tp = fused_vec.pad_rows(fused_vec.pack_spheres(ts), ns_pad, fused_vec.SPH_PAD_ROW)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(fused_vec.RCT_PAD_ROW, jfused_vec._RCT_PAD_ROW)
    off = fused_vec.globals_offsets(ts.lights.count)
    assert off["Sg"] == fused_vec.flatten_globals(ts).numel() == 22
    glob = fused_vec.flatten_globals(ts)
    for key, leaf in (("ambient", ts.ambient), ("background", ts.background),
                      ("c_eye", ts.camera.eye), ("c_look", ts.camera.look_at),
                      ("c_up", ts.camera.up), ("c_fov", ts.camera.fov_deg),
                      ("l_pos", ts.lights.position), ("l_col", ts.lights.color)):
        torch.testing.assert_close(glob[off[key]:off[key] + leaf.numel()], leaf.reshape(-1),
                                   rtol=0, atol=0)
    full, _, _ = configs.config5_many_spheres(device="cpu")
    assert fused.scene_layout(full)[1] == 1132
    assert fused_vec.row_plan(full) == (64, 16)


def test_unpack_is_the_transpose_of_packing(pair):
    """`unpack_grads` against jax.vjp of the packing, on random cotangents
    of the globals and the real rows."""
    js, _, ts, _ = pair

    def pack_all(scene):
        return (jflatten(jfused_vec.globals_tree(scene)), jfused_vec.pack_spheres(scene),
                jfused_vec.pack_rects(scene))

    outs, vjp = jax.vjp(pack_all, js)
    rng = np.random.default_rng(0)
    cots = [rng.normal(size=np.shape(o)).astype(np.float32) for o in outs]
    (jgrads,) = vjp(tuple(jnp.asarray(c) for c in cots))
    ns_pad, nr_pad = fused_vec.row_plan(ts)
    pad = lambda c, n: torch.cat([torch.from_numpy(c), torch.ones((n - c.shape[0], c.shape[1]))])
    tgrads = fused_vec.unpack_grads(ts, torch.from_numpy(cots[0]), pad(cots[1], ns_pad),
                                    pad(cots[2], nr_pad))
    for a, b in zip(jax.tree_util.tree_leaves(jgrads), tree_leaves(tgrads)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_cpu_dispatch_by_object_count(pair):
    _, _, ts, tcfg = pair
    assert resolve_impl(ts, tcfg) == "eager_vec"
    torch.testing.assert_close(render(ts, tcfg), render_eager_vec(ts, tcfg), rtol=0, atol=0)
    small, _, cfg = configs.config2_four_spheres(16, device="cpu")
    assert resolve_impl(small, cfg) == "eager"
    target = torch.zeros((SIZE, SIZE, 3))
    l_a, g_a = loss_and_grad_fn(ts, tcfg)(ts, target)
    l_b, g_b = fused_vec.loss_grad_vec_plain(ts, tcfg, target)
    assert float(l_a) == float(l_b)
    for a, b in zip(tree_leaves(g_a), tree_leaves(g_b)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cpu_render_stays_differentiable(pair):
    """The CPU twins carry gradients, and the vec render backward's eager
    twin (the vec kernel's algorithm) gives autograd's for the cotangent of
    ``sum()`` (float32: 1e-4 of each leaf's scale, two summation orders)."""
    _, _, ts, tcfg = pair
    leaves = [l.clone().requires_grad_(True) for l in tree_leaves(ts)]
    scene = tree_unflatten(ts, leaves)
    render(scene, tcfg).sum().backward()
    assert float(leaves[0].grad.abs().sum()) > 0  # spheres.center
    twin = fused_vec.render_vec_bwd_adjoint_eager(ts, tcfg, torch.ones((SIZE, SIZE, 3)),
                                                  fused_vec.render_vec_plain(ts, tcfg)[1])
    for leaf, got in zip(leaves, tree_leaves(twin)):
        ref = torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
        if ref.numel():
            scale = max(float(ref.abs().max()), 1e-6)
            assert float((got - ref).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("kw, why", [
    (dict(spp=2), "spp"), (dict(reflections=4), "reflections"),
    (dict(shader="depth"), "depth"), (dict(projection="orthographic"), "orthographic"),
    (dict(soft_tau=0.1), "soft_tau"),
])
def test_vec_kernels_refuse_uncovered_configs(pair, kw, why):
    """spp 4 is covered (four launches of the forward and the backward, the
    step's loop in the kernel); any other spp is refused by name. One to
    three bounce levels are covered; four are refused by name."""
    _, _, ts, tcfg = pair
    fused_vec.check_vec_kernel_config(ts, dataclasses.replace(tcfg, spp=4))
    for refl in (2, 3):
        fused_vec.check_vec_kernel_config(ts, dataclasses.replace(tcfg, spp=4, reflections=refl))
    with pytest.raises(NotImplementedError, match=why):
        fused_vec.check_vec_kernel_config(ts, dataclasses.replace(tcfg, **kw))


def test_invert_config5_on_cpu():
    out = cli.main(["invert", "--device", "cpu", "--config", "5", "--size", "24", "--iters",
                    "3", "--log-every", "1"])
    losses = [r["loss"] for r in out["history"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
