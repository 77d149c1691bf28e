"""The training step: the plain version (autograd over the eager renderer)
against the JAX package, and the hand-written adjoint that the CUDA step
kernel runs, in eager torch, against autograd.

Tolerances:
- port vs JAX: loss within 1e-4 relative and gradient leaves within 1e-2
  of the leaf's scale (the rule of tests/test_fused_step.py), from
  perturb(scale=0.1, seed) at 40x72 for seeds 0, 1 and 2. Every trained
  leaf (by the config's ParamSpec) is held on every seed. The untrained
  leaves are held at seed 0 only, and their errors at seeds 1 and 2 are
  printed (run with -s): the two frameworks' ray directions differ by an
  ulp on many pixels (XLA's CPU rsqrt is not 1/sqrt), next to a sphere's
  limb t = -b - sqrt(disc) magnifies that without bound, and config 2's
  camera leaves, small nets of large per-pixel terms, are dominated by
  such pixels, so from some starts they leave the 1e-2 band, as jitted and
  op-by-op JAX partly do between themselves.
- adjoint vs autograd, float64: 1e-5 of scale (both are torch, same hit
  decisions; they agree to ~2e-14 in float64, now that the where chain's
  rect normals keep the scene's dtype: a float32 sign had taken the rects'
  edges 4e-8 of scale off on configs 2 and 3);
- adjoint vs autograd, float32: 1e-4 of scale. The camera leaves are small
  nets of large per-pixel terms, and the two orders of float32 summation
  differ by a few 1e-5 of that scale on config 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reversible_raytracer_tpu.models import configs as jconfigs
from reversible_raytracer_tpu.ops.pipeline import RenderConfig as JRenderConfig
from reversible_raytracer_tpu.ops.render import mse_loss, render_jnp
from reversible_raytracer_tpu_torch.bridge import scene_from_numpy
from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.models.scene import leaf_paths, tree_leaves, tree_map
from reversible_raytracer_tpu_torch.ops.kernels import fused
from reversible_raytracer_tpu_torch.ops.pipeline import RenderConfig
from reversible_raytracer_tpu_torch.ops.render import render_eager


def _cmp_trees(ref_leaves, got_leaves, paths, rel):
    for path, a, b in zip(paths, ref_leaves, got_leaves):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if not a.size:
            continue
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b, a, atol=rel * scale, rtol=0, err_msg=path)


def _jax_start(num, H, W, seed=4):
    """JAX start scene, target and config, and the port's twins of all three
    (scene values carried across through numpy)."""
    js, jspec, _ = jconfigs.CONFIGS[num]()
    jcfg = JRenderConfig(height=H, width=W, shadows=num != 1)
    jstart = jconfigs.perturb(js, jspec, scale=0.1, seed=seed)
    jtarget = jnp.asarray(np.asarray(render_jnp(js, jcfg)))
    like, _, _ = configs.CONFIGS[num](device="cpu")
    tstart = scene_from_numpy([np.asarray(x) for x in jax.tree_util.tree_leaves(jstart)],
                              like=like, device="cpu")
    ttarget = torch.from_numpy(np.array(jtarget))
    return jstart, jtarget, jcfg, tstart, ttarget, RenderConfig(height=H, width=W,
                                                                 shadows=num != 1)


def _plain_vs_jax(seed):
    """(paths, trainable flags, JAX grad leaves, port grad leaves) of config 2
    at 40x72 from perturb(seed); the losses are held here."""
    jstart, jtarget, jcfg, tstart, ttarget, tcfg = _jax_start(2, 40, 72, seed=seed)
    l_ref, g_ref = jax.value_and_grad(lambda s: mse_loss(render_jnp(s, jcfg), jtarget))(jstart)
    l_t, g_t = fused.loss_grad_fused_plain(tstart, tcfg, ttarget)
    assert abs(float(l_ref) - float(l_t)) <= 1e-4 * float(l_ref)
    spec = configs.config2_four_spheres(device="cpu")[1]
    return (leaf_paths(g_t), tree_leaves(spec.trainable), jax.tree_util.tree_leaves(g_ref),
            tree_leaves(g_t))


def test_plain_matches_jax_value_and_grad():
    paths, _, ref, got = _plain_vs_jax(0)
    _cmp_trees(ref, got, paths, 1e-2)


@pytest.mark.parametrize("seed", [1, 2])
def test_plain_matches_jax_trained_leaves(seed):
    paths, trained, ref, got = _plain_vs_jax(seed)
    assert any(trained)
    held = [(p, a, b) for p, t, a, b in zip(paths, trained, ref, got) if t]
    _cmp_trees([a for _, a, _ in held], [b for _, _, b in held], [p for p, _, _ in held], 1e-2)
    for p, t, a, b in zip(paths, trained, ref, got):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if not t and a.size:
            err = np.abs(b - a).max() / max(np.abs(a).max(), 1e-6)
            print(f"seed {seed} untrained {p}: {err:.3e} of scale")


def _adjoint_case(num, loss, dtype):
    scene, spec, _ = configs.CONFIGS[num](device="cpu")
    cfg = RenderConfig(height=20, width=36, shadows=num != 1)
    start = configs.perturb(scene, spec, scale=0.1, seed=4)
    scene, start = (tree_map(lambda x: x.to(dtype), s) for s in (scene, start))
    target = render_eager(scene, cfg)
    return start, cfg, target


@pytest.mark.parametrize("num", [1, 2, 3])
@pytest.mark.parametrize("loss", ["mse", "sum"])
@pytest.mark.parametrize("dtype, rel", [(torch.float64, 1e-5), (torch.float32, 1e-4)])
def test_adjoint_matches_autograd(num, loss, dtype, rel):
    start, cfg, target = _adjoint_case(num, loss, dtype)
    l_ref, g_ref = fused.loss_grad_fused_plain(start, cfg, target, loss)
    l_adj, g_adj = fused.loss_grad_adjoint_eager(start, cfg, target, loss)
    assert abs(float(l_ref) - float(l_adj)) <= rel * abs(float(l_ref))
    _cmp_trees([g.numpy() for g in tree_leaves(g_ref)], [g.numpy() for g in tree_leaves(g_adj)],
               leaf_paths(g_ref), rel)


def test_step_contract_on_cpu():
    start, cfg, target = _adjoint_case(2, "mse", torch.float32)
    l_a, g_a = fused.loss_grad_fused(start, cfg, target)
    l_b, g_b = fused.loss_grad_fused_plain(start, cfg, target)
    assert float(l_a) == float(l_b)
    for a, b in zip(tree_leaves(g_a), tree_leaves(g_b)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        fused.loss_grad_fused(start, cfg, target[:-1])
    with pytest.raises(ValueError):
        fused.loss_grad_fused(start, cfg, target, loss="l1")
