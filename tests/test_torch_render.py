"""Port renderer against the JAX package: `render_eager` / `render_tile` vs
`render_jnp` / `render_tile` on configs 1-3, by the oracle rule of
tests/test_render_vs_oracle.py, and the dispatch. The forward kernel is
held to its plain version on a card in tests/test_torch_kernels.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from reversible_raytracer_tpu.models import configs as jconfigs
from reversible_raytracer_tpu.ops import pipeline as jpipe
from reversible_raytracer_tpu.ops.render import render_jnp
from reversible_raytracer_tpu_torch.bridge import scene_from_numpy
from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.ops import pipeline as tpipe
from reversible_raytracer_tpu_torch.ops.kernels import fused
from reversible_raytracer_tpu_torch.ops.render import render, render_eager, resolve_impl


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six test
    processes at once, and torch's default of a thread per core slows this
    file and the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _oracle_rule(img, ref, atol=2e-3):
    err = np.abs(np.asarray(img) - np.asarray(ref))
    frac_bad = float((err > atol).mean())
    assert frac_bad < 1e-3, f"{frac_bad:.2%} of pixel-channels differ by more than {atol}"
    assert float(err.mean()) < 1e-4


def _pair(num, **cfg_kw):
    """The JAX scene and the port scene bridged from its leaves, and both
    RenderConfigs."""
    js, _, jcfg = jconfigs.CONFIGS[num]()
    like, _, _ = configs.CONFIGS[num](device="cpu")
    ts = scene_from_numpy([np.asarray(x) for x in jax.tree_util.tree_leaves(js)],
                          like=like, device="cpu")
    jcfg = dataclasses.replace(jcfg, **cfg_kw)
    tcfg = tpipe.RenderConfig(**dataclasses.asdict(jcfg))
    return js, jcfg, ts, tcfg


def _hit(ts, tcfg):
    o, d = tpipe.primary_rays(ts, tcfg)
    return tpipe.trace_nearest(ts, o, d, tcfg.shape)[1].numpy()


@pytest.mark.parametrize("num", [1, 2, 3])
@pytest.mark.parametrize("shader", ["phong", "depth", "normal"])
def test_render_eager_matches_jnp(num, shader):
    js, jcfg, ts, tcfg = _pair(num, height=24, width=32, shader=shader)
    _oracle_rule(render_eager(ts, tcfg).numpy(), render_jnp(js, jcfg))


@pytest.mark.parametrize("num", [1, 2, 3])
def test_visibility_planes_match_render_tile(num):
    js, jcfg, ts, tcfg = _pair(num, height=24, width=32)
    (_, _, _), jvis = jpipe.render_tile(js, jcfg, 0, 0, 24, 32, return_vis=True)
    (_, _, _), tvis = tpipe.render_tile(ts, tcfg, 0, 0, 24, 32, return_vis=True)
    assert len(tvis) == len(jvis) == ts.lights.count
    # On a miss the plane is the shadow test of a ray from the BIG sentinel:
    # float noise in either implementation, and no gradient reads it. Hit
    # pixels must agree.
    hit = _hit(ts, tcfg)
    for a, b in zip(jvis, tvis):
        diff = np.asarray(a)[hit] != b.numpy()[hit]
        assert diff.mean() < 1e-3
    img, planes = fused.render_fused_plain(ts, tcfg)
    assert planes.shape == (tpipe.n_vis_planes(ts, tcfg), 24, 32)
    assert img.shape == (24, 32, 3)


@pytest.mark.parametrize("kw", [dict(spp=4), dict(projection="orthographic"),
                                dict(clip=False, shadows=False)])
def test_render_variants_match_jnp(kw):
    js, jcfg, ts, tcfg = _pair(2, height=20, width=28, **kw)
    _oracle_rule(render_eager(ts, tcfg).numpy(), render_jnp(js, jcfg))


def test_cpu_dispatch_is_eager():
    ts, _, cfg = configs.config2_four_spheres(16, device="cpu")
    assert resolve_impl(ts, cfg) == "eager"
    torch.testing.assert_close(render(ts, cfg), render_eager(ts, cfg), rtol=0, atol=0)
    img, vis = fused.render_fused(ts, cfg)
    torch.testing.assert_close(img, render_eager(ts, cfg), rtol=0, atol=0)
    assert vis.shape == (1, 16, 16)


@pytest.mark.parametrize("kw, why", [
    (dict(spp=2), "spp"), (dict(reflections=4), "reflections"),
    (dict(shader="depth"), "depth"), (dict(projection="orthographic"), "orthographic"),
    (dict(soft_tau=0.1), "soft_tau"),
])
def test_kernels_refuse_uncovered_configs(kw, why):
    """spp 4 is covered since the kernels take the 2x2 loop; any other spp
    is refused by name. One to three bounce levels are covered; four are
    refused by name."""
    ts, _, cfg = configs.config2_four_spheres(16, device="cpu")
    fused.check_kernel_config(ts, dataclasses.replace(cfg, spp=4))
    for refl in (2, 3):
        fused.check_kernel_config(ts, dataclasses.replace(cfg, spp=4, reflections=refl))
    with pytest.raises(NotImplementedError, match=why):
        fused.check_kernel_config(ts, dataclasses.replace(cfg, **kw))


def test_unported_features_raise():
    """Reflections under soft visibility (hard semantics only, as in the JAX
    package) raise, in the where chain and in the soft shader, which renders
    environment maps without a bounce."""
    from reversible_raytracer_tpu_torch.ops.pipeline_vec import render_eager_vec

    ts, _, cfg = configs.config2_four_spheres(16, device="cpu")
    with pytest.raises(NotImplementedError):
        render_eager(ts, dataclasses.replace(cfg, reflections=1, soft_tau=0.1))
    env = dataclasses.replace(ts, env=torch.ones((4, 4, 3)))
    assert torch.isfinite(render_eager_vec(env, dataclasses.replace(cfg, soft_tau=0.1))).all()
    with pytest.raises(NotImplementedError, match="mirror reflections"):
        render_eager_vec(env, dataclasses.replace(cfg, soft_tau=0.1, reflections=1))
