"""The port's CPU training step against the TPU step kernel itself
(`loss_grad_pallas`, run in interpret mode as tests/test_fused_step.py runs
it): loss within 1e-4 relative, every gradient leaf within 1e-2 of the
leaf's scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reversible_raytracer_tpu.models import configs as jconfigs
from reversible_raytracer_tpu.ops.kernels.fused import loss_grad_pallas
from reversible_raytracer_tpu.ops.pipeline import RenderConfig as JRenderConfig
from reversible_raytracer_tpu_torch.bridge import scene_from_numpy
from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.models.scene import leaf_paths, tree_leaves
from reversible_raytracer_tpu_torch.ops.kernels import fused
from reversible_raytracer_tpu_torch.ops.pipeline import RenderConfig
from reversible_raytracer_tpu_torch.ops.render import render_eager


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six test
    processes at once, and torch's default of a thread per core slows this
    file and the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_plain_matches_pallas_step_interpret():
    js, jspec, _ = jconfigs.config2_four_spheres()
    jcfg = JRenderConfig(height=24, width=40, shadows=True)
    jstart = jconfigs.perturb(js, jspec, scale=0.1, seed=4)
    like, _, _ = configs.config2_four_spheres(device="cpu")
    tcfg = RenderConfig(height=24, width=40, shadows=True)
    # Both sides take the same target; the port renders it (the JAX
    # package's render of it is held to the port's in test_torch_render.py).
    target = render_eager(like, tcfg)
    l_ref, g_ref = loss_grad_pallas(jstart, jcfg, jnp.asarray(target.numpy()), loss="mse",
                                    interpret=True)

    tstart = scene_from_numpy([np.asarray(x) for x in jax.tree_util.tree_leaves(jstart)],
                              like=like, device="cpu")
    l_t, g_t = fused.loss_grad_fused(tstart, tcfg, target)

    assert abs(float(l_ref) - float(l_t)) <= 1e-4 * float(l_ref)
    for path, a, b in zip(leaf_paths(g_t), jax.tree_util.tree_leaves(g_ref), tree_leaves(g_t)):
        a = np.asarray(a, np.float64)
        if a.size:
            scale = max(np.abs(a).max(), 1e-6)
            np.testing.assert_allclose(b.numpy(), a, atol=1e-2 * scale, rtol=0, err_msg=path)
