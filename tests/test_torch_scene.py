"""Port scene model against the JAX package: leaf order, values, the numpy
bridge, perturb and the flat kernel layout."""

import jax
import numpy as np
import pytest
import torch

from reversible_raytracer_tpu.models import configs as jconfigs
from reversible_raytracer_tpu.models.scene import leaf_paths as jleaf_paths
from reversible_raytracer_tpu.ops.kernels.fused import flatten_scene as jflatten
from reversible_raytracer_tpu.ops.kernels.fused import scene_layout as jlayout
from reversible_raytracer_tpu_torch.bridge import scene_from_numpy, scene_to_numpy
from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.models.scene import (
    leaf_paths,
    path_matches,
    tree_leaves,
)
from reversible_raytracer_tpu_torch.ops.kernels.fused import (
    flat_offsets,
    flatten_scene,
    scene_layout,
    unflatten_scene,
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


CONFIGS = [1, 2, 3, 5]


def _jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("num", CONFIGS)
def test_leaves_bit_equal_in_treedef_order(num):
    js, _, jcfg = jconfigs.CONFIGS[num]()
    ts, _, tcfg = configs.CONFIGS[num](device="cpu")
    assert leaf_paths(ts) == jleaf_paths(js)
    for a, b in zip(_jax_leaves(js), scene_to_numpy(ts)):
        assert a.shape == b.shape
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert (tcfg.height, tcfg.width, tcfg.shadows) == (jcfg.height, jcfg.width, jcfg.shadows)


@pytest.mark.parametrize("num", CONFIGS)
def test_bridge_round_trip(num):
    js, _, _ = jconfigs.CONFIGS[num]()
    like, _, _ = configs.CONFIGS[num](device="cpu")
    # Move the scene off its builder values so the bridge has work to do.
    leaves = [a + np.float32(0.25) for a in _jax_leaves(js)]
    ts = scene_from_numpy(leaves, like=like, device="cpu")
    for a, b in zip(leaves, scene_to_numpy(ts)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        scene_from_numpy(leaves[:-1], like=like, device="cpu")


@pytest.mark.parametrize("num", CONFIGS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_perturb_bit_equal(num, seed):
    js, jspec, _ = jconfigs.CONFIGS[num]()
    ts, tspec, _ = configs.CONFIGS[num](device="cpu")
    jstart = jconfigs.perturb(js, jspec, scale=0.1, seed=seed)
    tstart = configs.perturb(ts, tspec, scale=0.1, seed=seed)
    for a, b in zip(_jax_leaves(jstart), scene_to_numpy(tstart)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num", CONFIGS)
def test_spec_matches(num):
    _, jspec, _ = jconfigs.CONFIGS[num]()
    ts, tspec, _ = configs.CONFIGS[num](device="cpu")
    assert [bool(x) for x in jax.tree_util.tree_leaves(jspec.trainable)] == \
        tree_leaves(tspec.trainable)
    for tree_j, tree_t in ((jspec.lower, tspec.lower), (jspec.upper, tspec.upper)):
        np.testing.assert_array_equal(
            np.array([float(x) for x in jax.tree_util.tree_leaves(tree_j)], np.float32),
            np.array(tree_leaves(tree_t), np.float32))


def test_path_matches_is_segment_aware():
    assert path_matches("spheres.material.color", "spheres.material.color")
    assert path_matches("spheres.material.color", "color")
    assert not path_matches("spheres.material.color2", "spheres.material.color")
    assert path_matches("spheres.center", "spheres")


@pytest.mark.parametrize("num", CONFIGS)
def test_flat_layout(num):
    js, _, _ = jconfigs.CONFIGS[num]()
    ts, _, _ = configs.CONFIGS[num](device="cpu")
    _, jmeta, jS = jlayout(js)
    meta, S = scene_layout(ts)
    assert S == jS and meta == jmeta
    flat = flatten_scene(ts)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflatten(js)))
    off = flat_offsets(ts.spheres.count, ts.rects.count, ts.lights.count)
    assert off["S"] == S
    starts = dict(zip(leaf_paths(ts), (m[0] for m in meta)))
    for key, path in (("s_center", "spheres.center"), ("s_shin", "spheres.material.shininess"),
                      ("r_origin", "rects.origin"), ("r_shin", "rects.material.shininess"),
                      ("l_pos", "lights.position"), ("l_col", "lights.color"),
                      ("c_eye", "camera.eye"), ("c_fov", "camera.fov_deg"),
                      ("ambient", "ambient"), ("background", "background")):
        assert off[key] == starts[path], key
    back = unflatten_scene(ts, flat * 2.0)
    for a, b in zip(tree_leaves(ts), tree_leaves(back)):
        torch.testing.assert_close(a * 2.0, b, rtol=0, atol=0)


def test_config2_has_112_scalars():
    ts, _, _ = configs.config2_four_spheres(device="cpu")
    assert scene_layout(ts)[1] == 112
    assert len(tree_leaves(ts)) == 34
