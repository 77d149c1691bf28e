"""The port's checkpoints, scene JSON and PNG loads against the JAX
package's, both ways:

- a checkpoint that `optim.save_checkpoint` writes loads in the JAX
  package's `utils.checkpoint.load` against ``make_optimizer(ocfg).init``'s
  state, and one that the JAX package writes loads in the port, for Adam
  with the cosine schedule, Adam at a constant rate with ``lr_scales``, and
  SGD with momentum (numpy and optax's eager ``init`` only: no JAX compile);
- `sceneio.scene_to_dict` equals the JAX package's for configs 1, 2 and 5,
  and a scene goes through JSON unchanged;
- `imageio.load_png` equals the JAX package's (PIL's) on PNGs that PIL
  writes (RGB, RGBA, greyscale) and on one that uses every filter type,
  round-trips `save_png`, and refuses by name what it does not read.
"""

import struct
import zlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from reversible_raytracer_tpu import optim as joptim
from reversible_raytracer_tpu.models import configs as jconfigs
from reversible_raytracer_tpu.utils import checkpoint as jcheckpoint
from reversible_raytracer_tpu.utils import imageio as jimageio
from reversible_raytracer_tpu.utils import sceneio as jsceneio
from reversible_raytracer_tpu_torch import optim
from reversible_raytracer_tpu_torch.bridge import scene_from_numpy, scene_to_numpy
from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.models.scene import tree_leaves
from reversible_raytracer_tpu_torch.utils import imageio, sceneio


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six test
    processes at once, and torch's default of a thread per core slows this
    file and the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


OCFGS = {"adam-cosine": dict(iters=9, lr=2e-2),
         "adam-constant-lr_scales": dict(iters=9, lr=2e-2, schedule="constant",
                                         lr_scales=(("spheres.radius", 0.3),)),
         "sgd-momentum": dict(iters=9, lr=0.3, optimizer="sgd", momentum=0.9)}


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("name", list(OCFGS))
def test_port_checkpoint_loads_in_jax(tmp_path, name):
    js, _, _ = jconfigs.config2_four_spheres()
    ts, tspec, _ = configs.config2_four_spheres(device="cpu")
    ocfg = optim.OptConfig(**OCFGS[name])
    init, apply = optim.make_flat_update(ts, tspec, ocfg)
    scene, state = ts, init(ts)
    rng = np.random.default_rng(0)
    for _ in range(2):
        grads = scene_from_numpy([rng.normal(0.0, 1e-2, size=tuple(l.shape)) for l in
                                  tree_leaves(ts)], like=ts, device="cpu")
        scene, state, _ = apply(scene, state, grads)
    path = str(tmp_path / "port.npz")
    optim.save_checkpoint(path, scene, state, 2, tspec, ocfg)
    like = joptim.make_optimizer(joptim.OptConfig(**OCFGS[name])).init(js)
    jscene, jstate, step = jcheckpoint.load(path, js, like)
    assert step == 2
    for a, b in zip(_np_leaves(jscene), scene_to_numpy(scene)):
        np.testing.assert_array_equal(a, b)
    want = optim.opt_state_leaves(state, scene, tspec, ocfg)
    got = _np_leaves(jstate)
    assert len(got) == len(want) == len(_np_leaves(like))
    for a, b, l in zip(got, want, _np_leaves(like)):
        assert a.dtype == l.dtype and a.shape == l.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(OCFGS))
def test_jax_checkpoint_loads_in_port(tmp_path, name):
    js, jspec, _ = jconfigs.config2_four_spheres()
    ts, tspec, _ = configs.config2_four_spheres(device="cpu")
    like = joptim.make_optimizer(joptim.OptConfig(**OCFGS[name])).init(js)
    rng = np.random.default_rng(1)
    leaves, treedef = jax.tree_util.tree_flatten(like)
    trained = [bool(t) for t in jax.tree_util.tree_leaves(jspec.trainable)]
    moments = iter(trained * 2)
    state_leaves = []
    for leaf in leaves:  # counts of 7, and moments that are 0 on untrained leaves
        if np.asarray(leaf).dtype == np.int32:
            state_leaves.append(np.asarray(7, np.int32))
        else:
            draw = rng.normal(0.0, 1e-2, size=np.shape(leaf)).astype(np.float32)
            state_leaves.append(draw if next(moments) else np.zeros_like(draw))
    moved = [np.asarray(l) + np.float32(0.01) for l in _np_leaves(js)]
    jscene = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(js), moved)
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save(path, jscene, jax.tree_util.tree_unflatten(treedef, state_leaves), 7)
    ocfg = optim.OptConfig(**OCFGS[name])
    scene, state, step = optim.load_checkpoint(path, ts, tspec, ocfg)
    assert step == 7 and int(state["count"]) == 7 and state["count"].dtype == torch.int32
    for a, b in zip(moved, scene_to_numpy(scene)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(state_leaves, optim.opt_state_leaves(state, scene, tspec, ocfg)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num", [1, 2, 5])
def test_scene_dict_matches_jax(tmp_path, num):
    js, _, _ = jconfigs.CONFIGS[num]()
    ts, _, _ = configs.CONFIGS[num](device="cpu")
    want = jsceneio.scene_to_dict(js)
    got = sceneio.scene_to_dict(ts)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key], np.float32),
                                      np.asarray(want[key], np.float32))
    path = str(tmp_path / "s.json")
    jsceneio.save_scene(path, js)
    back = sceneio.load_scene(path, ts)
    for a, b in zip(_np_leaves(js), scene_to_numpy(back)):
        np.testing.assert_array_equal(a, b)
    partial = {k: v for k, v in got.items() if k != "camera.eye"}
    partial["spheres.radius"] = (np.asarray(got["spheres.radius"]) * 2).tolist()
    moved = sceneio.scene_from_dict(partial, ts)
    assert torch.equal(moved.camera.eye, ts.camera.eye)
    assert torch.equal(moved.spheres.radius, ts.spheres.radius * 2)


def _write_png(path, rows, filters):
    """An 8-bit RGB PNG whose row y is filtered with filter type
    ``filters[y]`` (0 none, 1 sub, 2 up, 3 average, 4 Paeth)."""
    h, w, _ = rows.shape
    bpp, prev, raw = 3, np.zeros(w * 3, np.int32), b""
    for y in range(h):
        cur = rows[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        pred = [0, left, prev, (left + prev) >> 1, paeth][filters[y]]
        raw += bytes([filters[y]]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_load_png_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(13, 11, 3)).astype(np.uint8)
    img[6:] = (np.arange(11)[None, :, None] * 23 + np.arange(7)[:, None, None] * 9) % 256
    for mode in ("RGB", "RGBA", "L"):
        path = str(tmp_path / f"{mode}.png")
        Image.fromarray(img).convert(mode).save(path)
        got = imageio.load_png(path)
        assert got.dtype == np.float32 and got.shape == (13, 11, 3)
        np.testing.assert_array_equal(got, jimageio.load_png(path))
    path = str(tmp_path / "filters.png")
    _write_png(path, img[:10], [0, 1, 2, 3, 4, 3, 4, 1, 2, 0])
    np.testing.assert_array_equal(imageio.load_png(path), jimageio.load_png(path))
    np.testing.assert_array_equal(imageio.load_png(path), img[:10] / np.float32(255.0))
    x = rng.uniform(-0.1, 1.1, size=(5, 4, 3)).astype(np.float32)
    imageio.save_png(str(tmp_path / "x.png"), x)
    np.testing.assert_array_equal(imageio.load_png(str(tmp_path / "x.png")),
                                  imageio.to_uint8(x) / np.float32(255.0))


def test_load_png_refuses_by_name(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    Image.fromarray(img).convert("P").save(tmp_path / "p.png")
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(tmp_path / "d16.png")
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1)  # PIL writes no interlaced PNG
    (tmp_path / "i.png").write_bytes(
        b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + b"IHDR" + ihdr
        + struct.pack(">I", zlib.crc32(b"IHDR" + ihdr) & 0xFFFFFFFF))
    for name, why in (("p.png", "palette"), ("d16.png", "16-bit"), ("i.png", "interlaced")):
        with pytest.raises(ValueError, match=why):
            imageio.load_png(str(tmp_path / name))
