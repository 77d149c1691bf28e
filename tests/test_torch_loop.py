"""The port's training loops on the CPU, where each step is the eager
function that a CUDA graph captures on the card (the captured step is held
to it bit for bit in tests/test_torch_kernels.py):

- `optimize_scan`, in one chunk and in chunks of 2, bit-equal to `optimize`
  (which tests/test_torch_optim.py holds against the JAX package), and the
  iterations its ``chunk_callback`` sees;
- `optimize` saving a checkpoint mid-run, and a resume from it, bit-equal to
  one run;
- `optimize_annealed` in chunks bit-equal to one chunk per stage, with the
  global iterations its callback sees;
- the CLI's ``--target``, ``--scene`` / ``--save-scene``, ``--checkpoint-every``
  / ``--resume`` and ``--frame-every`` at 24x24.

Nothing here imports JAX.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from reversible_raytracer_tpu_torch import cli, optim
from reversible_raytracer_tpu_torch.bridge import scene_to_numpy
from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.ops.pipeline import RenderConfig
from reversible_raytracer_tpu_torch.ops.render import render
from reversible_raytracer_tpu_torch.utils.imageio import load_png, save_png, to_uint8
from reversible_raytracer_tpu_torch.utils.sceneio import load_scene


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six test
    processes at once, and torch's default of a thread per core slows this
    file and the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(size=16):
    scene, spec, _ = configs.config2_four_spheres(device="cpu")
    cfg = RenderConfig(height=size, width=size)
    target = render(scene, cfg)
    return configs.perturb(scene, spec, scale=0.1, seed=0), target, spec, cfg


def _assert_same_scene(a, b):
    for x, y in zip(scene_to_numpy(a), scene_to_numpy(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("ocfg", [optim.OptConfig(iters=5, lr=1e-2),
                                  optim.OptConfig(iters=5, lr=0.3, optimizer="sgd",
                                                  momentum=0.9, schedule="constant")],
                         ids=["adam-cosine", "sgd-momentum"])
def test_optimize_scan_matches_optimize(ocfg):
    start, target, spec, cfg = _case()
    final, _, losses = optim.optimize(start, target, spec, cfg, ocfg, log_every=0)
    whole, whole_losses = optim.optimize_scan(start, target, spec, cfg, ocfg)
    seen = []
    chunked, chunked_losses = optim.optimize_scan(
        start, target, spec, cfg, ocfg, max_chunk=2,
        chunk_callback=lambda s, it: seen.append(it))
    assert seen == [2, 4, 5]
    for got, got_losses in ((whole, whole_losses), (chunked, chunked_losses)):
        _assert_same_scene(final, got)
        np.testing.assert_array_equal(losses.numpy(), got_losses.numpy())


def test_checkpoint_resume_is_one_run(tmp_path):
    """Adam with the cosine schedule over 5 steps, a checkpoint every 2: the
    one saved after update 2 says to restart at step 3 (the JAX package's
    ``it + 1``), and the resumed run's steps 3 and 4 are the single run's."""
    start, target, spec, cfg = _case()
    ocfg = optim.OptConfig(iters=5, lr=1e-2)
    ck, mid = tmp_path / "ck.npz", tmp_path / "mid.npz"

    class Keep:  # step 3's log comes after step 2's checkpoint and before step 4's
        def log(self, **rec):
            if rec["step"] == 3:
                shutil.copy(ck, mid)

    final, hist, losses = optim.optimize(start, target, spec, cfg, ocfg, logger=Keep(),
                                         log_every=1, checkpoint_every=2,
                                         checkpoint_path=str(ck))
    assert int(np.load(ck)["__step__"]) == 5 and int(np.load(mid)["__step__"]) == 3
    resumed, rhist, rlosses = optim.optimize(start, target, spec, cfg, ocfg, log_every=1,
                                             resume=str(mid))
    assert [r["step"] for r in rhist] == [3, 4]
    np.testing.assert_array_equal(rlosses.numpy(), losses.numpy()[3:])
    assert [r["grad_norm"] for r in rhist] == [r["grad_norm"] for r in hist[3:]]
    _assert_same_scene(final, resumed)
    sgd = optim.OptConfig(iters=5, optimizer="sgd")  # its state: the schedule's count
    init, _ = optim.make_flat_update(start, spec, sgd)
    optim.save_checkpoint(str(mid), start, init(start), 0, spec, sgd)
    with pytest.raises(ValueError, match="missing optimizer-state keys"):
        optim.load_checkpoint(str(mid), start, spec, ocfg)


def test_optimize_annealed_chunks():
    """Chunks of 2 over two stages of 3 steps: the callback sees the global
    iterations, and the losses and final scene are one chunk's."""
    scene, spec, _ = configs.config5_many_spheres(12, n_spheres=9, device="cpu")
    cfg = RenderConfig(height=12, width=12, shadows=False)
    target = render(scene, cfg)
    start = configs.perturb(scene, spec, scale=0.15, seed=1)
    ocfg = optim.OptConfig(iters=3, lr=2e-3)
    seen = []
    one, one_losses = optim.optimize_annealed(start, target, spec, cfg, ocfg, taus=(0.05, 0.0),
                                              max_chunk=None)
    chunked, losses = optim.optimize_annealed(start, target, spec, cfg, ocfg, taus=(0.05, 0.0),
                                              max_chunk=2,
                                              chunk_callback=lambda s, it: seen.append(it))
    assert seen == [2, 3, 5, 6]
    np.testing.assert_array_equal(one_losses.numpy(), losses.numpy())
    _assert_same_scene(one, chunked)
    # the hard stage's "auto" optimizer is SGD at lr 0.3; None keeps ocfg (Adam)
    adam, adam_losses = optim.optimize_annealed(start, target, spec, cfg, ocfg,
                                                taus=(0.05, 0.0), hard_ocfg=None)
    np.testing.assert_array_equal(adam_losses.numpy()[:4], losses.numpy()[:4])
    assert not np.array_equal(adam_losses.numpy()[4:], losses.numpy()[4:])


def _invert(*argv):
    return cli.main(["invert", "--device", "cpu", "--config", "2", "--size", "24", "--quiet",
                     *argv])


def test_cli_target_and_scenes(tmp_path):
    """``--target`` inverts a PNG (no truth, so no parameter error);
    ``--save-scene`` writes the final scene; ``--scene`` renders from it."""
    scene, _, _ = configs.config2_four_spheres(device="cpu")
    tgt = tmp_path / "t.png"
    save_png(str(tgt), render(scene, RenderConfig(height=24, width=24)))
    saved = tmp_path / "final.json"
    out = _invert("--target", str(tgt), "--iters", "3", "--log-every", "1",
                  "--save-scene", str(saved))
    assert out["param_err"] is None and len(out["history"]) == 3
    assert all("param_err" not in r and np.isfinite(r["loss"]) for r in out["history"])
    _assert_same_scene(out["scene"], load_scene(str(saved), scene))
    png = tmp_path / "r.png"
    cli.main(["render", "--device", "cpu", "--config", "2", "--size", "24", "--scene",
              str(saved), "-o", str(png)])
    want = render(load_scene(str(saved), scene), RenderConfig(height=24, width=24))
    np.testing.assert_array_equal(load_png(str(png)), to_uint8(want).astype(np.float32) / 255.0)
    with pytest.raises(SystemExit):
        _invert("--target", str(tgt), "--size", "16", "--iters", "1")
    with pytest.raises(SystemExit):
        _invert("--target", str(tgt), "--anneal", "0.05,0", "--iters", "1")


def test_cli_checkpoint_resume_and_frames(tmp_path):
    ck, frames, metrics = tmp_path / "ck.npz", tmp_path / "frames", tmp_path / "m.jsonl"
    _invert("--iters", "4", "--checkpoint", str(ck), "--checkpoint-every", "2",
            "--frame-every", "2", "--frames-dir", str(frames))
    assert int(np.load(ck)["__step__"]) == 4
    assert sorted(p.name for p in frames.iterdir()) == ["frame_00000.png", "frame_00002.png"]
    out = _invert("--iters", "6", "--resume", str(ck), "--log-every", "1", "--metrics",
                  str(metrics))
    assert [json.loads(line)["step"] for line in metrics.read_text().splitlines()] == [4, 5]
    assert [r["step"] for r in out["history"]] == [4, 5]
    shutil.rmtree(frames)
    out = _invert("--anneal", "0.05,0", "--iters", "3", "--frame-every", "2", "--frames-dir",
                  str(frames))
    assert len(out["losses"]) == 6
    assert sorted(p.name for p in frames.iterdir()) == [
        f"frame_{i:05d}.png" for i in (2, 3, 5, 6)]
