"""Two processes over gloo on the CPU: `parallel.worker` as ranks 0 and 1
of a localhost group (a free port, a timeout on each process), config 2 at
32^2, 3 sharded steps. The gathered image is the single-process render to
the bit; the two ranks end on bit-identical scenes; rank 0's stepped scene
is the single-process 2-band step's (`make_sharded_step` on
`make_ray_mesh(2)`, no process group) within 1e-6 of each leaf's scale.
Then the worker's batched step (two scenes, one a rank): its losses
and its grad norm, the whole batch's, are the single-process batched
step's of both scenes within 1e-6 relative. Imports no JAX itself."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.models.scene import tree_leaves
from reversible_raytracer_tpu_torch.ops.render import render
from reversible_raytracer_tpu_torch.optim import OptConfig
from reversible_raytracer_tpu_torch.parallel import (
    make_batched_step,
    make_ray_mesh,
    make_scene_ray_mesh,
    make_sharded_step,
    stack_scenes,
)

ROOT = Path(__file__).resolve().parent.parent
SIZE, ITERS = 32, 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six test
    processes at once, and torch's default of a thread per core slows this
    file and the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_match_one_process(tmp_path):
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    cmd = [sys.executable, "-m", "reversible_raytracer_tpu_torch.parallel.worker",
           f"127.0.0.1:{port}", "2"]
    tail = [str(tmp_path), "--device", "cpu", "--config", "2", "--size", str(SIZE),
            "--iters", str(ITERS)]
    procs = [subprocess.Popen([*cmd, str(pid), *tail], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in (0, 1)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), outs
    got = np.load(tmp_path / "worker.npz")
    assert int(got["world"]) == 2 and bool(got["scenes_equal"])

    scene, spec, cfg = configs.config2_four_spheres(SIZE, device="cpu")
    image = render(scene, cfg).detach()
    np.testing.assert_array_equal(got["image"], image.numpy())

    step, init = make_sharded_step(make_ray_mesh(2), cfg, spec, OptConfig(iters=ITERS, lr=1e-2))
    s, state, rows = init(configs.perturb(scene, spec, scale=0.05, seed=0), image)
    for _ in range(ITERS):
        s, state, _, _ = step(s, state, rows)
    off = 0
    for leaf in tree_leaves(s):
        n = leaf.numel()
        want = leaf.reshape(-1).numpy()
        if n:
            scale = max(float(np.abs(want).max()), 1e-30)
            assert float(np.abs(got["final_flat"][0, off:off + n] - want).max()) <= 1e-6 * scale
        off += n
    assert off == got["final_flat"].shape[1]
    assert got["losses"][-1] < got["losses"][0]

    # the batched step: the whole batch's grad norm over the two ranks
    ocfg = OptConfig(iters=ITERS, lr=1e-2)
    bstep, binit = make_batched_step(make_scene_ray_mesh(2, 1), cfg, spec, ocfg)
    starts = [configs.perturb(scene, spec, scale=0.05, seed=s) for s in (0, 1)]
    bs, bstate, brows = binit(stack_scenes(starts), torch.stack([image, image]))
    _, _, blosses, bnorm = bstep(bs, bstate, brows)
    np.testing.assert_allclose(got["batched_losses"], blosses.numpy(), rtol=1e-6)
    assert abs(float(got["batched_grad_norm"]) - float(bnorm)) <= 1e-6 * float(bnorm)
