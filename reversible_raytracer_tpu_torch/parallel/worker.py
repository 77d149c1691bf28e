"""One rank of a multi-process sharded run (the counterpart of the JAX
package's scripts/distributed_worker.py):

    python -m reversible_raytracer_tpu_torch.parallel.worker COORDINATOR N PID OUTDIR \\
        [--device cuda|cpu] [--backend nccl|gloo] [--config 5] [--size 1024] [--iters 20]

Start N of them, PID 0..N-1, with the same ``host:port`` COORDINATOR (any
free port on localhost for ranks of one host). Each brings up the process
group (`distributed.initialize`), renders its bands of the config's true
scene (`shard.render_sharded`) and gathers the image
(`distributed.gather_image`), then takes ``--iters`` sharded steps
(`shard.make_sharded_step`, one band a rank) from the perturbed scene
(scale 0.05, seed 0) against that image. Rank 0 writes OUTDIR/worker.npz:
the gathered image, the per-step losses, every rank's final scene as one
flat float32 row (``final_flat``, rank-major), whether those rows are
bit-identical (``scenes_equal``), the world size and the wall seconds of
the steps (``wall_s``, captures included). It then takes one step of a
batch of B = max(2, N) inversions over the ranks (`shard.make_batched_step`
on `shard.make_scene_ray_mesh(B, 1)`: a scene a rank, both on one rank)
from the scene perturbed with seeds 0 .. B - 1 (scale 0.05) against the
same image, and rank 0 also writes their losses (``batched_losses``, in
scene order) and the step's grad norm, that of the whole batch
(``batched_grad_norm``). Every rank prints one JSON line (with each
kernel's launches in this process, the batched step's included).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="reversible_raytracer_tpu_torch.parallel.worker")
    ap.add_argument("coordinator")
    ap.add_argument("num_processes", type=int)
    ap.add_argument("process_id", type=int)
    ap.add_argument("outdir")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=[None, "nccl", "gloo"])
    ap.add_argument("--config", type=int, default=5)
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from ..graphs import graph_kernels
    from ..models import configs
    from ..models.scene import tree_leaves
    from ..optim import OptConfig
    from . import distributed, shard

    dev = distributed.initialize(args.coordinator, args.num_processes, args.process_id,
                                 backend=args.backend, device=args.device)
    try:
        kw = {"device": dev} if args.size is None else {"device": dev, "size": args.size}
        scene, spec, cfg = configs.CONFIGS[args.config](**kw)
        mesh = shard.make_ray_mesh()
        with torch.no_grad():
            image = distributed.gather_image(shard.render_sharded(scene, cfg, mesh))
        target = torch.from_numpy(image).to(dev)
        start = configs.perturb(scene, spec, scale=0.05, seed=0)
        ocfg = OptConfig(iters=args.iters, lr=1e-2)
        step, init = shard.make_sharded_step(mesh, cfg, spec, ocfg)
        t0 = time.perf_counter()
        s, state, rows = init(start, target)
        losses = torch.empty((args.iters,), device=dev)
        for it in range(args.iters):
            s, state, loss, _ = step(s, state, rows)
            losses[it] = loss
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        flat = torch.cat([l.detach().reshape(-1).to(torch.float32) for l in tree_leaves(s)])
        finals = distributed.all_gather_rows(flat[None])
        equal = bool(all(np.array_equal(finals[0].view(np.uint32), f.view(np.uint32))
                         for f in finals))
        la = losses.cpu().numpy()
        batch = max(2, args.num_processes)
        starts = [configs.perturb(scene, spec, scale=0.05, seed=s) for s in range(batch)]
        bstep, binit = shard.make_batched_step(shard.make_scene_ray_mesh(batch, 1), cfg, spec,
                                               ocfg)
        bs, bstate, brows = binit(shard.stack_scenes(starts), torch.stack([target] * batch))
        _, _, blosses, bnorm = bstep(bs, bstate, brows)
        blosses = distributed.all_gather_rows(blosses[None]).reshape(-1)
        if distributed.is_primary():
            os.makedirs(args.outdir, exist_ok=True)
            np.savez(os.path.join(args.outdir, "worker.npz"), image=image, losses=la,
                     final_flat=finals, scenes_equal=equal, world=mesh.ranks, wall_s=wall,
                     batched_losses=blosses, batched_grad_norm=float(bnorm))
        print(json.dumps({"rank": distributed.rank(), "world": mesh.ranks,
                          "backend": dist.get_backend(), "device": str(dev),
                          "loss0": float(la[0]), "loss": float(la[-1]), "wall_s": wall,
                          "scenes_equal": equal,
                          "launches": {k.name: k.launches for k in graph_kernels()}}),
              flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
