"""Command-line interface: ``render`` and ``invert`` for configs 1-10.

Examples:
    python -m reversible_raytracer_tpu_torch.cli render --config 2 --size 512 -o out.png
    python -m reversible_raytracer_tpu_torch.cli invert --config 2 --size 512 --iters 200
    python -m reversible_raytracer_tpu_torch.cli invert --config 5 --anneal 0.08,0.03,0.01,0 \
        --anneal-size 512 --lr 2e-3 --iters 300 --perturb 0.03
    python -m reversible_raytracer_tpu_torch.cli invert --config 4 --anneal 0.08,0.03,0 \
        --checker-ratio 12.5 --lr 5e-3 --iters 100 --perturb 0.05
    python -m reversible_raytracer_tpu_torch.cli invert --config 5 --size 1024 --spp 4 \
        --anneal 0.08,0.03,0.01,0 --anneal-size 512
    python -m reversible_raytracer_tpu_torch.cli invert --config 6 --perturb 0.3 --lr 2e-2 \
        --iters 150 --seed 3
    python -m reversible_raytracer_tpu_torch.cli invert --config 7 --lr 3e-2 --perturb 0.4 \
        --iters 200
    python -m reversible_raytracer_tpu_torch.cli invert --config 8 --anneal 0.08,0.03,0.01,0 \
        --lr 3e-2 --perturb 0.4 --iters 50
    python -m reversible_raytracer_tpu_torch.cli invert --config 10 --perturb 0.2 --lr 2e-2 \
        --iters 300 --seed 10
    python -m reversible_raytracer_tpu_torch.cli invert --config 2 --size 512 --iters 150 \
        --perturb 0.45 --seed 2 --anneal 0.08,0.03,0 --restarts 12 --restart-jitter 0.3 \
        --restart-proposal resid --restart-chain

Both run on the GPU (``--device cuda``, the default) through the CUDA
kernels, each training step one replay of a CUDA graph; ``--device cpu``
runs the eager torch twin instead. ``invert`` takes the JAX package's
observability flags: ``--target`` (a PNG to invert instead of the truth's
render), ``--scene`` / ``--save-scene`` (JSON scenes), ``--checkpoint``,
``--checkpoint-every`` and ``--resume``, ``--frame-every`` /
``--frames-dir`` and ``--quiet``. Both take ``--spp 4`` (2x2
supersampling, on every kernel family) and ``--reflections N`` (mirror
bounces, overriding the config's count: configs 6, 9 and 10 render with
1, and ``--reflections 0`` renders them with none; ``--reflections 1`` on
config 5 takes the object-chunked kernels' bounce instances). Configs 7, 8
and 9 carry texel grids (a textured floor, a textured globe, a sky
environment map); their recipe is the JAX package's examples/run_config.py,
``--lr 3e-2 --perturb 0.4 --iters 200``. ``--reflections 1`` on config 7 or
8 (object textures with a bounce) takes the object-chunked kernels'
textured instances, as the JAX package's dispatch does. Config 10 (64 chrome spheres under
config 9's sky, one bounce) recovers the spheres' mirror coefficients and
the sky's texels together through the object-chunked kernels; its recipe is
the JAX package's scripts/config10_check.py, ``--perturb 0.2 --lr 2e-2
--iters 300 --seed 10`` (cosine, the default schedule). ``--anneal`` runs on
configs 7 and 8 as they are and on configs 9 and 10 with ``--reflections
0`` (their soft stages take the soft kernels' texel instances; a bounce
under a soft stage is refused by name, as in the JAX package). ``--restarts N``
runs the whole anneal from N starts (`optim.optimize_multistart`: restart 0
from the perturbed start, the others from ``--restart-proposal``'s family
at ``--restart-jitter``, each from the best scene so far with
``--restart-chain``) and keeps the best final hard loss; the last example
is the JAX package's recipe for config 2's documented topology stall.
``--sharded`` runs the inversion over row bands of the image, one band a
rank of a ``torch.distributed`` group (`parallel.optimize_sharded_scan`:
each rank's band step, one all-reduce of the loss and gradient a step, the
same update on every rank; a CUDA graph under NCCL). Alone it is a group of
one rank; ``--coordinator host:port --num-processes N --process-id I``
makes rank I of N (one process per card, each started with its own id).
NCCL on CUDA, gloo with ``--device cpu``. Only rank 0 writes the image, the
scene and the metrics.
"""

from __future__ import annotations

import argparse
import sys
import time


def _add_common(p):
    p.add_argument("--config", type=int, default=2, choices=list(range(1, 11)),
                   help="benchmark config (1: one sphere, 2: four spheres + ground, "
                        "3: two lights, 4: checker materials + camera pose, "
                        "5: 64 spheres + ground, 6: mirror reflections, 7: textured floor, "
                        "8: textured globe, 9: sky environment map + mirror sphere, "
                        "10: 64 chrome spheres under a sky)")
    p.add_argument("--size", type=int, default=None,
                   help="image size (default: the config's native size)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the eager twin)")
    p.add_argument("--scene", type=str, default=None,
                   help="JSON scene file overriding the config's parameters")
    p.add_argument("--spp", type=int, default=1, choices=[1, 4],
                   help="samples per pixel (4 = 2x2 supersampling AA)")
    p.add_argument("--reflections", type=int, default=None,
                   help="mirror bounces (each object's `mirror` coefficient sets its "
                        "reflectivity; 0 = none). Default: the config's own (configs 6, 9, "
                        "10: 1)")


def _build(args):
    from .models import configs as cfgs

    builder = cfgs.CONFIGS[args.config]
    kw = {"device": args.device}
    if args.size:
        kw["size"] = args.size
    scene, spec, cfg = builder(**kw)
    if args.scene:
        from .utils.sceneio import load_scene

        scene = load_scene(args.scene, scene)
    if args.spp != 1:
        import dataclasses

        cfg = dataclasses.replace(cfg, spp=args.spp)
    if args.reflections is not None:
        import dataclasses

        cfg = dataclasses.replace(cfg, reflections=args.reflections)
    return scene, spec, cfg


def cmd_render(args):
    from .ops.render import render, resolve_impl
    from .utils.imageio import save_png

    scene, _, cfg = _build(args)
    t0 = time.perf_counter()
    img = render(scene, cfg).cpu()
    print(f"[{resolve_impl(scene, cfg)}] rendered {cfg.height}x{cfg.width} in "
          f"{time.perf_counter() - t0:.3f}s", file=sys.stderr)
    save_png(args.output, img)
    print(args.output)
    return {"output": args.output}


def _target(args, cfg):
    """The ``--target`` PNG as an (H, W, 3) float32 tensor on the device."""
    import torch

    from .models.scene import resolve_device
    from .utils.imageio import load_png

    img = load_png(args.target)
    if img.shape[:2] != (cfg.height, cfg.width):
        sys.exit(f"error: --target is {img.shape[1]}x{img.shape[0]}, the render "
                 f"{cfg.width}x{cfg.height} (pass --size)")
    return torch.from_numpy(img).to(resolve_device(args.device))


def cmd_invert(args):
    from .models.configs import perturb
    from .ops.render import loss_and_grad_fn, render
    from .optim import OptConfig, optimize, param_error
    from .utils.metrics import MetricsLogger

    if args.sharded or args.coordinator or (args.num_processes or 0) > 1:
        from .parallel import initialize

        initialize(args.coordinator, args.num_processes, args.process_id, device=args.device)
    scene, spec, cfg = _build(args)
    if args.target:
        target, truth = _target(args, cfg), None
    else:
        target, truth = render(scene, cfg).detach(), scene
    start = perturb(scene, spec, scale=args.perturb, seed=args.seed)
    ocfg = OptConfig(iters=args.iters, lr=args.lr, loss=args.loss, schedule=args.schedule)
    if args.anneal:
        if truth is None:
            sys.exit("error: --anneal needs the ground-truth scene (no --target)")
        return _invert_annealed(args, scene, spec, cfg, target, start, ocfg)
    if args.sharded:
        return _invert_sharded(args, scene, spec, cfg, target, start, ocfg, truth)
    logger = MetricsLogger(jsonl_path=args.metrics, echo=not args.quiet)
    try:
        vag = loss_and_grad_fn(scene, cfg, loss=args.loss)
        t0 = time.perf_counter()
        final, history, losses = optimize(
            start, target, spec, cfg, ocfg, vag_fn=vag, logger=logger,
            log_every=args.log_every, truth=truth, frame_every=args.frame_every,
            frame_dir=args.frames_dir, checkpoint_every=args.checkpoint_every,
            checkpoint_path=args.checkpoint, resume=args.resume)
        err = float(param_error(final, truth, spec)) if truth is not None else None
        dt = time.perf_counter() - t0
        losses = losses.cpu().tolist()
    finally:
        logger.close()
    if err is not None:
        print(f"final param RMS error vs truth: {err:.5f}", file=sys.stderr)
    final_loss = f"{history[-1]['loss']:.3e}" if history else "n/a (--log-every 0)"
    print(f"optimized {args.iters} iters in {dt:.1f}s (final loss {final_loss})",
          file=sys.stderr)
    _save_outputs(args, final, cfg)
    return {"history": history, "losses": losses, "param_err": err, "seconds": dt,
            "output": args.output, "scene": final}


def _invert_sharded(args, scene, spec, cfg, target, start, ocfg, truth):
    """``invert --sharded``: the inversion over row bands, one a rank
    (`parallel.optimize_sharded_scan`), the per-step losses back in one
    transfer at the end; ``wall_s`` on the host clock, captures included.
    Only the primary rank logs and writes."""
    from .optim import param_error
    from .parallel import is_primary, make_ray_mesh, optimize_sharded_scan
    from .utils.metrics import MetricsLogger

    primary = is_primary()
    mesh = make_ray_mesh()
    logger = MetricsLogger(jsonl_path=args.metrics if primary else None,
                           echo=primary and not args.quiet)
    try:
        t0 = time.perf_counter()
        final, losses = optimize_sharded_scan(start, target, mesh, cfg, spec, ocfg)
        la = losses.cpu().tolist()
        dt = time.perf_counter() - t0
        logger.log(step=args.iters, loss=la[-1], wall_s=round(dt, 3), mesh=str(mesh.shape),
                   ranks=mesh.ranks)
    finally:
        logger.close()
    err = float(param_error(final, truth, spec)) if truth is not None else None
    if primary:
        if err is not None:
            print(f"final param RMS error vs truth: {err:.5f}", file=sys.stderr)
        print(f"optimized {args.iters} iters over {mesh.ranks} ranks ({mesh.shape}) in "
              f"{dt:.1f}s (final loss {la[-1]:.3e})", file=sys.stderr)
        _save_outputs(args, final, cfg)
    return {"history": [{"loss": la[-1]}], "losses": la, "param_err": err, "seconds": dt,
            "output": args.output, "scene": final, "mesh": mesh.shape, "ranks": mesh.ranks}


def _save_outputs(args, final, cfg):
    from .ops.render import render
    from .utils.imageio import save_png

    if args.save_scene:
        from .utils.sceneio import save_scene

        save_scene(args.save_scene, final)
        print(args.save_scene)
    if args.output:
        save_png(args.output, render(final, cfg).detach())
        print(args.output)


def _invert_annealed(args, scene, spec, cfg, target, start, ocfg):
    """``invert --anneal``: the soft stages against the truth rendered at
    each tau (at ``--anneal-size``), then the hard polish against the
    target; the per-step losses come back in one transfer at the end. With
    ``--frame-every`` the chunks shrink to the frame cadence and each chunk
    ends with a frame of the current scene under the hard configuration.
    With ``--restarts N > 1`` the anneal runs from N starts
    (`optim.optimize_multistart`, seed ``--seed + 1000``, the JAX package's),
    the losses logged are the best final hard loss alone, and the finals
    print on stderr."""
    from .ops.render import render
    from .optim import optimize_annealed, optimize_multistart, param_error
    from .utils.imageio import save_png
    from .utils.metrics import MetricsLogger

    try:
        taus = tuple(float(x) for x in args.anneal.split(","))
    except ValueError:
        sys.exit(f"error: --anneal expects comma-separated floats "
                 f"(e.g. '0.08,0.03,0'), got {args.anneal!r}")
    frame_cb, max_chunk = None, 100
    if args.frame_every and args.frames_dir:
        max_chunk = max(1, min(100, args.frame_every))

        def frame_cb(s, it):
            save_png(f"{args.frames_dir}/frame_{it:05d}.png", render(s, cfg).detach())

    err0 = float(param_error(start, scene, spec))
    logger = MetricsLogger(jsonl_path=args.metrics, echo=not args.quiet)
    try:
        t0 = time.perf_counter()
        anneal_kw = dict(taus=taus, target_scene=scene, soft_size=args.anneal_size,
                         max_chunk=max_chunk, chunk_callback=frame_cb,
                         checker_ratio=args.checker_ratio)
        finals = best_loss = None
        if args.restarts > 1:
            final, best_loss, finals = optimize_multistart(
                start, target, spec, cfg, ocfg, restarts=args.restarts,
                jitter=args.restart_jitter, seed=args.seed + 1000,
                proposal=args.restart_proposal, chain=args.restart_chain, **anneal_kw)
            la = [best_loss]
            print(f"multistart finals: {['%.3e' % f for f in finals]} -> best {best_loss:.3e}",
                  file=sys.stderr)
        else:
            final, losses = optimize_annealed(start, target, spec, cfg, ocfg, **anneal_kw)
            la = losses.cpu().tolist()  # each stage's loss is comparable within the stage only
        err = float(param_error(final, scene, spec))
        dt = time.perf_counter() - t0
        stride = max(len(la) // 20, 1) if args.log_every else len(la)
        for i in range(0, len(la), stride):
            logger.log(step=i, loss=la[i])
        logger.log(step=len(la), loss=la[-1], wall_s=round(dt, 3), taus=list(taus))
    finally:
        logger.close()
    print(f"final param RMS error vs truth: {err:.5f} (start {err0:.5f})", file=sys.stderr)
    runs = f" x {args.restarts} restarts" if finals else ""
    print(f"annealed {len(taus)} stages x {args.iters} iters{runs} in {dt:.1f}s "
          f"(final loss {la[-1]:.3e})", file=sys.stderr)
    _save_outputs(args, final, cfg)
    return {"history": [{"loss": la[-1]}], "losses": la, "taus": list(taus),
            "checker_ratio": args.checker_ratio, "param_err": err,
            "start_param_err": err0, "seconds": dt, "output": args.output, "scene": final,
            "finals": finals, "best_loss": best_loss}


def main(argv=None):
    """Parse ``argv`` and run the subcommand; returns its summary dict."""
    from .optim import RESTART_PROPOSALS

    ap = argparse.ArgumentParser(prog="reversible_raytracer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene to PNG")
    _add_common(pr)
    pr.add_argument("-o", "--output", default="render.png")
    pr.set_defaults(fn=cmd_render)

    pi = sub.add_parser("invert", help="inverse-render: recover scene params from a target")
    _add_common(pi)
    pi.add_argument("--iters", type=int, default=400)
    pi.add_argument("--lr", type=float, default=1e-2)
    pi.add_argument("--loss", choices=["mse", "sum"], default="mse")
    pi.add_argument("--schedule", choices=["cosine", "constant"], default="cosine",
                    help="learning-rate schedule (cosine stabilizes the endgame)")
    pi.add_argument("--perturb", type=float, default=0.05,
                    help="perturbation scale applied to trainable params")
    pi.add_argument("--seed", type=int, default=0)
    pi.add_argument("--target", type=str, default=None,
                    help="PNG target image (default: render the ground truth); with it "
                         "no parameter error is reported")
    pi.add_argument("--sharded", action="store_true",
                    help="shard rays over all ranks of the process group (P1; alone: one rank)")
    pi.add_argument("--coordinator", type=str, default=None,
                    help="multi-host: coordinator address for torch.distributed (P3)")
    pi.add_argument("--num-processes", type=int, default=None,
                    help="multi-host: total process count")
    pi.add_argument("--process-id", type=int, default=None,
                    help="multi-host: this process's id")
    pi.add_argument("--log-every", type=int, default=25)
    pi.add_argument("--metrics", type=str, default=None, help="JSONL metrics path")
    pi.add_argument("--quiet", action="store_true", help="suppress per-step stderr logs")
    pi.add_argument("--frame-every", type=int, default=0,
                    help="render the scene to --frames-dir every N steps (with --anneal: "
                         "after every chunk of at most N steps)")
    pi.add_argument("--frames-dir", type=str, default="frames")
    pi.add_argument("--checkpoint", type=str, default=None,
                    help="npz checkpoint path (the JAX package's schema), saved at the end")
    pi.add_argument("--checkpoint-every", type=int, default=0,
                    help="also save the checkpoint every N steps")
    pi.add_argument("--resume", type=str, default=None,
                    help="restart from a checkpoint (of either package)")
    pi.add_argument("--save-scene", type=str, default=None,
                    help="save the final scene as JSON")
    pi.add_argument("-o", "--output", type=str, default=None,
                    help="save the final render as PNG")
    pi.add_argument("--anneal", type=str, default=None, metavar="TAUS",
                    help="soft-visibility annealing: comma-separated soft_tau stages, "
                         "--iters steps each, e.g. 0.08,0.03,0.01,0")
    pi.add_argument("--anneal-size", type=int, default=None,
                    help="image size of the soft (tau > 0) stages (default: --size)")
    pi.add_argument("--checker-ratio", type=float, default=0.0,
                    help="soft-checker temperature per anneal tau unit (checker_tau = ratio "
                         "* tau per stage; 12.5 recovers the camera pose against checkers, "
                         "config 4). 0 = hard checker (default)")
    pi.add_argument("--restarts", type=int, default=1,
                    help="with --anneal: seeded multi-start — run the whole anneal from N "
                         "jittered starts and keep the best final hard loss (widens recovery "
                         "basins; see docs/OPTIMIZATION_NOTES.md)")
    pi.add_argument("--restart-jitter", type=float, default=0.15,
                    help="relative re-perturbation scale for --restarts")
    pi.add_argument("--restart-proposal", default="jitter", choices=list(RESTART_PROPOSALS),
                    help="restart proposal family (optim.propose_restart): structure-aware "
                         "moves (per-sphere re-jitter, pairwise identity swaps, residual-guided "
                         "re-seeding) attack topology stalls that i.i.d. jitter cannot reach")
    pi.add_argument("--restart-chain", action="store_true",
                    help="propose each restart from the best converged scene so far "
                         "(sequential repair; with --restart-proposal resid this closed the "
                         "0.45/seed-2 stall — OPTIMIZATION_NOTES)")
    pi.set_defaults(fn=cmd_invert)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
