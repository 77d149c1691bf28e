"""Command-line interface: ``render`` and ``invert`` for configs 1-3 and 5.

Examples:
    python -m reversible_raytracer_tpu_torch.cli render --config 2 --size 512 -o out.png
    python -m reversible_raytracer_tpu_torch.cli invert --config 2 --size 512 --iters 200
    python -m reversible_raytracer_tpu_torch.cli invert --config 5 --anneal 0.08,0.03,0.01,0 \
        --anneal-size 512 --lr 2e-3 --iters 300 --perturb 0.03

Both run on the GPU (``--device cuda``, the default) through the CUDA
kernels; ``--device cpu`` runs the eager torch twin instead.
"""

from __future__ import annotations

import argparse
import sys
import time


def _add_common(p):
    p.add_argument("--config", type=int, default=2, choices=[1, 2, 3, 5],
                   help="benchmark config (1: one sphere, 2: four spheres + ground, "
                        "3: two lights, 5: 64 spheres + ground)")
    p.add_argument("--size", type=int, default=None,
                   help="image size (default: the config's native size)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the eager twin)")


def _build(args):
    from .models import configs as cfgs

    builder = cfgs.CONFIGS[args.config]
    kw = {"device": args.device}
    if args.size:
        kw["size"] = args.size
    return builder(**kw)


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


def cmd_invert(args):
    from .models.configs import perturb
    from .ops.render import loss_and_grad_fn, render
    from .optim import OptConfig, optimize, param_error
    from .utils.imageio import save_png
    from .utils.metrics import MetricsLogger

    scene, spec, cfg = _build(args)
    target = render(scene, cfg)
    start = perturb(scene, spec, scale=args.perturb, seed=args.seed)
    ocfg = OptConfig(iters=args.iters, lr=args.lr, loss=args.loss, schedule=args.schedule)
    if args.anneal:
        return _invert_annealed(args, scene, spec, cfg, target, start, ocfg)
    logger = MetricsLogger(jsonl_path=args.metrics)
    try:
        vag = loss_and_grad_fn(scene, cfg, loss=args.loss)
        t0 = time.perf_counter()
        final, history, _ = optimize(start, target, spec, cfg, ocfg, vag_fn=vag,
                                     logger=logger, log_every=args.log_every, truth=scene)
        err = float(param_error(final, scene, spec))
        dt = time.perf_counter() - t0
    finally:
        logger.close()
    print(f"final param RMS error vs truth: {err:.5f}", file=sys.stderr)
    final_loss = f"{history[-1]['loss']:.3e}" if history else "n/a (--log-every 0)"
    print(f"optimized {args.iters} iters in {dt:.1f}s (final loss {final_loss})",
          file=sys.stderr)
    if args.output:
        save_png(args.output, render(final, cfg))
        print(args.output)
    return {"history": history, "param_err": err, "seconds": dt, "output": args.output}


def _invert_annealed(args, scene, spec, cfg, target, start, ocfg):
    """``invert --anneal``: the soft stages against the truth rendered at
    each tau (at ``--anneal-size``), then the hard polish against the
    target; the per-step losses come back in one transfer at the end."""
    from .ops.render import render
    from .optim import optimize_annealed, param_error
    from .utils.imageio import save_png
    from .utils.metrics import MetricsLogger

    try:
        taus = tuple(float(x) for x in args.anneal.split(","))
    except ValueError:
        sys.exit(f"error: --anneal expects comma-separated floats "
                 f"(e.g. '0.08,0.03,0'), got {args.anneal!r}")
    err0 = float(param_error(start, scene, spec))
    logger = MetricsLogger(jsonl_path=args.metrics)
    try:
        t0 = time.perf_counter()
        final, losses = optimize_annealed(start, target, spec, cfg, ocfg, taus=taus,
                                          target_scene=scene, soft_size=args.anneal_size)
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
    print(f"annealed {len(taus)} stages x {args.iters} iters in {dt:.1f}s "
          f"(final loss {la[-1]:.3e})", file=sys.stderr)
    if args.output:
        save_png(args.output, render(final, cfg))
        print(args.output)
    return {"history": [{"loss": la[-1]}], "losses": la, "taus": list(taus), "param_err": err,
            "start_param_err": err0, "seconds": dt, "output": args.output}


def main(argv=None):
    """Parse ``argv`` and run the subcommand; returns its summary dict."""
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
    pi.add_argument("--log-every", type=int, default=25)
    pi.add_argument("--metrics", type=str, default=None, help="JSONL metrics path")
    pi.add_argument("-o", "--output", type=str, default=None,
                    help="save the final render as PNG")
    pi.add_argument("--anneal", type=str, default=None, metavar="TAUS",
                    help="soft-visibility annealing: comma-separated soft_tau stages, "
                         "--iters steps each, e.g. 0.08,0.03,0.01,0")
    pi.add_argument("--anneal-size", type=int, default=None,
                    help="image size of the soft (tau > 0) stages (default: --size)")
    pi.set_defaults(fn=cmd_invert)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
