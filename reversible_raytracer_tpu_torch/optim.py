"""Inverse rendering: Adam or SGD with box projection over the scene's
trainable leaves, the training loops, checkpoints, and the annealed
inversion.

The counterpart of `reversible_raytracer_tpu.optim`. The update is the
JAX package's flat update (`make_flat_update`): the trainable leaves
raveled into one vector, optax's Adam written out (bias correction,
``eps`` outside the square root) or SGD with optax's momentum trace, the
``lr_scales`` multipliers and then the learning rate, in that order, and a
clip to the box bounds. ``torch.optim`` rounds differently and is not used.
`make_step` is the JAX package's jitted step: on CUDA a CUDA graph
(`graphs.GraphStep`) replayed once a step; `optimize`, `optimize_scan` and
`optimize_annealed` run through it. The optimizer state saves and loads in
the JAX package's checkpoint schema (`save_checkpoint`, `load_checkpoint`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .models.scene import (
    ParamSpec,
    Scene,
    leaf_paths,
    path_matches,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from .ops.pipeline import RenderConfig


@dataclass(frozen=True)
class OptConfig:
    iters: int = 200
    lr: float = 2e-2
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    loss: str = "mse"  # "mse" | "sum"
    # "cosine" decays to 0 over `iters` (optax.cosine_decay_schedule):
    # constant-lr Adam tends to leave the basin after converging here.
    schedule: str = "cosine"  # "cosine" | "constant"
    # "adam" | "sgd": plain SGD follows the true gradient magnitudes (the
    # annealed inversion's hard polish, where Adam random-walks).
    optimizer: str = "adam"
    momentum: float = 0.0  # sgd only: optax.trace's decay
    # (("spheres.radius", 0.3), ...): per-leaf multipliers applied after
    # the optimizer and before the learning rate; the first matching path wins.
    lr_scales: tuple = ()

    def learning_rate(self, count, device=None) -> torch.Tensor:
        """The learning rate of update number ``count`` (0-based: an int, or
        the optimizer state's integer tensor, on its device), as a float32
        scalar like optax's schedules compute it."""
        if not isinstance(count, torch.Tensor):
            count = torch.tensor(count, dtype=torch.int32, device=device)
        if self.schedule == "constant":
            return torch.full((), self.lr, dtype=torch.float32, device=count.device)
        if self.schedule == "cosine":
            steps = float(max(self.iters, 1))
            c = torch.clamp(count.to(torch.float32), max=steps)
            return self.lr * (0.5 * (1.0 + torch.cos(math.pi * c / steps)))
        raise ValueError(f"unknown schedule {self.schedule!r}")


def mask_grads(grads: Scene, spec: ParamSpec) -> Scene:
    """Zero the gradients of untrainable leaves."""
    return tree_map(lambda g, t: g if t else torch.zeros_like(g), grads, spec.trainable)


def project_bounds(scene: Scene, spec: ParamSpec) -> Scene:
    """Clip trainable leaves to their box bounds."""
    return tree_map(
        lambda x, t, lo, hi: torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))
        if t else x,
        scene, spec.trainable, spec.lower, spec.upper,
    )


def trainable_flags(spec: ParamSpec) -> list:
    """One bool per leaf, in `tree_leaves` order: whether it is trained."""
    return [bool(t) for t in tree_leaves(spec.trainable)]


def ravel_trainable(tree, tflags):
    """The trainable leaves of ``tree`` raveled into one flat vector."""
    return torch.cat([l.reshape(-1) for l, f in zip(tree_leaves(tree), tflags) if f])


def unravel_trainable(flat, scene, tflags):
    """``scene`` with its trainable leaves replaced by views of ``flat``
    (the inverse of `ravel_trainable`); the other leaves as they are."""
    out, off = [], 0
    for leaf, f in zip(tree_leaves(scene), tflags):
        if f:
            out.append(flat[off:off + leaf.numel()].reshape(leaf.shape))
            off += leaf.numel()
        else:
            out.append(leaf)
    return tree_unflatten(scene, out)


def make_flat_update(template: Scene, spec: ParamSpec, ocfg: OptConfig):
    """``(init, apply)`` for the update on one flat vector of the trainable
    leaves: ``init(scene) -> state`` and ``apply(scene, state, grads) ->
    (scene, state, grad_norm)``. Untrainable leaves pass through as they
    are, and their gradients are never read. The state is a dict of tensors
    on the scene's device: ``count`` (int32, the updates made so far, from
    which the learning rate and Adam's bias corrections are computed on the
    device), and ``mu``/``nu`` for Adam or ``trace`` for SGD with momentum,
    flat like the trainable leaves. Nothing in ``apply`` copies between host
    and device, so a CUDA graph can capture it."""
    tflags = trainable_flags(spec)
    if not any(tflags):
        raise ValueError("no trainable leaves")
    leaves = tree_leaves(template)
    dev = leaves[0].device

    def expand(values):
        return torch.cat([torch.full((l.numel(),), float(v), dtype=torch.float32, device=dev)
                          for l, v, f in zip(leaves, values, tflags) if f])

    lo = expand(tree_leaves(spec.lower))
    hi = expand(tree_leaves(spec.upper))
    factors = []
    for path in leaf_paths(template):
        factors.append(next((m for needle, m in ocfg.lr_scales if path_matches(path, needle)), 1.0))
    scale = expand(factors) if ocfg.lr_scales else None

    if ocfg.optimizer not in ("adam", "sgd"):
        raise ValueError(f"unknown optimizer {ocfg.optimizer!r}")
    b1, b2 = ocfg.b1, ocfg.b2
    b1_t = torch.tensor(b1, dtype=torch.float32, device=dev)
    b2_t = torch.tensor(b2, dtype=torch.float32, device=dev)

    def init(scene):
        z = torch.zeros_like(ravel_trainable(scene, tflags))
        state = {"count": torch.zeros((), dtype=torch.int32, device=dev)}
        if ocfg.optimizer == "adam":
            state["mu"], state["nu"] = z, z.clone()
        elif ocfg.momentum:
            state["trace"] = z
        return state

    def apply(scene, state, grads):
        g = ravel_trainable(grads, tflags)
        gnorm = torch.sqrt(torch.sum(g * g))
        count = state["count"] + 1
        new = {"count": count}
        if ocfg.optimizer == "sgd":
            u = g
            if ocfg.momentum:  # optax.trace: g + decay * trace
                u = new["trace"] = g + ocfg.momentum * state["trace"]
        else:
            mu = (1 - b1) * g + b1 * state["mu"]
            nu = (1 - b2) * (g * g) + b2 * state["nu"]
            c = count.to(torch.float32)
            mu_hat = mu / (1 - b1_t ** c)
            nu_hat = nu / (1 - b2_t ** c)
            u = mu_hat / (torch.sqrt(nu_hat) + ocfg.eps)
            new["mu"], new["nu"] = mu, nu
        if scale is not None:
            u = u * scale
        u = u * -ocfg.learning_rate(state["count"])
        flat = torch.minimum(torch.maximum(ravel_trainable(scene, tflags) + u, lo), hi)
        return unravel_trainable(flat, scene, tflags), new, gnorm

    return init, apply


def _default_vag(scene_like, rcfg: RenderConfig, ocfg: OptConfig, render_fn):
    from .ops.render import autograd_loss_and_grad_fn, loss_and_grad_fn

    if render_fn is None:
        return loss_and_grad_fn(scene_like, rcfg, loss=ocfg.loss)
    return autograd_loss_and_grad_fn(render_fn, rcfg, loss=ocfg.loss)


def _make_step(rcfg, spec, ocfg, render_fn, vag_fn, capture: bool):
    parts = {}

    def build(scene):
        finit, fapply = make_flat_update(scene, spec, ocfg)
        vag = vag_fn if vag_fn is not None else _default_vag(scene, rcfg, ocfg, render_fn)

        def eager(s, state, target):
            loss, grads = vag(s, target)
            s, state, gnorm = fapply(s, state, grads)
            return s, state, loss, gnorm

        parts["init"] = finit
        if capture and scene.device.type == "cuda":
            from .graphs import GraphStep

            tflags = trainable_flags(spec)
            static = {}

            def static_scene(s):
                static["flat"] = ravel_trainable(s, tflags).detach().clone()
                rest = tree_unflatten(s, [l.detach().clone() for l in tree_leaves(s)])
                return unravel_trainable(static["flat"], rest, tflags)

            def put_scene(dst, src):
                moved = False
                for d, v, f in zip(tree_leaves(dst), tree_leaves(src), tflags):
                    if f:
                        moved = moved or v.data_ptr() != d.data_ptr()
                    elif v.data_ptr() != d.data_ptr():
                        d.copy_(v)
                if moved:  # one copy of the trainable leaves into the static flat vector
                    torch.cat([v.reshape(-1) for v, f in zip(tree_leaves(src), tflags) if f],
                              out=static["flat"])

            parts["step"] = GraphStep(eager, static_scene=static_scene, put_scene=put_scene)
        else:
            parts["step"] = eager

    def init(scene):
        if not parts:
            build(scene)
        return parts["init"](scene)

    def step(scene, state, target):
        if not parts:
            build(scene)
        return parts["step"](scene, state, target)

    return step, init


def make_step(rcfg: RenderConfig, spec: ParamSpec, ocfg: OptConfig, render_fn=None,
              vag_fn=None):
    """The single optimization step (the JAX package's jitted `make_step`).
    Returns ``(step, init)``: ``init(scene) -> state`` and ``step(scene,
    state, target) -> (scene, state, loss, grad_norm)``.

    ``vag_fn(scene, target) -> (loss, grads)`` defaults to
    `ops.render.loss_and_grad_fn` (on CUDA one fused step kernel: rows 1, 6
    and 9). Given ``render_fn(scene) -> (H, W, 3)`` and no ``vag_fn``, the
    step is torch autograd of ``ocfg.loss`` over it (with `ops.render.render`
    on CUDA: a forward kernel and its render backward, rows 2+3, 4+5, 7+8).
    The update is `make_flat_update`'s.

    On CUDA the step is captured into a CUDA graph (`graphs.GraphStep`):
    the first call runs it eagerly and captures it, every later call is one
    replay, and the scene and state it returns are the graph's static
    buffers, overwritten by the next call. A step that cannot be captured
    raises `graphs.CaptureError`. On the CPU the step is the eager function,
    which is the plain version of the graph (`make_eager_step`)."""
    return _make_step(rcfg, spec, ocfg, render_fn, vag_fn, capture=True)


def make_eager_step(rcfg: RenderConfig, spec: ParamSpec, ocfg: OptConfig, render_fn=None,
                    vag_fn=None):
    """`make_step` without the CUDA graph: every call launches the step's
    kernels and ops one by one from the host. The plain version of the
    captured step, on any device."""
    return _make_step(rcfg, spec, ocfg, render_fn, vag_fn, capture=False)


def _frame(scene, rcfg, render_fn):
    from .ops.render import render

    with torch.no_grad():
        return render(scene, rcfg) if render_fn is None else render_fn(scene)


def optimize(scene: Scene, target, spec: ParamSpec, rcfg: RenderConfig, ocfg: OptConfig,
             vag_fn=None, logger=None, log_every: int = 10, truth: Scene | None = None,
             render_fn=None, frame_every: int = 0, frame_dir: str | None = None,
             checkpoint_every: int = 0, checkpoint_path: str | None = None,
             resume: str | None = None):
    """Host-driven optimization loop through `make_step` (one graph replay a
    step on CUDA). Each step's loss (before that step's update) goes into a
    device tensor; only the steps logged every ``log_every`` (0: none), the
    frames and the checkpoints wait for the device.

    As the JAX package's `optimize`: every ``frame_every`` steps the scene is
    rendered (``render_fn``, or `ops.render.render`) to
    ``frame_dir/frame_<it>.png``; every ``checkpoint_every`` steps (after the
    first) and at the end the scene and optimizer state are saved to
    ``checkpoint_path`` (`utils.checkpoint`, with the step to restart at:
    ``it + 1``), and ``resume`` restarts from such a file. Returns
    (final_scene, history, losses[iters - start]), where history holds the
    logged steps' loss and grad norm and ``start`` is the resumed step (0
    without ``resume``)."""
    from .utils.imageio import save_png

    step, init = make_step(rcfg, spec, ocfg, render_fn=render_fn, vag_fn=vag_fn)
    state = init(scene)
    start_iter = 0
    if resume is not None:
        scene, state, start_iter = load_checkpoint(resume, scene, spec, ocfg)
    history = []
    losses = torch.empty((max(ocfg.iters - start_iter, 0),), dtype=torch.float32,
                         device=target.device)
    for it in range(start_iter, ocfg.iters):
        scene, state, loss, gnorm = step(scene, state, target)
        losses[it - start_iter] = loss
        if log_every and (it % log_every == 0 or it == ocfg.iters - 1):
            rec = {"step": it, "loss": float(loss), "grad_norm": float(gnorm)}
            if truth is not None:
                rec["param_err"] = float(param_error(scene, truth, spec))
            history.append(rec)
            if logger is not None:
                logger.log(**rec)
        if frame_every and frame_dir and it % frame_every == 0:
            save_png(f"{frame_dir}/frame_{it:05d}.png", _frame(scene, rcfg, render_fn))
        if checkpoint_every and checkpoint_path and it and it % checkpoint_every == 0:
            # it + 1: update `it` is applied, so a resume starts at the next one
            save_checkpoint(checkpoint_path, scene, state, it + 1, spec, ocfg)
    if checkpoint_path:
        save_checkpoint(checkpoint_path, scene, state, ocfg.iters, spec, ocfg)
    return scene, history, losses


_SCAN_CACHE: dict = {}


def _scan_key(scene, spec, rcfg, ocfg, cache_key):
    return (tuple(leaf_paths(scene)), tuple(tuple(l.shape) for l in tree_leaves(scene)),
            str(scene.device), rcfg, ocfg, tuple(trainable_flags(spec)),
            tuple(float(x) for x in tree_leaves(spec.lower)),
            tuple(float(x) for x in tree_leaves(spec.upper)), cache_key)


def optimize_scan(scene: Scene, target, spec: ParamSpec, rcfg: RenderConfig, ocfg: OptConfig,
                  render_fn=None, cache_key=None, max_chunk: int | None = None, vag_fn=None,
                  chunk_callback=None):
    """The whole loop without a host wait (the JAX package's `optimize_scan`,
    whose ``lax.scan`` becomes back-to-back replays of `make_step`'s CUDA
    graph): ``ocfg.iters`` steps in chunks of at most ``max_chunk``, each
    step's loss into one device tensor that comes back once per call. The
    optimizer state carries across chunks, so the results are those of one
    chunk. ``chunk_callback(scene, it)`` runs after each chunk with the
    steps done so far. Given a hashable ``cache_key`` that identifies
    ``render_fn`` / ``vag_fn``, the captured step is kept and reused by later
    calls of the same scene structure and configuration. On the CPU the
    steps are the eager step's. Returns (final_scene, losses[iters]); the
    final scene is a copy (the graph's buffers are reused)."""
    if cache_key is None:
        step, init = make_step(rcfg, spec, ocfg, render_fn=render_fn, vag_fn=vag_fn)
    else:
        sig = _scan_key(scene, spec, rcfg, ocfg, cache_key)
        if sig not in _SCAN_CACHE:
            _SCAN_CACHE[sig] = make_step(rcfg, spec, ocfg, render_fn=render_fn, vag_fn=vag_fn)
        step, init = _SCAN_CACHE[sig]
    if max_chunk is None or ocfg.iters <= max_chunk:
        lengths = [ocfg.iters]
    else:
        n_full, rem = divmod(ocfg.iters, max_chunk)
        lengths = [max_chunk] * n_full + ([rem] if rem else [])
    state = init(scene)
    losses = torch.empty((ocfg.iters,), dtype=torch.float32, device=target.device)
    it = 0
    for length in lengths:
        for _ in range(length):
            scene, state, loss, _ = step(scene, state, target)
            losses[it] = loss
            it += 1
        if chunk_callback is not None:
            chunk_callback(scene, it)
    return tree_map(lambda l: l.detach().clone(), scene), losses


# ---------------------------------------------------------------------------
# Checkpoints: the optimizer state as the JAX package's optax state holds it
# ---------------------------------------------------------------------------


def opt_state_leaves(state: dict, scene_like: Scene, spec: ParamSpec, ocfg: OptConfig) -> list:
    """The leaves of the JAX package's ``make_optimizer(ocfg).init(scene)``
    state for this state, as numpy arrays in its order: for Adam the count,
    every scene leaf's ``mu``, every leaf's ``nu``; for SGD with momentum
    every leaf's trace; then, for the cosine schedule, its count. Untrained
    leaves hold moments of 0, as optax holds them under the mask."""
    tflags = trainable_flags(spec)
    count = np.asarray(int(state["count"]), np.int32)

    def per_leaf(flat):
        host = flat.detach().cpu().numpy().astype(np.float32)
        out, off = [], 0
        for leaf, f in zip(tree_leaves(scene_like), tflags):
            n = leaf.numel()
            out.append(host[off:off + n].reshape(tuple(leaf.shape)) if f
                       else np.zeros(tuple(leaf.shape), np.float32))
            off += n if f else 0
        return out

    leaves = []
    if ocfg.optimizer == "adam":
        leaves += [count, *per_leaf(state["mu"]), *per_leaf(state["nu"])]
    elif ocfg.momentum:
        leaves += per_leaf(state["trace"])
    if ocfg.schedule == "cosine":
        leaves.append(count)
    return leaves


def opt_state_from_leaves(leaves, scene_like: Scene, spec: ParamSpec, ocfg: OptConfig,
                          step: int) -> dict:
    """The inverse of `opt_state_leaves`, on the scene's device; the count
    is ``step`` where the state has no count leaf (SGD at a constant rate,
    whose update does not read it)."""
    tflags = trainable_flags(spec)
    dev = tree_leaves(scene_like)[0].device
    n_leaves = len(tflags)

    def flat(part):
        return torch.from_numpy(np.concatenate(
            [np.asarray(x, np.float32).reshape(-1) for x, f in zip(part, tflags) if f])).to(dev)

    leaves = list(leaves)
    count = step
    state = {}
    if ocfg.optimizer == "adam":
        count = int(leaves[0])
        state["mu"] = flat(leaves[1:1 + n_leaves])
        state["nu"] = flat(leaves[1 + n_leaves:1 + 2 * n_leaves])
    elif ocfg.momentum:
        state["trace"] = flat(leaves[:n_leaves])
    elif ocfg.schedule == "cosine":
        count = int(leaves[-1])
    state["count"] = torch.tensor(count, dtype=torch.int32, device=dev)
    return state


def save_checkpoint(path: str, scene: Scene, state: dict, step: int, spec: ParamSpec,
                    ocfg: OptConfig) -> None:
    """`utils.checkpoint.save` of the scene and this optimizer state."""
    from .utils import checkpoint

    checkpoint.save(path, scene, opt_state_leaves(state, scene, spec, ocfg), step)


def load_checkpoint(path: str, scene_like: Scene, spec: ParamSpec, ocfg: OptConfig,
                    allow_partial: bool = False):
    """``(scene, state, step)`` from a checkpoint of either package, held
    to the optimizer state that ``ocfg`` makes (strict, as
    `utils.checkpoint.load`)."""
    from .utils import checkpoint

    init, _ = make_flat_update(scene_like, spec, ocfg)
    like = opt_state_leaves(init(scene_like), scene_like, spec, ocfg)
    scene, leaves, step = checkpoint.load(path, scene_like, like, allow_partial=allow_partial)
    return scene, opt_state_from_leaves(leaves, scene, spec, ocfg, step), step


def param_error(scene: Scene, truth: Scene, spec: ParamSpec):
    """RMS error over the trainable parameters against the ground truth."""
    sq, count = 0.0, 0
    for a, b, t in zip(tree_leaves(scene), tree_leaves(truth), tree_leaves(spec.trainable)):
        if t:
            sq = sq + torch.sum((a - b) ** 2)
            count += a.numel()
    return torch.sqrt(sq / max(count, 1))


def anneal_stage_uses_step(impl_name: str, spp: int) -> bool:
    """Whether an `optimize_annealed` stage runs a fused training-step kernel
    (the JAX package's `anneal_stage_uses_step`, optim.py:822-839, over the
    port's `ops.render.resolve_impl` names) rather than autograd of the
    stage's `render`. The hard steps (rows 1 and 6) take spp 1 and 4 in the
    kernel: the residual is of the clipped subsamples' average. The soft
    step (row 9) is spp 1, so a spp-4 soft stage is autograd through four
    launches of the soft forward and of its render backward (rows 7 and 8).
    The eager twins have no step kernel."""
    return (impl_name in ("cuda", "cuda_vec") and spp in (1, 4)) or (
        impl_name == "cuda_vec_soft" and spp == 1)


def optimize_annealed(scene: Scene, target, spec: ParamSpec, rcfg: RenderConfig,
                      ocfg: OptConfig, taus=(0.08, 0.03, 0.01, 0.0),
                      target_scene: Scene | None = None, soft_size: int | None = None,
                      max_chunk: int | None = 100, hard_ocfg="auto", chunk_callback=None,
                      checker_ratio: float = 0.0):
    """Soft-visibility annealing for the joint geometry inversion (the JAX
    package's `optimize_annealed`): ``ocfg.iters`` steps per tau stage with
    ``soft_tau = tau``, each stage warm-started from the last and run by
    `optimize_scan` in chunks of at most ``max_chunk`` steps, through
    `ops.render`'s dispatch (on CUDA the soft step kernel for tau > 0 and
    the hard one for tau = 0; autograd of `ops.render.render` where
    `anneal_stage_uses_step` says no step kernel serves the stage, as for a
    soft stage at spp 4). With ``target_scene`` each soft stage's
    target is the truth rendered at that stage's tau (and at ``soft_size``,
    if given); the tau = 0 stage runs against ``target``, with
    ``hard_ocfg`` ("auto": SGD at lr 0.3 without momentum; None: ``ocfg``).
    ``chunk_callback(scene, it)`` runs after each chunk with the global
    iteration. ``checker_ratio > 0`` relaxes the checker as well, each stage
    at ``checker_tau = checker_ratio * tau`` (the soft checker, which gives
    the camera a gradient against checkered materials: config 4's recipe is
    12.5), so the tau = 0 polish keeps the hard checker. A reflective
    ``rcfg`` with a soft stage raises before any stage runs: soft rendering
    takes no mirror bounce, as in the JAX package (anneal the geometry
    without it, then polish with it). A scene with a texel grid (object
    textures or an environment map) takes the soft kernels' texel instances
    in its soft stages and polishes where `ops.render.resolve_impl` sends its
    hard render. Returns (final_scene, losses[len(taus) * iters]) on the
    scene's device."""
    import dataclasses

    from .ops.render import render, resolve_impl

    if rcfg.reflections and any(float(tau) > 0.0 for tau in taus):
        raise NotImplementedError(
            "mirror reflections require hard semantics: the soft (tau > 0) stages of "
            "optimize_annealed take reflections=0 (anneal without the bounce, then polish "
            "with reflections on)")
    if soft_size is not None and target_scene is None:
        raise ValueError("soft_size requires target_scene (stage targets are re-rendered)")
    if hard_ocfg == "auto":
        # From the soft stages' near-optimum Adam's normalized steps
        # random-walk, where plain SGD's follow the true, tiny gradients.
        hard_ocfg = dataclasses.replace(ocfg, optimizer="sgd", lr=0.3, momentum=0.0)
    all_losses = []
    for tau in taus:
        cfg_t = dataclasses.replace(rcfg, soft_tau=float(tau),
                                    checker_tau=float(checker_ratio) * float(tau))
        if tau > 0.0 and soft_size is not None:
            cfg_t = dataclasses.replace(cfg_t, height=soft_size, width=soft_size)
        tgt = target
        if target_scene is not None and tau > 0.0:
            tgt = render(target_scene, cfg_t).detach()
        stage_ocfg = hard_ocfg if (tau == 0.0 and hard_ocfg is not None) else ocfg
        done = sum(int(l.shape[0]) for l in all_losses)
        use_step = anneal_stage_uses_step(resolve_impl(scene, cfg_t), cfg_t.spp)
        scene, losses = optimize_scan(
            scene, tgt, spec, cfg_t, stage_ocfg, max_chunk=max_chunk,
            render_fn=None if use_step else (lambda s, c=cfg_t: render(s, c)),
            cache_key=("annealed-step" if use_step else "annealed-render", float(tau),
                       cfg_t.checker_tau, soft_size),
            chunk_callback=(None if chunk_callback is None
                            else (lambda s, it, base=done: chunk_callback(s, base + it))))
        all_losses.append(losses)
    return scene, torch.cat(all_losses)
