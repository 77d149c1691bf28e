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

    step.parts = parts  # the built step: a graphs.GraphStep where it is captured
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


# ---------------------------------------------------------------------------
# Restarts: seeded and structure-aware starting points over the anneal
# ---------------------------------------------------------------------------


def swap_spheres(scene: Scene, i: int, j: int, geometry_only: bool = True) -> Scene:
    """``scene`` with the rows of spheres ``i`` and ``j`` exchanged, in new
    tensors (the JAX package's `swap_spheres`). ``geometry_only`` swaps the
    center rows alone: a topology stall is an identity error (the sphere
    with A's appearance sits in B's basin), and a center swap is its exact
    inverse. Swapping every sphere leaf whose first dimension is the sphere
    count re-indexes the scene, which renders the same."""
    import dataclasses

    n = scene.spheres.count

    def swap_leaf(x):
        if x.dim() >= 1 and x.shape[0] == n:
            perm = list(range(n))
            perm[i], perm[j] = j, i
            return x[torch.tensor(perm, device=x.device)]
        return x

    if geometry_only:
        return dataclasses.replace(scene, spheres=dataclasses.replace(
            scene.spheres, center=swap_leaf(scene.spheres.center)))
    return dataclasses.replace(scene, spheres=tree_map(swap_leaf, scene.spheres))


def rejitter_one_sphere(start: Scene, spec: ParamSpec, idx: int, scale: float,
                        seed: int) -> Scene:
    """``start`` with only sphere ``idx``'s rows re-drawn: the whole scene is
    perturbed (`models.configs.perturb`, the same draws as the JAX package's)
    and that sphere's rows are kept, every other parameter stays at
    ``start``. A kick at one suspect leaves the converged spheres alone."""
    import dataclasses

    from .models.configs import perturb

    n = start.spheres.count
    jittered = perturb(start, spec, scale=scale, seed=seed)

    def merge(a, b):
        if a.dim() >= 1 and a.shape[0] == n:
            out = a.clone()
            out[idx] = b[idx]
            return out
        return a

    return dataclasses.replace(start, spheres=tree_map(merge, start.spheres, jittered.spheres))


def restart_attribution(scene: Scene, target, rcfg: RenderConfig):
    """``(resid, suspicion)`` on the scene's device: the signed luma residual
    ``target - render`` of the hard render (``soft_tau = checker_tau = 0``,
    through `ops.render.render`: a forward kernel on CUDA), an (H, W)
    tensor, and each sphere's mean |residual| over the pixels whose nearest
    sphere it is (camera rays against the spheres alone, ties to the lower
    index), ``inf`` for a sphere that is nearest nowhere. The attribution of
    the JAX package's `residual_reseed`."""
    import dataclasses

    from .ops.pipeline import BIG, camera_rays, intersect_sphere
    from .ops.render import render

    hard = dataclasses.replace(rcfg, soft_tau=0.0, checker_tau=0.0)
    H, W = rcfg.height, rcfg.width
    with torch.no_grad():
        img = render(scene, hard)
        resid = target.mean(-1) - img.mean(-1)
        like = dict(device=img.device, dtype=torch.float32)
        ii = torch.arange(H, **like)[:, None].expand(H, W)
        jj = torch.arange(W, **like)[None, :].expand(H, W)
        o, d = camera_rays(scene.camera, ii, jj, H, W, rcfg.projection)
        c = scene.spheres.center.T[:, :, None, None]  # (3, N, 1, 1): every sphere at once
        ts = intersect_sphere(o, d, c, scene.spheres.radius[:, None, None])  # (N, H, W)
        tmin, kbest = ts.min(0)  # the first index of the least t
        vis = tmin < BIG * 0.5
        won = vis & (kbest == torch.arange(scene.spheres.count, device=img.device)[:, None, None])
        count = won.sum((1, 2))
        total = (resid.abs() * won).sum((1, 2))
        suspicion = torch.where(count > 0, total / count.clamp(min=1), torch.inf)
    return resid, suspicion


def reseed_pick(resid: np.ndarray, suspicion: np.ndarray, rank: int):
    """``(idx, (py, px))`` on the host, from `restart_attribution`'s results:
    the rank-th suspect in the order of falling suspicion (stable, so the
    spheres nearest nowhere first, ties to the lower index; ``rank`` cycles
    through the spheres) and, for the ``rank // N``-th cycle, that cycle's
    peak of the positive residual under non-maximum suppression (peaks at
    least ``max(2, H // 10)`` pixels apart, ties to the later pixel), so
    successive cycles try distinct unexplained regions."""
    n = suspicion.shape[0]
    H, W = resid.shape
    idx = int(np.argsort(-suspicion, kind="stable")[rank % n])
    cycle = rank // n
    pos = np.clip(resid, 0.0, None)
    r_sup2 = float(max(2, H // 10)) ** 2
    peaks = []
    for p in np.argsort(pos.ravel(), kind="stable")[::-1]:
        py, px = divmod(int(p), W)
        if all((py - a) ** 2 + (px - b) ** 2 > r_sup2 for a, b in peaks):
            peaks.append((py, px))
            if len(peaks) > cycle:
                break
    return idx, peaks[min(cycle, len(peaks) - 1)]


def residual_reseed(start: Scene, spec: ParamSpec, target, rcfg: RenderConfig, rank: int,
                    seed: int, jitter: float) -> Scene:
    """The residual-guided restart proposal (the JAX package's
    `residual_reseed`): move one suspect sphere's center onto the camera ray
    of the brightest unexplained image region, then half-jitter the scene.
    The suspect and the region come from `restart_attribution` (on the
    scene's device, one read back to the host) and `reseed_pick`; the center
    keeps its depth, the blind axis: its distance from the eye under
    perspective, its depth along the view direction under an orthographic
    camera, whose rays start across the image plane. The jitter is
    `models.configs.perturb` at ``0.5 * jitter`` with ``seed``."""
    import dataclasses

    from .models.configs import perturb
    from .ops.pipeline import camera_rays

    resid, suspicion = restart_attribution(start, target, rcfg)
    resid, suspicion = resid.cpu().numpy(), suspicion.cpu().numpy()
    idx, (py, px) = reseed_pick(resid, suspicion, rank)
    center = start.spheres.center.detach().cpu().numpy()[idx]
    eye = start.camera.eye.detach().cpu().numpy()
    if rcfg.projection == "orthographic":
        fwd = start.camera.look_at.detach().cpu().numpy() - eye
        fwd = fwd / np.linalg.norm(fwd)
        t_keep = float(np.dot(center - eye, fwd))
    else:
        t_keep = float(np.linalg.norm(center - eye))
    dev = start.spheres.center.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    with torch.no_grad():
        o, d = camera_rays(start.camera, f32(py), f32(px), rcfg.height, rcfg.width,
                           rcfg.projection)
        new_c = torch.stack([oc + f32(t_keep) * dc for oc, dc in zip(o, d)])
        centers = start.spheres.center.clone()
        centers[idx] = new_c
    out = dataclasses.replace(start, spheres=dataclasses.replace(start.spheres, center=centers))
    return perturb(out, spec, scale=0.5 * jitter, seed=seed)


RESTART_PROPOSALS = ("jitter", "per_sphere", "swap", "swap_jitter", "mixed", "resid")


def propose_restart(start: Scene, spec: ParamSpec, r: int, jitter: float, seed: int,
                    proposal: str = "jitter", target=None, rcfg: RenderConfig | None = None
                    ) -> Scene:
    """The starting point of restart ``r`` (the JAX package's
    `propose_restart`); restart 0 is ``start`` itself. The families:

    - ``"jitter"``: every trainable leaf re-perturbed by ``jitter`` with
      seed ``seed + r``;
    - ``"per_sphere"``: only sphere ``(r - 1) % N`` re-jittered, the kick
      growing by ``jitter`` each full cycle;
    - ``"swap"``: the centers of pair ``(r - 1) % C(N, 2)`` of a fixed
      enumeration exchanged, with no draw;
    - ``"swap_jitter"``: the same swap, then every trainable leaf at half
      the jitter;
    - ``"mixed"``: swap on odd ``r``, per_sphere on even;
    - ``"resid"``: `residual_reseed` of suspect ``r - 1`` (needs ``target``
      and ``rcfg``).

    A scene without spheres takes ``"jitter"`` whatever the family, and a
    swap in a one-sphere scene re-kicks sphere 0."""
    from itertools import combinations

    from .models.configs import perturb

    if r == 0:
        return start
    if proposal == "jitter":
        return perturb(start, spec, scale=jitter, seed=seed + r)
    n = start.spheres.count
    if n == 0:
        return perturb(start, spec, scale=jitter, seed=seed + r)
    if proposal == "resid":
        if target is None or rcfg is None:
            raise ValueError("proposal='resid' needs target and rcfg")
        return residual_reseed(start, spec, target, rcfg, r - 1, seed + r, jitter)
    if proposal in ("swap", "swap_jitter") or (proposal == "mixed" and r % 2 == 1):
        k = (r - 1) if proposal != "mixed" else (r - 1) // 2
        pairs = list(combinations(range(n), 2))
        if not pairs:
            return rejitter_one_sphere(start, spec, 0, jitter, seed + r)
        i, j = pairs[k % len(pairs)]
        out = swap_spheres(start, i, j)
        if proposal == "swap_jitter":
            out = perturb(out, spec, scale=0.5 * jitter, seed=seed + r)
        return out
    if proposal in ("per_sphere", "mixed"):
        k = (r - 1) if proposal == "per_sphere" else (r - 2) // 2
        return rejitter_one_sphere(start, spec, k % n, jitter * (1.0 + k // n), seed + r)
    raise ValueError(f"unknown restart proposal {proposal!r}")


def optimize_multistart(start: Scene, target, spec: ParamSpec, rcfg: RenderConfig,
                        ocfg: OptConfig, restarts: int = 4, jitter: float = 0.15, seed: int = 0,
                        optimize_fn=None, proposal: str = "jitter", chain: bool = False,
                        **anneal_kw):
    """Run the inner optimizer from ``restarts`` starting points and keep
    the best final hard loss (the JAX package's `optimize_multistart`): a
    start outside every first-order basin stalls any optimizer, a different
    start can land inside one. Restart 0 runs from ``start``, restart r
    from `propose_restart` of family ``proposal``. Candidates are ranked on
    ``ocfg.loss`` of the hard render (``soft_tau = checker_tau = 0``)
    against ``target``, never on a relaxed stage's loss: one forward launch
    and one read back to the host a restart.

    ``optimize_fn(scene) -> (final_scene, losses)`` overrides the inner
    optimizer, `optimize_annealed` with ``**anneal_kw`` by default, whose
    captured steps every restart replays (`optimize_scan`'s cache). With
    ``chain`` each restart after the first proposes from the best final
    scene so far, so repairs compound (``"resid"`` re-derives its suspects
    from that scene's residual): the proposal index climbs while no restart
    improves and starts again at 1 after one does, the seed is ``seed +
    r``. Returns (best_scene, best_loss, the final loss of each restart)."""
    import dataclasses

    from .ops.render import LOSSES, render

    if optimize_fn is None:
        def optimize_fn(s):
            return optimize_annealed(s, target, spec, rcfg, ocfg, **anneal_kw)

    hard_cfg = dataclasses.replace(rcfg, soft_tau=0.0, checker_tau=0.0)
    lossf = LOSSES[ocfg.loss]

    def eval_loss(s):
        with torch.no_grad():
            return float(lossf(render(s, hard_cfg), target))

    best_scene, best_loss, finals = None, None, []
    stale = 0  # chained: the restarts since the last improvement
    for r in range(restarts):
        if chain and best_scene is not None:
            base, ri, sd = best_scene, stale + 1, seed + r
        else:
            base, ri, sd = start, r, seed
        s0 = propose_restart(base, spec, ri, jitter, sd, proposal, target=target, rcfg=rcfg)
        final, _ = optimize_fn(s0)
        loss = eval_loss(final)
        finals.append(loss)
        if best_loss is None or loss < best_loss:
            best_scene, best_loss = final, loss
            stale = 0
        else:
            stale += 1
    return best_scene, best_loss, finals
