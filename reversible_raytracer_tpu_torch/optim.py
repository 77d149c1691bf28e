"""Inverse rendering: Adam or SGD with box projection over the scene's
trainable leaves, and the annealed inversion.

The counterpart of `reversible_raytracer_tpu.optim` for the loops the CLI
runs (`optimize`, and `optimize_annealed` through it). The update is the
JAX package's flat update (`make_flat_update`): the trainable leaves
raveled into one vector, optax's Adam written out (bias correction,
``eps`` outside the square root) or plain SGD, the ``lr_scales``
multipliers and then the learning rate, in that order, and a clip to the
box bounds. ``torch.optim`` rounds differently and
is not used.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

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
    # (("spheres.radius", 0.3), ...): per-leaf multipliers applied after
    # the optimizer and before the learning rate; the first matching path wins.
    lr_scales: tuple = ()

    def learning_rate(self, count: int, device) -> torch.Tensor:
        """The learning rate of update number ``count`` (0-based), as a
        float32 scalar like optax's schedules compute it."""
        if self.schedule == "constant":
            return torch.tensor(self.lr, dtype=torch.float32, device=device)
        if self.schedule == "cosine":
            steps = float(max(self.iters, 1))
            c = torch.tensor(min(float(count), steps), dtype=torch.float32, device=device)
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


def make_flat_update(template: Scene, spec: ParamSpec, ocfg: OptConfig):
    """``(init, apply)`` for the update on one flat vector of the trainable
    leaves: ``init(scene) -> state`` and ``apply(scene, state, grads) ->
    (scene, state, grad_norm)``. Untrainable leaves pass through as they
    are."""
    tflags = [bool(t) for t in tree_leaves(spec.trainable)]
    if not any(tflags):
        raise ValueError("no trainable leaves")
    leaves = tree_leaves(template)
    dev = leaves[0].device

    def ravel_t(tree):
        return torch.cat([l.reshape(-1) for l, f in zip(tree_leaves(tree), tflags) if f])

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

    def init(scene):
        z = torch.zeros_like(ravel_t(scene))
        return {"count": 0, "mu": z, "nu": z.clone()}

    def apply(scene, state, grads):
        g = ravel_t(grads)
        gnorm = torch.sqrt(torch.sum(g * g))
        b1, b2 = ocfg.b1, ocfg.b2
        count = state["count"] + 1
        mu, nu = state["mu"], state["nu"]
        if ocfg.optimizer == "sgd":
            u = g
        else:
            mu = (1 - b1) * g + b1 * mu
            nu = (1 - b2) * (g * g) + b2 * nu
            c = torch.tensor(count, dtype=torch.float32, device=dev)
            mu_hat = mu / (1 - torch.tensor(b1, dtype=torch.float32, device=dev) ** c)
            nu_hat = nu / (1 - torch.tensor(b2, dtype=torch.float32, device=dev) ** c)
            u = mu_hat / (torch.sqrt(nu_hat) + ocfg.eps)
        if scale is not None:
            u = u * scale
        u = u * -ocfg.learning_rate(state["count"], dev)
        flat = torch.minimum(torch.maximum(ravel_t(scene) + u, lo), hi)
        out, off = [], 0
        for leaf, f in zip(tree_leaves(scene), tflags):
            if f:
                out.append(flat[off:off + leaf.numel()].reshape(leaf.shape))
                off += leaf.numel()
            else:
                out.append(leaf)
        return tree_unflatten(scene, out), {"count": count, "mu": mu, "nu": nu}, gnorm

    return init, apply


def optimize(scene: Scene, target, spec: ParamSpec, rcfg: RenderConfig, ocfg: OptConfig,
             vag_fn=None, logger=None, log_every: int = 10, truth: Scene | None = None,
             render_fn=None):
    """Host-driven optimization loop. ``vag_fn(scene, target) -> (loss,
    grads)`` defaults to `ops.render.loss_and_grad_fn` (the fused step
    kernel on CUDA). Given ``render_fn(scene) -> (H, W, 3)`` and no
    ``vag_fn``, each step is torch autograd of ``ocfg.loss`` over it, as
    the JAX package's `make_step` takes ``jax.value_and_grad`` (with
    `ops.render.render` on CUDA: the forward and the render backward
    kernels). Each step's loss (before that step's update) goes into a
    device tensor; only the steps logged every ``log_every`` (0: none)
    wait for the device. Returns (final_scene, history, losses[iters]),
    where history holds the logged steps' loss and grad norm."""
    if vag_fn is None:
        from .ops.render import autograd_loss_and_grad_fn, loss_and_grad_fn

        vag_fn = (loss_and_grad_fn(scene, rcfg, loss=ocfg.loss) if render_fn is None
                  else autograd_loss_and_grad_fn(render_fn, rcfg, loss=ocfg.loss))
    init, apply = make_flat_update(scene, spec, ocfg)
    state = init(scene)
    history = []
    losses = torch.empty((ocfg.iters,), dtype=torch.float32, device=target.device)
    for it in range(ocfg.iters):
        loss, grads = vag_fn(scene, target)
        losses[it] = loss
        scene, state, gnorm = apply(scene, state, mask_grads(grads, spec))
        if log_every and (it % log_every == 0 or it == ocfg.iters - 1):
            rec = {"step": it, "loss": float(loss), "grad_norm": float(gnorm)}
            if truth is not None:
                rec["param_err"] = float(param_error(scene, truth, spec))
            history.append(rec)
            if logger is not None:
                logger.log(**rec)
    return scene, history, losses


def param_error(scene: Scene, truth: Scene, spec: ParamSpec):
    """RMS error over the trainable parameters against the ground truth."""
    sq, count = 0.0, 0
    for a, b, t in zip(tree_leaves(scene), tree_leaves(truth), tree_leaves(spec.trainable)):
        if t:
            sq = sq + torch.sum((a - b) ** 2)
            count += a.numel()
    return torch.sqrt(sq / max(count, 1))


def optimize_annealed(scene: Scene, target, spec: ParamSpec, rcfg: RenderConfig,
                      ocfg: OptConfig, taus=(0.08, 0.03, 0.01, 0.0),
                      target_scene: Scene | None = None, soft_size: int | None = None):
    """Soft-visibility annealing for the joint geometry inversion (the JAX
    package's `optimize_annealed`): ``ocfg.iters`` steps per tau stage with
    ``soft_tau = tau``, each stage warm-started from the last, through
    `ops.render`'s dispatch (on CUDA the soft kernels for tau > 0 and the
    hard ones for tau = 0). With ``target_scene`` each soft stage's target
    is the truth rendered at that stage's tau (and at ``soft_size``, if
    given); the tau = 0 stage runs against ``target``. Returns
    (final_scene, losses[len(taus) * iters]) on the scene's device."""
    import dataclasses

    from .ops.render import render

    if soft_size is not None and target_scene is None:
        raise ValueError("soft_size requires target_scene (stage targets are re-rendered)")
    # The tau = 0 polish is plain SGD at lr 0.3: from the soft stages'
    # near-optimum Adam's normalized steps random-walk, where SGD's follow
    # the true, tiny gradients.
    hard_ocfg = dataclasses.replace(ocfg, optimizer="sgd", lr=0.3)
    all_losses = []
    for tau in taus:
        cfg_t = dataclasses.replace(rcfg, soft_tau=float(tau))
        if tau > 0.0 and soft_size is not None:
            cfg_t = dataclasses.replace(cfg_t, height=soft_size, width=soft_size)
        tgt = target
        if target_scene is not None and tau > 0.0:
            tgt = render(target_scene, cfg_t)
        scene, _, losses = optimize(scene, tgt, spec, cfg_t, ocfg if tau > 0.0 else hard_ocfg,
                                    log_every=0)
        all_losses.append(losses)
    return scene, torch.cat(all_losses)
