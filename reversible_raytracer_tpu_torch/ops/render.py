"""Full-image renderers, losses and the dispatch between eager torch and
the CUDA kernels.

The counterpart of `reversible_raytracer_tpu.ops.render`. Dispatch is by
the scene's device, not by a backend flag: tensors on the CPU take the
eager twin, tensors on a CUDA device take the hand-written kernels, and a
configuration the kernels do not cover raises on CUDA rather than running
somewhere else.
"""

from __future__ import annotations

import torch

from .kernels import fused
from .pipeline import RenderConfig, render_tile


def render_eager(scene, cfg: RenderConfig):
    """Render the full image in eager torch (the twin of `render_jnp`).
    Returns (H, W, 3) in the scene's dtype."""
    r, g, b = render_tile(scene, cfg, 0, 0, cfg.height, cfg.width)
    return torch.stack([r, g, b], dim=-1)


def resolve_impl(scene, cfg: RenderConfig) -> str:
    """``"cuda"`` for a scene on a CUDA device whose configuration the
    kernels cover, ``"eager"`` on the CPU; raises otherwise."""
    dev = scene.device
    if dev.type == "cpu":
        return "eager"
    if dev.type == "cuda":
        fused.check_kernel_config(scene, cfg)
        return "cuda"
    raise NotImplementedError(f"no renderer for device {dev}")


def resolve_step_impl(scene_like, cfg: RenderConfig, loss: str = "mse") -> str:
    """The training-step counterpart of `resolve_impl`: the fused step
    kernel on CUDA, autograd over the eager renderer on the CPU."""
    if loss not in LOSSES:
        raise ValueError(f"unknown loss {loss!r}")
    return resolve_impl(scene_like, cfg)


def render(scene, cfg: RenderConfig):
    """Render the full (H, W, 3) image: the forward kernel on CUDA, the
    eager twin on the CPU (`resolve_impl`)."""
    if resolve_impl(scene, cfg) == "cuda":
        return fused.render_fused(scene, cfg)[0]
    return render_eager(scene, cfg)


def loss_and_grad_fn(scene_like, cfg: RenderConfig, loss: str = "mse"):
    """``f(scene, target) -> (loss, grads)``: one fused step kernel launch
    per call on CUDA, torch autograd over `render_eager` on the CPU."""
    resolve_step_impl(scene_like, cfg, loss)
    return lambda scene, target: fused.loss_grad_fused(scene, cfg, target, loss=loss)


def mse_loss(image, target):
    """Mean squared error over pixels and channels."""
    diff = image - target
    return torch.mean(diff * diff)


def sum_squared_loss(image, target):
    """Sum of squared errors (the reference's loss)."""
    diff = image - target
    return torch.sum(diff * diff)


LOSSES = {"mse": mse_loss, "sum": sum_squared_loss}
