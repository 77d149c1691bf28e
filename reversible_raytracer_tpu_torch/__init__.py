"""PyTorch + CUDA port of reversible_raytracer_tpu: differentiable hard-shaded
raytracing and inverse rendering, with hand-written CUDA kernels for the
forward render and the fused training step (sm_90a, built on first use).

Everything runs on ``cuda`` unless ``device="cpu"`` is passed, where the
eager torch twin of each kernel runs instead.
"""

from .models.configs import CONFIGS, perturb
from .models.scene import ParamSpec, Scene
from .ops.pipeline import RenderConfig
from .ops.render import loss_and_grad_fn, render, render_eager
from .optim import OptConfig, optimize, param_error

__all__ = [
    "CONFIGS",
    "OptConfig",
    "ParamSpec",
    "RenderConfig",
    "Scene",
    "loss_and_grad_fn",
    "optimize",
    "param_error",
    "perturb",
    "render",
    "render_eager",
]
