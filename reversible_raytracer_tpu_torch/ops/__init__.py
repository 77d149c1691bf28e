from .pipeline import RenderConfig
from .render import loss_and_grad_fn, render, render_eager

__all__ = ["RenderConfig", "loss_and_grad_fn", "render", "render_eager"]
