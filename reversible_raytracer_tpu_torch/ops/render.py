"""Full-image renderers, losses and the dispatch between eager torch and
the CUDA kernels.

The counterpart of `reversible_raytracer_tpu.ops.render`. Dispatch is by
the scene's device and object count, not by a backend flag: tensors on the
CPU take an eager twin, tensors on a CUDA device take the hand-written
kernels, and a configuration the kernels do not cover raises on CUDA rather
than running somewhere else. Scenes of at most `VEC_THRESHOLD` objects take
the unrolled family (`kernels.fused`; `render_eager`), larger ones the
object-chunked family (`kernels.fused_vec`; `render_eager_vec`), the JAX
package's threshold. A soft render (``soft_tau > 0``) takes the soft
kernels (`kernels.fused_vec_soft`) on CUDA and the soft branch of
`render_eager_vec` on the CPU, whatever the object count, with the soft
checker (``checker_tau > 0``) or without. The checker-only relaxation
(``soft_tau == 0``, ``checker_tau > 0``) has no kernel here, as it has none
in the JAX package (whose TPU dispatch sends it to `render_jnp_vec`): it
runs `render_eager_vec` on either device. Every kernel family renders spp
1 and 4; the training step of a spp-4 soft render has no kernel, as in the
JAX package (whose `loss_and_grad_fn` sends it to ``"vag"``), and is
autograd of `render` (`loss_and_grad_fn`). Mirror reflections (1 to
`fused.MAX_REFLECTIONS` = 3 bounce levels, spp 1 or 4) take either hard
family on CUDA by the object count, as the JAX package's render.py:116-128
sends them: the unrolled kernels' REFL instances up to 24 objects, the
object-chunked kernels' bounce instances past it (config 10, config 5 with
``--reflections K``); more levels are refused there by name, and render on
the CPU through both eager twins.
Object textures and the environment map (configs 7-9, at spp 1 or 4)
take the unrolled kernels' textured instances on CUDA up to 24 objects, as
the JAX package's render.py:45-138 sends a textured scene of at most 24
objects to its unrolled kernels, and `render_eager` on the CPU; past 24
objects, and object textures with a bounce at any object count (which the
unrolled kernels refuse, as the JAX package's do: render.py:108-111), the
object-chunked kernels' textured, env and bounce instances
(`render_eager_vec` on the CPU), as the JAX package's render.py:95-115 sends
them to its vec kernels. The JAX package sends a textured scene of at most
24 objects by `tile_object_count`, a budget of the TPU's VMEM; the port
keeps the object count, as for every other scene. A soft render of a
textured or sky-lit scene (the hard checker, no bounce) takes the
soft kernels' texel instances on CUDA at any object count, as the JAX
package's render.py:51-69 sends it to its soft kernels, and the soft branch
of `render_eager_vec` on the CPU. Each of these takes spp 4 as it takes
spp 1 (the JAX package's products of spp 4 with textures and with
reflections), the soft step apart. More than three bounces are refused by
name on CUDA, and so are, in a soft render, a bounce or the soft checker beside a texel
grid, and the soft step at spp 4.
"""

from __future__ import annotations

import torch

from .kernels import fused, fused_vec, fused_vec_soft
from .pipeline import RenderConfig, band_config, render_tile
from .pipeline_vec import render_eager_vec

VEC_THRESHOLD = fused.MAX_OBJECTS  # 24, as render.py:137 of the JAX package


def render_eager(scene, cfg: RenderConfig, row0=0, out_height: int | None = None):
    """Render the image, or its band of ``out_height`` rows from ``row0``
    (`band_config`; the JAX package's ``row0`` / ``height``), in eager torch
    (the twin of `render_jnp`). Returns (rows, W, 3) in the scene's dtype."""
    cfg = band_config(cfg, row0, out_height)
    r, g, b = render_tile(scene, cfg, cfg.row0, 0, cfg.height, cfg.width)
    return torch.stack([r, g, b], dim=-1)


def resolve_impl(scene, cfg: RenderConfig) -> str:
    """``"cuda"`` / ``"cuda_vec"`` for a scene on a CUDA device whose
    configuration the kernels cover, ``"eager"`` / ``"eager_vec"`` on the
    CPU, by object count; ``"cuda_vec_soft"`` / ``"eager_vec"`` for
    ``soft_tau > 0``, with any ``checker_tau``; ``"eager_vec"`` on either
    device for the checker-only relaxation (``soft_tau == 0``,
    ``checker_tau > 0``), as the JAX package's render.py:51-64 decides; a
    textured or env-mapped scene of at most 24 objects is ``"cuda"`` (rows
    1-3's textured instances) but with object textures and a bounce
    ``"cuda_vec"``; a textured, env-mapped and/or reflective one (1 to 3
    bounces) of more than 24 ``"cuda_vec"`` (rows 4-6's textured, env and
    bounce instances); a soft render of a textured or env-mapped scene
    ``"cuda_vec_soft"`` (rows 7-9's texel instances) at any count; each at
    spp 1 or 4, the same route at either; the CPU takes the same family's
    eager twin; raises otherwise, by name."""
    soft = cfg.soft_tau > 0.0
    checker_only = not soft and cfg.checker_tau > 0.0
    vec = (soft or checker_only or scene.spheres.count + scene.rects.count > VEC_THRESHOLD
           or (cfg.reflections > 0 and fused_vec.object_textured(scene)))
    dev = scene.device
    if dev.type == "cpu" or (checker_only and dev.type == "cuda"):
        return "eager_vec" if vec else "eager"
    if dev.type == "cuda":
        if soft:
            fused_vec_soft.check_soft_kernel_config(scene, cfg)
            return "cuda_vec_soft"
        if vec:
            fused_vec.check_vec_kernel_config(scene, cfg)
            return "cuda_vec"
        fused.check_kernel_config(scene, cfg)
        return "cuda"
    raise NotImplementedError(f"no renderer for device {dev}")


def resolve_step_impl(scene_like, cfg: RenderConfig, loss: str = "mse") -> str:
    """The training-step counterpart of `resolve_impl`: a fused step kernel
    on CUDA, autograd over the eager renderer on the CPU."""
    if loss not in LOSSES:
        raise ValueError(f"unknown loss {loss!r}")
    return resolve_impl(scene_like, cfg)


_RENDER = {"cuda": lambda s, c: fused.render_fused(s, c)[0],
           "cuda_vec": lambda s, c: fused_vec.render_vec(s, c)[0],
           "cuda_vec_soft": fused_vec_soft.render_vec_soft,
           "eager": render_eager, "eager_vec": render_eager_vec}


def render(scene, cfg: RenderConfig, row0=0, out_height: int | None = None):
    """Render the (H, W, 3) image, or its band of ``out_height`` rows from
    ``row0`` (`band_config`): a forward kernel on CUDA, an eager twin on the
    CPU (`resolve_impl`). The image is differentiable in the
    scene's leaves on both, as the JAX package's `render` is on every
    backend: on CUDA its backward is one launch of the family's render
    backward kernel (`fused._FusedRender`, `fused_vec._VecRender`,
    `fused_vec_soft._SoftRender`)."""
    cfg = band_config(cfg, row0, out_height)
    return _RENDER[resolve_impl(scene, cfg)](scene, cfg)


def loss_and_grad_fn(scene_like, cfg: RenderConfig, loss: str = "mse", row0=0,
                     out_height: int | None = None):
    """``f(scene, target) -> (loss, grads)``, of the band of ``out_height``
    rows from ``row0`` if given (``target`` the band's; the loss scaled by
    the whole image's normalization, so that the bands' sums are the whole
    image's: the JAX package's ``_band_vag_fn``): one fused step kernel call per
    call on CUDA (rows 1, 6 and 9; rows 1 and 6 at spp 1 and 4), torch
    autograd over the eager renderer on the CPU (and on either device for
    the checker-only relaxation, `resolve_impl`). A soft step (``soft_tau >
    0``) at spp 4 is torch autograd of `render` on either device: on CUDA
    four launches of the soft forward and four of its render backward
    (rows 7 and 8), as the JAX package's value_and_grad over its four-launch
    render (optim.py:822-839)."""
    cfg = band_config(cfg, row0, out_height)
    impl = resolve_step_impl(scene_like, cfg, loss)
    if cfg.soft_tau == 0.0 and cfg.checker_tau > 0.0:
        return lambda scene, target: fused.autograd_loss_grad(render_eager_vec, scene, cfg,
                                                              target, loss)
    if cfg.soft_tau > 0.0 and cfg.spp != 1:
        return lambda scene, target: fused.autograd_loss_grad(render, scene, cfg, target, loss)
    if cfg.soft_tau > 0.0:
        step = fused_vec_soft.loss_grad_vec_soft
    else:
        step = fused_vec.loss_grad_vec if impl.endswith("_vec") else fused.loss_grad_fused
    return lambda scene, target: step(scene, cfg, target, loss=loss)


def autograd_loss_and_grad_fn(render_fn, cfg: RenderConfig, loss: str = "mse"):
    """``f(scene, target) -> (loss, grads)`` by torch autograd of the loss
    over ``render_fn(scene)``, the JAX package's `make_step` route: with
    `render` on CUDA, one forward and one render backward launch per call."""
    return lambda scene, target: fused.autograd_loss_grad(lambda s, _cfg: render_fn(s), scene,
                                                          cfg, target, loss)


def mse_loss(image, target):
    """Mean squared error over pixels and channels."""
    diff = image - target
    return torch.mean(diff * diff)


def sum_squared_loss(image, target):
    """Sum of squared errors (the reference's loss)."""
    diff = image - target
    return torch.sum(diff * diff)


LOSSES = {"mse": mse_loss, "sum": sum_squared_loss}
