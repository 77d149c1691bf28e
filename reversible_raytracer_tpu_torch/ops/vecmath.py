"""Structure-of-arrays 3-vector math on torch tensors.

A Vec3 is a tuple ``(x, y, z)`` of broadcastable tensors: scene rows splat
into 0-d tensors that broadcast against (H, W) pixel tensors. The guarded
helpers keep the JAX package's gradient conventions, which the hand-written
CUDA adjoints reproduce:

- `safe_sqrt` takes sqrt(1) on the dead branch, so its gradient there is 0;
- `safe_pow` is exp(p * log x) with zero value and zero gradient at x <= 0;
- `vmax0` / `clip01` split the gradient 0.5/0.5 at a tie, as
  ``jnp.maximum``/``jnp.clip`` do (``torch.clamp`` would pass all of it).
"""

from __future__ import annotations

import torch

Vec3 = tuple  # (x, y, z) of tensors


def splat(v) -> Vec3:
    """A length-3 row -> Vec3 of 0-d tensors."""
    return (v[0], v[1], v[2])


def vadd(a: Vec3, b: Vec3) -> Vec3:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def vsub(a: Vec3, b: Vec3) -> Vec3:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vscale(a: Vec3, s) -> Vec3:
    return (a[0] * s, a[1] * s, a[2] * s)


def vmul(a: Vec3, b: Vec3) -> Vec3:
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def vneg(a: Vec3) -> Vec3:
    return (-a[0], -a[1], -a[2])


def vdot(a: Vec3, b: Vec3):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vcross(a: Vec3, b: Vec3) -> Vec3:
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def vnorm(a: Vec3):
    return torch.sqrt(vdot(a, a))


def vnormalize(a: Vec3, eps: float = 1e-12) -> Vec3:
    """Normalize with a guarded rsqrt (no NaN cotangent at a zero vector)."""
    n2 = vdot(a, a)
    inv = torch.rsqrt(torch.where(n2 > eps, n2, 1.0))
    return vscale(a, inv)


def vwhere(mask, a: Vec3, b: Vec3) -> Vec3:
    return tuple(torch.where(mask, x, y) for x, y in zip(a, b))


def vbroadcast(a: Vec3, shape) -> Vec3:
    return tuple(torch.broadcast_to(x, shape) for x in a)


def safe_sqrt(x, guard: float = 1.0):
    """``sqrt(where(x > 0, x, guard))``: NaN-free reverse mode at x <= 0."""
    return torch.sqrt(torch.where(x > 0.0, x, guard))


def safe_pow(x, p):
    """x ** p as exp(p * log x), with zero value and gradient at x <= 0."""
    pos = x > 0.0
    safe_x = torch.where(pos, x, 1.0)
    return torch.where(pos, torch.exp(p * torch.log(safe_x)), 0.0)


def vmax0(x):
    """max(x, 0) with the tie split of ``jnp.maximum``."""
    return torch.maximum(x, torch.zeros_like(x))


def clip01(x):
    """``jnp.clip(x, 0, 1)``: maximum then minimum, ties split."""
    return torch.minimum(torch.maximum(x, torch.zeros_like(x)), torch.ones_like(x))
