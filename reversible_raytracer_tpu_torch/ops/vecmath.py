"""Structure-of-arrays 3-vector math on torch tensors.

A Vec3 is a tuple ``(x, y, z)`` of broadcastable tensors: scene rows splat
into 0-d tensors that broadcast against (H, W) pixel tensors. The guarded
helpers keep the JAX package's gradient conventions, which the hand-written
CUDA adjoints reproduce:

- `safe_sqrt` takes sqrt(1) on the dead branch, so its gradient there is 0;
- `safe_pow` is exp(p * log x) with zero value and zero gradient at x <= 0,
  and its exponent capped at `POW_LOG_MAX` (the JAX package's overflows);
- `vmax0` / `clip01` / `clip` split the gradient 0.5/0.5 at a tie, as
  ``jnp.maximum``/``jnp.clip`` do (``torch.clamp`` would pass all of it);
- `atan2` and `asin` are the JAX package's polynomial versions, op for op
  (the lat-long texture coordinates, `pipeline.sphere_uv`).
"""

from __future__ import annotations

import math

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


# safe_pow's exponent p log x is capped here (x ** p <= e^64, about 6e27).
# Of unit vectors the Phong term's x is at most 1 and the cap never binds;
# past a near-tangent hit a bounce level's normal and reflected ray lose
# their unit length, x ** p can overflow, and the zero cotangent of a
# clipped pixel times that infinity would be NaN in the gradient.
POW_LOG_MAX = 64.0


def safe_pow(x, p):
    """x ** p as exp(p * log x), with zero value and gradient at x <= 0,
    and e^POW_LOG_MAX with zero gradient where p log x reaches it."""
    pos = x > 0.0
    safe_x = torch.where(pos, x, 1.0)
    z = p * torch.log(safe_x)
    return torch.where(pos, torch.exp(torch.where(z < POW_LOG_MAX, z, POW_LOG_MAX)), 0.0)


def vmax0(x):
    """max(x, 0) with the tie split of ``jnp.maximum``."""
    return torch.maximum(x, torch.zeros_like(x))


def clip01(x):
    """``jnp.clip(x, 0, 1)``: maximum then minimum, ties split."""
    return torch.minimum(torch.maximum(x, torch.zeros_like(x)), torch.ones_like(x))


def maxgrad(x):
    """d `vmax0`(x) / dx: 1 above 0, 0.5 at the tie, 0 below (the hand-written
    adjoints' form of autograd's)."""
    return torch.where(x > 0.0, 1.0, torch.where(x == 0.0, 0.5, 0.0))


def clip01_grad(x):
    """d `clip01`(x) / dx: maximum, then minimum, each tie split."""
    m = torch.clamp_min(x, 0.0)
    return maxgrad(x) * torch.where(m < 1.0, 1.0, torch.where(m == 1.0, 0.5, 0.0))


def clip(x, lo: float, hi: float):
    """``jnp.clip(x, lo, hi)``: maximum then minimum, ties split."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)), torch.full_like(x, hi))


# Cephes atanf minimax coefficients for atan(r), r in [0, 1] after the
# tan(pi/8) fold: atan(r) ~= r + r^3 P(r^2), 1-2 ulp in float32 (the JAX
# package's vecmath.py:120-125).
_ATAN_P = (8.05374449538e-2, -1.38776856032e-1, 1.99777106478e-1, -3.33329491539e-1)
_TAN_PI_8 = 0.4142135623730951


def _atan_01(r):
    """atan of r in [0, 1]: above tan(pi/8) atan(r) = pi/4 + atan((r - 1) /
    (r + 1)), then the odd polynomial (JAX vecmath.py:128-141, op for op;
    its derivative is the polynomial's, not 1 / (1 + r^2))."""
    fold = r > _TAN_PI_8
    x = torch.where(fold, (r - 1.0) / (r + 1.0), r)
    z = x * x
    p = _ATAN_P[0]
    for c in _ATAN_P[1:]:
        p = p * z + c
    y = p * z * x + x
    return torch.where(fold, y + math.pi / 4, y)


def atan2(y, x):
    """The JAX package's branchless atan2 (vecmath.py:144-170), op for op:
    ``_atan_01`` of min / max of |x| and |y| over a guarded denominator (no
    inf or NaN in either branch of a where), then the swap, the sign of x and
    the sign of y unfolded. atan2(0, 0) = 0; the final select compares ``y <
    0``, so atan2(-0.0, x < 0) is +pi (torch.atan2 gives -pi)."""
    ax, ay = torch.abs(x), torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    a = _atan_01(lo / torch.where(hi > 0.0, hi, 1.0))
    a = torch.where(ay > ax, math.pi / 2 - a, a)
    a = torch.where(x < 0.0, math.pi - a, a)
    return torch.where(y < 0.0, -a, a)


def asin(t):
    """arcsin as atan2(t, sqrt((1 - t)(1 + t))) with the guarded sqrt (JAX
    vecmath.py:173-180); callers keep |t| below 1."""
    return atan2(t, safe_sqrt((1.0 - t) * (1.0 + t), guard=1.0))
