"""The per-warp culls of the kernels (``csrc/cull.cuh``) in eager torch.

A warp of the kernels is 32 pixels of one image row (a run below; the last
run of a row is padded with dead lanes). Each kernel's warp tests the
spheres 32 at a time against a bound of all its live lanes' rays and walks
only the candidates. The functions here are the plain versions of those
tests, with the kernels' constants and arithmetic; they return (H, R, N)
bool candidates for R = ceil(W / 32) runs per row and N spheres, nothing
for a run without a live pixel. `per_pixel` spreads them to (N, H, W).

- `warp_candidates`: the shadow rays of a run toward one light (rows 4-6's
  hard any-hit at tau = 0; rows 7-9's soft shadow products at tau > 0);
- `primary_candidates`: the primary rays of a run, which all leave the eye
  (rows 4-6's nearest hit at tau = 0; row 7's soft ranking at tau > 0);
- `bounce_candidates`: the reflected rays of a run, which leave scattered
  points. No kernel walks it yet (rows 4-6 walk every sphere at level 1);
  the bounds of rows 4-6 with a bounce count level 1's sphere tests by it.
"""

from __future__ import annotations

import torch

# The soft shadow cull: a sphere whose shadow-ray coverage x = disc / (tau
# r^2) lies below -SOFT_CULL has sigmoid(x) under half an ulp below 1 in the
# dtype, so its factor 1 - alpha is exactly 1 and it is dropped, with its
# adjoint (each such term is under 2^-25 of its cotangent in float32, as the
# TPU kernel's chunk skip drops them). float32 is the kernels' threshold.
SOFT_CULL = {torch.float32: 18.0, torch.float64: 38.0}
# The per-warp tests' allowance for float32 rounding: relative, and in
# proportion to the distances rounded over (the constants of csrc/cull.cuh,
# as SOFT_CULL's float32 entry is).
CULL_REL, CULL_ABS = 1e-3, 2e-3
WARP = 32


def runs(x, fill):
    """(H, W) -> (H, ceil(W / 32), 32): each row cut into warps of 32
    pixels, the last padded with ``fill``."""
    H, W = x.shape
    return torch.nn.functional.pad(x, (0, -W % WARP), value=fill).reshape(H, -1, WARP)


def per_pixel(cand, width: int):
    """(H, R, N) candidates of runs -> (N, H, W) candidates of pixels."""
    return cand.repeat_interleave(WARP, dim=1)[:, :width].permute(2, 0, 1)


def warp_candidates(spheres, so, live, lpos, tau):
    """The spheres each run of 32 pixels of a row (one warp of the kernels)
    visits for one light, by the kernels' conservative test: the live
    pixels' shadow origins lie in a ball (centre c_w, the midpoint of their
    box; radius rho, the farthest from it), so every shadow segment [so,
    light] lies within rho of [c_w, light]; sphere k is a candidate if its
    centre lies within (R_k + rho)(1 + CULL_REL) + CULL_ABS (|c_k - c_w| +
    rho + |light - c_w|) of that segment, R_k = r_k sqrt(1 + SOFT_CULL tau)
    (R_k = r_k at tau = 0, the hard any-hit's reach). ``so`` is a Vec3 of
    (H, W) tensors, ``live`` (H, W) bool, ``lpos`` (3,). Returns (H, ceil(W
    / 32), N) bool."""
    lv = runs(live, False)
    xyz = torch.stack([runs(x, 0.0) for x in so], dim=-1)  # (H, R, 32, 3)
    inf = torch.tensor(float("inf"), dtype=xyz.dtype, device=xyz.device)
    lo = torch.where(lv[..., None], xyz, inf).amin(2)
    hi = torch.where(lv[..., None], xyz, -inf).amax(2)
    cw = torch.where(lv.any(2)[..., None], (lo + hi) * 0.5, 0.0)  # (H, R, 3)
    off = xyz - cw[:, :, None]
    rho = torch.sqrt(torch.where(lv, (off * off).sum(-1), 0.0).amax(2))  # (H, R)
    u = lpos - cw
    len2 = (u * u).sum(-1)
    w = spheres.center[:, None, None] - cw  # (N, H, R, 3)
    s = torch.clamp((w * u).sum(-1) / torch.where(len2 > 0.0, len2, 1.0), 0.0, 1.0)
    q = w - u * s[..., None]
    R = spheres.radius[:, None, None] * (1.0 + SOFT_CULL[torch.float32] * tau) ** 0.5
    lim = ((R + rho) * (1.0 + CULL_REL)
           + CULL_ABS * (torch.sqrt((w * w).sum(-1)) + rho + torch.sqrt(len2)))
    return (((q * q).sum(-1) <= lim * lim) & lv.any(2)).permute(1, 2, 0)


def primary_candidates(spheres, eye, d, tau=0.0):
    """The spheres each run of 32 pixels of a row visits for its primary
    rays, by the kernels' cone test: the live pixels' unit directions ``d``
    (a Vec3 of (H, W) tensors) lie within theta of their normalized sum a
    (cos theta the least d . a, sin theta the largest |d x a|), and a sphere
    at the angle gamma from a, D = |c - eye| away, is a candidate if gamma <=
    theta + asin(r' / D), r' = R (1 + CULL_REL) + CULL_ABS D, R = r sqrt(1 +
    SOFT_CULL tau); so are the spheres with r' >= D (holding the eye) and
    every sphere of a run whose cone reaches 90 degrees. At tau = 0, R = r,
    the reach of a hard ray (rows 4-6); at tau > 0 it covers the soft
    ranking's r sqrt(1 + 6.91 tau) (row 7). Every pixel of the image is
    live; the padding of a row's last run is not. Returns (H, ceil(W / 32),
    N) bool."""
    lv = runs(torch.ones_like(d[0], dtype=torch.bool), False)
    dd = torch.stack([runs(x, 0.0) for x in d], dim=-1)  # (H, R, 32, 3)
    s = torch.where(lv[..., None], dd, 0.0).sum(2)
    a = s * torch.rsqrt((s * s).sum(-1, keepdim=True))  # (H, R, 3)
    cmin = torch.where(lv, (dd * a[:, :, None]).sum(-1), 1.0).amin(2)
    x = torch.linalg.cross(dd, a[:, :, None].expand_as(dd), dim=-1)
    smax = torch.sqrt(torch.where(lv, (x * x).sum(-1), 0.0).amax(2))
    wc = spheres.center - eye  # (N, 3)
    D2 = (wc * wc).sum(-1)
    D = torch.sqrt(D2)
    r = (spheres.radius * (1.0 + SOFT_CULL[torch.float32] * tau) ** 0.5 * (1.0 + CULL_REL)
         + CULL_ABS * D)
    reach = cmin[..., None] * torch.sqrt(torch.clamp(D2 - r * r, min=0.0)) - smax[..., None] * r
    return ((~(cmin > 0.0))[..., None] | (r >= D)
            | ((a[:, :, None] * wc).sum(-1) >= reach))


def bounce_candidates(spheres, o, d, live):
    """The spheres each run of 32 pixels of a row could hit with rays that
    leave scattered points, as a bounce's reflected rays do: the live pixels'
    origins ``o`` lie in a ball (centre c_w, the midpoint of their box;
    radius rho, the farthest from it) and their unit directions ``d`` within
    theta of their normalized sum a (cos theta the least d . a, sin theta the
    largest |d x a|). A ray o + t d hitting sphere k passes within r_k of its
    centre, so c_w + t d passes within r_k + rho of it: the sphere is a
    candidate if the cone from c_w about a reaches that far, gamma <= theta +
    asin(r' / D) as in `primary_candidates` with D = |c_k - c_w| and r' =
    (r_k + rho)(1 + CULL_REL) + CULL_ABS (D + rho); so are the spheres with
    r' >= D and every sphere of a run whose cone reaches 90 degrees. ``o``
    and ``d`` are Vec3s of (H, W) tensors, ``live`` (H, W) bool. Returns (H,
    ceil(W / 32), N) bool, nothing for a run without a live pixel."""
    lv = runs(live, False)
    xyz = torch.stack([runs(x, 0.0) for x in o], dim=-1)  # (H, R, 32, 3)
    dd = torch.stack([runs(x, 0.0) for x in d], dim=-1)
    inf = torch.tensor(float("inf"), dtype=xyz.dtype, device=xyz.device)
    lo = torch.where(lv[..., None], xyz, inf).amin(2)
    hi = torch.where(lv[..., None], xyz, -inf).amax(2)
    any_live = lv.any(2)
    cw = torch.where(any_live[..., None], (lo + hi) * 0.5, 0.0)  # (H, R, 3)
    off = xyz - cw[:, :, None]
    rho = torch.sqrt(torch.where(lv, (off * off).sum(-1), 0.0).amax(2))  # (H, R)
    s = torch.where(lv[..., None], dd, 0.0).sum(2)
    a = s * torch.rsqrt(torch.clamp((s * s).sum(-1, keepdim=True), min=1e-30))
    cmin = torch.where(lv, (dd * a[:, :, None]).sum(-1), 1.0).amin(2)
    x = torch.linalg.cross(dd, a[:, :, None].expand_as(dd), dim=-1)
    smax = torch.sqrt(torch.where(lv, (x * x).sum(-1), 0.0).amax(2))
    wc = spheres.center[:, None, None] - cw  # (N, H, R, 3)
    D2 = (wc * wc).sum(-1)
    D = torch.sqrt(D2)
    r = (spheres.radius[:, None, None] + rho) * (1.0 + CULL_REL) + CULL_ABS * (D + rho)
    reach = cmin * torch.sqrt(torch.clamp(D2 - r * r, min=0.0)) - smax * r
    near = ~(cmin > 0.0) | (r >= D) | ((a * wc).sum(-1) >= reach)
    return (near & any_live).permute(1, 2, 0)
