"""The restarts over the anneal (`optim.swap_spheres`, `rejitter_one_sphere`,
`restart_attribution`, `residual_reseed`, `propose_restart`,
`optimize_multistart`, ``invert --restarts``) on the CPU, against the JAX
package.

- `swap_spheres` (center rows only, and every sphere row),
  `rejitter_one_sphere` and the five blind proposal families (jitter,
  per_sphere, swap, swap_jitter, mixed) on config 2 equal the JAX package's
  bit for bit: the same numpy draws in the same leaf order; the degenerate
  scenes (no sphere: every family falls back to jitter; one sphere: a swap
  re-kicks it) too;
- `restart_attribution` against the JAX package's `residual_reseed`
  attribution on config 2 at 24^2 from perturb(scale=0.45, seed=2), the
  target rendered by the port: the suspicions within 1e-4 of the largest
  and in the same order (the two renders of the start differ by up to
  2.5e-5 on a pixel, which puts sphere 1's 1.1e-4 of its own value off);
  the residual within 1e-3; the `resid`
  proposal of ranks 0-7 picks the same suspect and peak pixel, every leaf
  within 1e-5;
- the reseed keeps a center's eye distance under perspective and its depth
  along the view direction under an orthographic camera (jitter 0);
- `optimize_multistart`'s chain: the JAX package's call sequences
  (tests/test_optimize.py `test_multistart_chain_mechanics`), and the index
  starting again at 1 after an improvement;
- ``restarts=1`` is `optimize_annealed` bit for bit, and ``invert --restarts
  1 --anneal`` the run without the flag;
- the CLI: ``invert --restarts 3 --restart-proposal resid --restart-chain``
  prints three finals, the best their minimum.

One JAX compile (the JAX package's attribution, inside its
`residual_reseed`) runs in a thread from the file's first test on. The
restarts on a card are held to these in tests/test_torch_kernels.py and
chip_smoke.py (phases restarts, restarts_main).
"""

import concurrent.futures
import dataclasses
import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reversible_raytracer_tpu import optim as joptim
from reversible_raytracer_tpu.models import configs as jconfigs
from reversible_raytracer_tpu.models.scene import ParamSpec as JParamSpec
from reversible_raytracer_tpu.models.scene import Spheres as JSpheres
from reversible_raytracer_tpu.ops.pipeline import RenderConfig as JRenderConfig
from reversible_raytracer_tpu_torch import cli, optim
from reversible_raytracer_tpu_torch.models import configs
from reversible_raytracer_tpu_torch.models.scene import ParamSpec, Spheres, tree_leaves
from reversible_raytracer_tpu_torch.ops.pipeline import RenderConfig
from reversible_raytracer_tpu_torch.ops.render import mse_loss, render

SIZE = 24
BLIND = ("jitter", "per_sphere", "swap", "swap_jitter", "mixed")
RANKS = range(8)  # two cycles of config 2's four suspects


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six test
    processes at once, and torch's default of a thread per core slows this
    file and the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _starts():
    """Config 2 at SIZE from perturb(scale=0.45, seed=2) in both packages,
    their specs and the port's CPU render of the truth."""
    js, jspec, _ = jconfigs.config2_four_spheres(SIZE)
    ts, tspec, cfg = configs.config2_four_spheres(SIZE, device="cpu")
    target = render(ts, cfg)
    return (jconfigs.perturb(js, jspec, scale=0.45, seed=2), jspec,
            configs.perturb(ts, tspec, scale=0.45, seed=2), tspec, cfg, target)


def _jax_resid():
    """The JAX package's attribution ``(resid, suspicion)`` of the start and
    its `resid` proposals of RANKS (seed 8, jitter 0.3): one jit of its
    attribution, reused."""
    jst, jspec, _, _, _, target = _starts()
    jcfg = JRenderConfig(height=SIZE, width=SIZE, shadows=True)
    tgt = np.asarray(target)
    props = [joptim.residual_reseed(jst, jspec, tgt, jcfg, rank, 8, 0.3) for rank in RANKS]
    key = ("resid", jcfg, jst.spheres.count, jax.tree_util.tree_structure(jst))
    attrib = joptim._RESEED_CACHE[key][0]
    resid, suspicion = (np.asarray(x) for x in attrib(jst, jnp.asarray(tgt)))
    return resid, suspicion, [_np(p) for p in props]


_COMPILED = {}


@pytest.fixture(autouse=True, scope="module")
def _start_jax_compile():
    """Start the file's one JAX compile in a thread as its first test starts:
    XLA compiles without holding the GIL, so the tests before the JAX ones
    run meanwhile."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        _COMPILED["f"] = pool.submit(_jax_resid)
        yield


def _np(tree):
    if isinstance(tree, list):
        return tree
    if dataclasses.is_dataclass(tree) and hasattr(tree.spheres.center, "detach"):
        return [x.detach().cpu().numpy() for x in tree_leaves(tree)]
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _assert_bits(a, b):
    for x, y in zip(_np(a), _np(b), strict=True):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("geometry_only", [True, False])
def test_swap_spheres_matches_jax(geometry_only):
    jst, _, tst, _, cfg, _ = _starts()
    out = optim.swap_spheres(tst, 0, 2, geometry_only=geometry_only)
    _assert_bits(out, joptim.swap_spheres(jst, 0, 2, geometry_only=geometry_only))
    assert torch.equal(out.spheres.center[0], tst.spheres.center[2])
    assert torch.equal(out.spheres.center[2], tst.spheres.center[0])
    assert torch.equal(out.spheres.center[[1, 3]], tst.spheres.center[[1, 3]])
    assert torch.equal(out.spheres.radius, tst.spheres.radius) == geometry_only
    if not geometry_only:  # a re-indexed scene renders the same
        assert torch.equal(render(out, cfg), render(tst, cfg))
    assert not torch.equal(tst.spheres.center[0], tst.spheres.center[2])  # the caller's intact


@pytest.mark.parametrize("idx", range(4))
def test_rejitter_one_sphere_matches_jax(idx):
    jst, jspec, tst, tspec, _, _ = _starts()
    out = optim.rejitter_one_sphere(tst, tspec, idx, 0.4, 3)
    _assert_bits(out, joptim.rejitter_one_sphere(jst, jspec, idx, 0.4, 3))
    others = [k for k in range(4) if k != idx]
    assert torch.equal(out.spheres.center[others], tst.spheres.center[others])
    assert not torch.equal(out.spheres.center[idx], tst.spheres.center[idx])
    assert torch.equal(out.camera.eye, tst.camera.eye)


@pytest.mark.parametrize("proposal", BLIND)
def test_blind_proposals_match_jax(proposal):
    jst, jspec, tst, tspec, _, _ = _starts()
    assert optim.propose_restart(tst, tspec, 0, 0.3, 7, proposal) is tst
    for r in range(1, 8):
        out = optim.propose_restart(tst, tspec, r, 0.3, 7, proposal)
        _assert_bits(out, joptim.propose_restart(jst, jspec, r, 0.3, 7, proposal))
        assert any(not np.array_equal(a, b) for a, b in zip(_np(out), _np(tst)))


def test_degenerate_scenes_match_jax():
    """No sphere: every family falls back to jitter (`resid` too, with its
    target); one sphere: a swap re-kicks sphere 0. Each moves a trainable
    leaf and equals the JAX package's proposal."""
    js = jconfigs.config2_four_spheres(16)[0]
    ts, _, cfg = configs.config2_four_spheres(16, device="cpu")
    jrect = dataclasses.replace(js, spheres=JSpheres.empty())
    trect = dataclasses.replace(ts, spheres=Spheres.empty(device="cpu"))
    jspec = JParamSpec.none(jrect).train("rects.origin")
    tspec = ParamSpec.none(trect).train("rects.origin")
    target = render(trect, cfg)
    jcfg = JRenderConfig(height=16, width=16, shadows=True)
    for prop in ("swap", "swap_jitter", "per_sphere", "mixed", "resid"):
        out = optim.propose_restart(trect, tspec, 1, 0.2, 7, prop, target=target, rcfg=cfg)
        _assert_bits(out, joptim.propose_restart(jrect, jspec, 1, 0.2, 7, prop,
                                                 target=np.asarray(target), rcfg=jcfg))
        assert not torch.equal(out.rects.origin, trect.rects.origin), prop
    jone, jspec1, _ = jconfigs.config1_single_sphere()
    tone, tspec1, _ = configs.config1_single_sphere(device="cpu")
    out = optim.propose_restart(tone, tspec1, 1, 0.2, 7, "swap")
    _assert_bits(out, joptim.propose_restart(jone, jspec1, 1, 0.2, 7, "swap"))
    assert not torch.equal(out.spheres.center, tone.spheres.center)


def test_proposals_refuse_by_name():
    _, _, tst, tspec, _, _ = _starts()
    with pytest.raises(ValueError, match="needs target and rcfg"):
        optim.propose_restart(tst, tspec, 1, 0.3, 7, "resid")
    with pytest.raises(ValueError, match="unknown restart proposal"):
        optim.propose_restart(tst, tspec, 1, 0.3, 7, "anneal")


def test_restart_attribution_matches_jax():
    _, _, tst, _, cfg, target = _starts()
    resid, suspicion = optim.restart_attribution(tst, target, cfg)
    jresid, jsusp = _COMPILED["f"].result()[:2]
    assert resid.shape == (SIZE, SIZE) and suspicion.shape == (4,)
    np.testing.assert_allclose(resid.numpy(), jresid, rtol=0, atol=1e-3)
    np.testing.assert_allclose(suspicion.numpy(), jsusp, rtol=0, atol=1e-4 * jsusp.max())
    order = np.argsort(-jsusp, kind="stable")
    assert np.all(np.diff(jsusp[order]) < -1e-4 * jsusp.max())  # margins clear of a near-tie
    np.testing.assert_array_equal(np.argsort(-suspicion.numpy(), kind="stable"), order)


def test_resid_proposals_match_jax():
    """Ranks 0-7: the same suspect and peak pixel as the JAX package's
    attribution gives, every leaf within 1e-5; exactly one sphere takes a
    large move and keeps its eye distance up to the half-jitter."""
    _, _, tst, tspec, cfg, target = _starts()
    jresid, jsusp, jprops = _COMPILED["f"].result()
    resid, suspicion = (x.numpy() for x in optim.restart_attribution(tst, target, cfg))
    eye = tst.camera.eye.numpy()
    for rank, jprop in zip(RANKS, jprops):
        assert optim.reseed_pick(resid, suspicion, rank) == optim.reseed_pick(jresid, jsusp, rank)
        out = optim.residual_reseed(tst, tspec, target, cfg, rank, 8, 0.3)
        for a, b in zip(_np(out), jprop, strict=True):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        moved = (out.spheres.center - tst.spheres.center).abs().max(1).values.numpy()
        idx = optim.reseed_pick(resid, suspicion, rank)[0]
        assert (moved > 0.5).sum() <= 1 and int(np.argmax(moved)) == idx
        d0 = np.linalg.norm(tst.spheres.center[idx].numpy() - eye)
        d1 = np.linalg.norm(out.spheres.center[idx].numpy() - eye)
        assert abs(d1 - d0) / d0 < 0.5
    r1 = optim.propose_restart(tst, tspec, 1, 0.3, 7, "resid", target=target, rcfg=cfg)
    _assert_bits(r1, optim.residual_reseed(tst, tspec, target, cfg, 0, 8, 0.3))


@pytest.mark.parametrize("projection", ["perspective", "orthographic"])
def test_reseed_keeps_the_depth(projection):
    """With jitter 0 the reseeded center keeps its distance from the eye
    (perspective) or its depth along the view direction (orthographic,
    whose rays start across the image plane): the JAX package's
    test_resid_reseed_orthographic_depth."""
    scene, spec, _ = configs.config2_four_spheres(32, device="cpu")
    cfg = RenderConfig(height=32, width=32, shadows=True, projection=projection)
    target = render(scene, cfg)
    start = configs.perturb(scene, spec, scale=0.4, seed=3)
    out = optim.residual_reseed(start, spec, target, cfg, rank=0, seed=9, jitter=0.0)
    moved = (out.spheres.center - start.spheres.center).abs().max(1).values
    idx = int(moved.argmax())
    assert int((moved > 0).sum()) == 1
    eye = start.camera.eye.numpy()
    fwd = start.camera.look_at.numpy() - eye
    fwd = fwd / np.linalg.norm(fwd)
    depth = ((lambda c: float(np.dot(c - eye, fwd))) if projection == "orthographic"
             else (lambda c: float(np.linalg.norm(c - eye))))
    np.testing.assert_allclose(depth(out.spheres.center[idx].numpy()),
                               depth(start.spheres.center[idx].numpy()), rtol=1e-5, atol=1e-5)


def _chain_calls(monkeypatch, chain, losses=None):
    """The (base, index, seed) of each `propose_restart` call of a 4- or
    len(losses)-restart run whose inner optimizer returns its start; with
    ``losses``, restart r's ranked loss is ``losses[r]``."""
    scene, spec, cfg = configs.config2_four_spheres(16, device="cpu")
    target = torch.zeros((16, 16, 3))
    calls = []

    def fake_propose(base, spec_, ri, jitter, sd, proposal, target=None, rcfg=None):
        calls.append((base, ri, sd))
        return base

    monkeypatch.setattr(optim, "propose_restart", fake_propose)
    optimize_fn = lambda s: (s, [0.0])
    if losses is not None:
        it = iter(losses)
        optimize_fn = lambda s: (dataclasses.replace(s, ambient=torch.tensor(next(it))), [0.0])
        monkeypatch.setattr(importlib.import_module("reversible_raytracer_tpu_torch.ops.render"),
                            "render", lambda s, c: torch.full((16, 16, 3), float(s.ambient) ** 0.5))
    optim.optimize_multistart(scene, target, spec, cfg, optim.OptConfig(iters=1),
                              restarts=len(losses) if losses else 4, jitter=0.2, seed=5,
                              optimize_fn=optimize_fn, proposal="per_sphere", chain=chain)
    return scene, calls


def test_multistart_chain_mechanics(monkeypatch):
    """The JAX package's literal sequences: without the chain every restart
    proposes from the start with index r and the fixed seed; with it, from
    the best scene once there is one, the index climbing while stuck, the
    seed seed + r."""
    scene, calls = _chain_calls(monkeypatch, chain=False)
    assert [(c[1], c[2]) for c in calls] == [(0, 5), (1, 5), (2, 5), (3, 5)]
    assert all(c[0] is scene for c in calls)
    scene, calls = _chain_calls(monkeypatch, chain=True)
    assert [(c[1], c[2]) for c in calls] == [(0, 5), (1, 6), (2, 7), (3, 8)]
    assert calls[0][0] is scene and all(c[0] is not None for c in calls[1:])


def test_multistart_chain_resets_on_improvement(monkeypatch):
    """Ranked losses 5, 4, 6, 6, 3, 7: the index starts again at 1 after
    restarts 1 and 4 improve, and each round proposes from the best so far."""
    losses = [5.0, 4.0, 6.0, 6.0, 3.0, 7.0]
    _, calls = _chain_calls(monkeypatch, chain=True, losses=losses)
    assert [(c[1], c[2]) for c in calls] == [(0, 5), (1, 6), (1, 7), (2, 8), (3, 9), (1, 10)]
    bases = [float(c[0].ambient) for c in calls[1:]]
    assert bases == [5.0, 4.0, 4.0, 4.0, 3.0]


def test_one_restart_is_optimize_annealed():
    scene, spec, cfg = configs.config2_four_spheres(16, device="cpu")
    target = render(scene, cfg)
    start = configs.perturb(scene, spec, scale=0.3, seed=2)
    ocfg = optim.OptConfig(iters=3, lr=1e-2)
    kw = dict(taus=(0.05, 0.0), target_scene=scene)
    best, best_loss, finals = optim.optimize_multistart(start, target, spec, cfg, ocfg,
                                                        restarts=1, **kw)
    final, _ = optim.optimize_annealed(start, target, spec, cfg, ocfg, **kw)
    _assert_bits(best, final)
    assert finals == [best_loss] and best_loss == float(mse_loss(render(final, cfg), target))


def _invert(argv, capsys):
    out = cli.main(["invert", "--device", "cpu", "--config", "2", "--size", "16", "--iters", "3",
                    "--perturb", "0.3", "--seed", "2", "--anneal", "0.05,0", "--quiet", *argv])
    return out, capsys.readouterr().err


def test_cli_restarts(capsys):
    out, err = _invert(["--restarts", "3", "--restart-jitter", "0.3", "--restart-proposal",
                        "resid", "--restart-chain"], capsys)
    line = re.search(r"multistart finals: \[(.*)\] -> best (\S+)", err)
    printed = [float(x.strip(" '")) for x in line.group(1).split(",")]
    assert len(printed) == len(out["finals"]) == 3
    assert out["best_loss"] == min(out["finals"]) and out["losses"] == [out["best_loss"]]
    assert float(line.group(2)) == pytest.approx(min(printed), rel=1e-3)
    assert "final param RMS error vs truth" in err


def test_cli_one_restart_is_the_anneal(capsys):
    one, _ = _invert(["--restarts", "1", "--restart-proposal", "resid"], capsys)
    plain, err = _invert([], capsys)
    assert "multistart" not in err and one["finals"] is None
    assert one["losses"] == plain["losses"]
    _assert_bits(one["scene"], plain["scene"])
