"""Checkpoint / resume: the scene, the optimizer state and the step to
restart at, in one ``.npz`` with the JAX package's schema, so that a
checkpoint moves both ways between the two packages.

- ``__step__``: the step to restart at (int64);
- ``scene/<path>``: every scene leaf, float32, under its ``/``-joined path
  (``scene/spheres/material/color``);
- ``opt/<i>``: the optimizer state's leaves in the order of the JAX
  package's ``make_optimizer(ocfg).init(scene)`` (`optim.opt_state_leaves`
  makes them from the port's state).

The file is written to a temporary name and renamed into place.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.scene import leaf_paths, tree_leaves, tree_unflatten


def _names(scene_like) -> list:
    return [p.replace(".", "/") for p in leaf_paths(scene_like)]


def save(path: str, scene, opt_state=None, step: int = 0) -> None:
    """Write ``scene`` (a Scene), ``opt_state`` (a list of arrays, or None)
    and ``step``."""
    arrays = {"__step__": np.asarray(step, np.int64)}
    for name, leaf in zip(_names(scene), tree_leaves(scene)):
        arrays[f"scene/{name}"] = leaf.detach().cpu().numpy()
    for i, leaf in enumerate(opt_state or ()):
        arrays[f"opt/{i}"] = np.asarray(leaf)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)


def load(path: str, scene_like, opt_state_like=None, allow_partial: bool = False):
    """``(scene, opt_state, step)``: the scene on ``scene_like``'s device, and
    the optimizer state as a list of numpy arrays shaped like
    ``opt_state_like`` (None without it).

    Strict, as the JAX package's: a scene key the file lacks raises (the
    file predates the scene schema, and its flat-indexed optimizer leaves
    would be misaligned too), and so does a missing optimizer key unless
    ``allow_partial``, which takes the template's leaf for it."""
    with np.load(path) as data:
        step = int(data["__step__"])
        names = _names(scene_like)
        missing_scene = [n for n in names if f"scene/{n}" not in data]
        if missing_scene:
            raise ValueError(
                f"checkpoint {path!r} predates the current scene schema: missing scene keys "
                f"{missing_scene}; its flat-indexed optimizer leaves would be misaligned too, "
                f"so re-run from scratch or re-save it under the new schema")
        leaves = []
        for name, like in zip(names, tree_leaves(scene_like)):
            arr = np.asarray(data[f"scene/{name}"], np.float32).reshape(tuple(like.shape))
            leaves.append(torch.from_numpy(arr.copy()).to(like.device))
        scene = tree_unflatten(scene_like, leaves)
        opt_state = None
        if opt_state_like is not None:
            opt_state, missing = [], []
            for i, like in enumerate(opt_state_like):
                key = f"opt/{i}"
                if key in data:
                    opt_state.append(np.asarray(data[key]))
                else:
                    missing.append(key)
                    opt_state.append(np.asarray(like))
            if missing and not allow_partial:
                raise ValueError(
                    f"checkpoint {path!r} is missing optimizer-state keys {missing} for this "
                    f"optimizer (template has {len(opt_state)} leaves); pass "
                    f"allow_partial=True to substitute template values")
    return scene, opt_state, step
