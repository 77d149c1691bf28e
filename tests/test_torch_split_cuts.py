"""The split tools' cuts against the current CUDA sources, on the CPU.

tools/flat_step_split.py and tools/vec_step_split.py time variant builds
of the step and forward kernels (rows 1-2 and 4-7), each with one part cut by a text
substitution that must match its source exactly once (make_variant raises
otherwise). A cut that no longer matches would show only on the card, after
the build; here every cut of the set each tool picks for the current
sources is applied to a copy of them, without nvcc. Nothing here imports JAX; the file runs in
about a second, on one torch thread.
"""

import sys
from pathlib import Path

import pytest
import torch

TOOLS = Path(__file__).resolve().parent.parent / "tools"
sys.path.insert(0, str(TOOLS))

import flat_step_split  # noqa: E402
import vec_step_split  # noqa: E402

from reversible_raytracer_tpu_torch.ops.kernels._build import CSRC  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as in every port test file: the suite runs six
    test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _current_cuts():
    """(tool, cut, substitutions, source) of every cut each tool picks for
    the current sources."""
    _, flat = flat_step_split.cut_set(CSRC)
    assert (CSRC / "cull.cuh").exists()  # vec_step_split picks CUTS_CULLED
    cases = [("flat", name, subs, "fused_step.cu") for name, subs in flat.items()]
    _, flat_fwd = flat_step_split.cut_set(CSRC, "fwd")
    cases += [("flat_fwd", name, subs, "fused_render.cu") for name, subs in flat_fwd.items()]
    cases += [("vec", name, subs, "fused_vec_step.cu")
              for name, subs in vec_step_split.CUTS_CULLED.items()]
    for kernel, source in (("fwd", "fused_vec_render.cu"), ("soft_fwd", "fused_vec_soft_render.cu")):
        _, cuts = vec_step_split.cut_set(CSRC, kernel)
        cases += [(kernel, name, subs, source) for name, subs in cuts.items()]
    return cases


CASES = _current_cuts()


def test_the_flat_tool_picks_the_one_launch_cuts():
    which, cuts = flat_step_split.cut_set(CSRC)
    assert which == "one_launch" and cuts is flat_step_split.CUTS
    assert set(flat_step_split.CUTS_PARENT) <= set(cuts)
    which, cuts = flat_step_split.cut_set(CSRC, "fwd")  # row 2 after its redesign
    assert which == "redesign" and cuts is flat_step_split.FWD_REDESIGN


@pytest.mark.parametrize("kernel, cuts", [("fwd", "FWD_CULLED"), ("soft_fwd", "SOFT_FWD_CULLED")])
def test_the_vec_tool_picks_the_culled_forward_cuts(kernel, cuts):
    which, got = vec_step_split.cut_set(CSRC, kernel)
    assert which == "culled" and got is getattr(vec_step_split, cuts)
    parent = getattr(vec_step_split, cuts.replace("CULLED", "PARENT"))
    assert set(parent) <= set(got)


@pytest.mark.parametrize("tool, name, subs, source", CASES,
                         ids=[f"{tool}-{name}" for tool, name, *_ in CASES])
def test_cut_matches_the_current_sources(tmp_path, tool, name, subs, source):
    """Each substitution matches once (make_variant checks the count and
    raises), changes its file, and the variant's source gets the setter of
    the planes the cuts read."""
    root = tmp_path / name
    src = vec_step_split.make_variant(CSRC, root, subs, source)
    assert src.read_text().endswith(vec_step_split.SETTER)
    for file, old, new in subs:
        text = (root / file).read_text()
        assert new in text and (old in new or old not in text), (tool, name, file)
