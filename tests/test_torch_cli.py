"""The port's CLI on the CPU, its I/O helpers, and the rule that the
package imports nothing of JAX."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from reversible_raytracer_tpu_torch import cli
from reversible_raytracer_tpu_torch.utils.imageio import save_png
from reversible_raytracer_tpu_torch.utils.metrics import MetricsLogger


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six test
    processes at once, and torch's default of a thread per core slows this
    file and the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parents[1]


def test_invert_on_cpu(tmp_path):
    metrics = tmp_path / "m.jsonl"
    png = tmp_path / "final.png"
    out = cli.main(["invert", "--device", "cpu", "--size", "16", "--iters", "3",
                    "--log-every", "1", "--metrics", str(metrics), "-o", str(png)])
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["param_err"]) for r in recs)
    assert out["history"] == [{k: v for k, v in r.items() if k != "t"} for r in recs]
    assert png.read_bytes().startswith(b"\x89PNG")


def test_render_on_cpu(tmp_path):
    png = tmp_path / "r.png"
    cli.main(["render", "--device", "cpu", "--config", "3", "--size", "12", "-o", str(png)])
    from PIL import Image

    img = np.asarray(Image.open(png))
    assert img.shape == (12, 12, 3) and img.max() > 0


def test_cuda_default_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["render", "--size", "8"])


def test_save_png_round_trip(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    img = rng.uniform(-0.2, 1.2, size=(5, 7, 3)).astype(np.float32)
    save_png(str(tmp_path / "a.png"), torch.from_numpy(img))
    back = np.asarray(Image.open(tmp_path / "a.png"))
    np.testing.assert_array_equal(back, (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8))


def test_metrics_logger_appends_as_jax_does(tmp_path):
    """Two runs into one file, through the port's logger and through the JAX
    package's: both files hold both runs' records, in the same order."""
    from reversible_raytracer_tpu.utils.metrics import MetricsLogger as JaxMetricsLogger

    def two_runs(logger_cls, path):
        for run in range(2):
            log = logger_cls(jsonl_path=str(path), echo=False)
            for step in range(3):
                log.log(step=step, run=run, loss=0.5 / (step + 1))
            log.close()
        recs = [json.loads(line) for line in path.read_text().splitlines()]
        assert all("t" in r for r in recs)
        return [{k: v for k, v in r.items() if k != "t"} for r in recs]

    port = two_runs(MetricsLogger, tmp_path / "port.jsonl")
    jax_recs = two_runs(JaxMetricsLogger, tmp_path / "jax.jsonl")
    assert port == jax_recs
    assert [(r["run"], r["step"]) for r in port] == [(r, s) for r in range(2) for s in range(3)]


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import reversible_raytracer_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax',"
        " 'reversible_raytracer_tpu')]\n"
        "assert len(names) >= 12, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
