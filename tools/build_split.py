#!/usr/bin/env python3
"""The kernels' cold build with and without nvcc's --split-compile, on one
machine with the CUDA toolkit (no card is used).

    python3 tools/build_split.py

Builds every csrc/*.cu with the port's nvcc flags (`_build.NVCC_FLAGS`),
all nine at once, as `_build.build_all` does, into build/split/plain; then
the same with ``--split-compile=0`` added (nvcc's optimizer passes spread
over the cores) into build/split/split. For each set it prints one JSON line:
the wall seconds, the nvcc processes' CPU seconds and each source's own
seconds. Then, per source, how many kernels' machine code (``cuobjdump
-sass``, as tools/flat_ab.py compares it) is the same in both sets: where it
differs, the split build is a different program, to be held to the plain
one's bits and times (tools/flat_ab.py, tools/soft_ab.py) before it is used.
"""

from __future__ import annotations

import json
import resource
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))


def build_set(_build, names, out: Path, extra) -> dict:
    """Start one nvcc a source, all at once; their wall, CPU and own seconds."""
    out.mkdir(parents=True, exist_ok=True)
    ru0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    t0 = time.perf_counter()
    procs = {n: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, *extra, "-o", str(out / f"lib{n}.so"),
         str(_build.CSRC / f"{n}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for n in names}
    own = {}
    while len(own) < len(procs):
        for n, proc in procs.items():
            if n not in own and proc.poll() is not None:
                own[n] = round(time.perf_counter() - t0, 1)
                log = proc.stdout.read()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {n}.cu:\n{log}")
        time.sleep(0.1)
    ru1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    return dict(wall_seconds=round(time.perf_counter() - t0, 1),
                nvcc_cpu_seconds=round(ru1.ru_utime + ru1.ru_stime - ru0.ru_utime
                                       - ru0.ru_stime, 1),
                seconds_by_source=dict(sorted(own.items(), key=lambda kv: kv[1])))


def main() -> int:
    import flat_ab

    from reversible_raytracer_tpu_torch.ops.kernels import _build

    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    root = _build.BUILD_DIR / "split"
    sets = {"plain": [], "split": ["--split-compile=0"]}
    for tag, extra in sets.items():
        print(json.dumps({"set": tag, "flags": extra,
                          **build_set(_build, names, root / tag, extra)}), flush=True)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for n in names:
        a = flat_ab.sass(cuobjdump, root / "plain" / f"lib{n}.so")
        b = flat_ab.sass(cuobjdump, root / "split" / f"lib{n}.so")
        print(json.dumps({"source": n, "kernels": len(a),
                          "same_sass": sum(a[k] == b.get(k) for k in a)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
