"""Build the CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` compiles on its own into ``build/lib<name>.so``
with a plain C interface (no PyTorch headers, so a build takes seconds).
A library is rebuilt when its source or a shared header is newer than it.
Nothing here runs at import time: the first kernel launch builds, and
`build_all` builds every kernel at once (one nvcc process per source, all
started together).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# --fmad=false keeps a * b + c as two IEEE roundings, as eager torch rounds
# it. With contraction the kernels' rays drift from the plain version's by
# an ulp, and next to a sphere's limb that moves config 2's camera gradient
# well past the 1e-2 tolerance (PERF.md, findings on the step kernel).
# chip_smoke.py's fmad phase times both builds: contraction does not make
# the step kernel faster.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


@dataclass
class Kernel:
    """One CUDA source, its shared library, and the count of launches made
    through its wrapper."""

    name: str
    signatures: dict  # C function name -> (argtypes, restype)
    launches: int = 0
    build_log: str = ""
    _lib: ctypes.CDLL | None = field(default=None, repr=False)

    @property
    def source(self) -> Path:
        return CSRC / f"{self.name}.cu"

    @property
    def library(self) -> Path:
        return BUILD_DIR / f"lib{self.name}.so"

    def stale(self) -> bool:
        if not self.library.exists():
            return True
        newest = max(p.stat().st_mtime for p in [self.source, *CSRC.glob("*.cuh")])
        return newest > self.library.stat().st_mtime

    def start_build(self) -> subprocess.Popen:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        proc.tmp = tmp
        return proc

    def finish_build(self, proc: subprocess.Popen) -> None:
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{out}")
        os.replace(proc.tmp, self.library)

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            if self.stale():
                self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.library))
            for fn, (argtypes, restype) in self.signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            self._lib = lib
        return self._lib

    def call(self, fn: str, *args) -> None:
        """Call a launching C entry; raise on a CUDA error it returns."""
        err = getattr(self.lib(), fn)(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}.{fn} failed: CUDA error {err}")


def build_all(kernels) -> float:
    """Build every stale kernel in parallel and load all of them. Returns
    the seconds it took."""
    t0 = time.perf_counter()
    procs = [(k, k.start_build()) for k in kernels if k.stale()]
    try:
        for k, proc in procs:
            k.finish_build(proc)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for k in kernels:
        k.lib()
    return time.perf_counter() - t0
