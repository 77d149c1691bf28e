"""Structured per-step metrics: one JSON record per logged step, to stderr
and/or a JSONL file. The file is truncated when a logger opens it, so a
file holds one run."""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass, field


@dataclass
class MetricsLogger:
    jsonl_path: str | None = None
    echo: bool = True
    _fh: object = field(default=None, repr=False)
    _t0: float = field(default_factory=time.perf_counter, repr=False)

    def __post_init__(self):
        if self.jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(self.jsonl_path)), exist_ok=True)
            self._fh = open(self.jsonl_path, "w", buffering=1)

    def log(self, **record) -> None:
        record.setdefault("t", round(time.perf_counter() - self._t0, 6))
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")
        if self.echo:
            print("  ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                            for k, v in record.items()), file=sys.stderr)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
