"""Timing helpers shared by chip_smoke.py and the kernel split tools.

- `time_ms`: the event time of a call, from a CUDA event recorded before
  the call to one recorded after it on the current stream. For a call that
  launches its kernels from the host (a ctypes entry), it includes the
  host's time to launch them.
- `device_ms`: each kernel's own device time and its launches per call,
  from torch.profiler's CUDA activity (CUPTI's record of every kernel the
  process ran, whatever launched it).
"""

from __future__ import annotations

import re
import statistics
import time


def time_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_name(name: str) -> str:
    """A kernel's demangled name without its return type, namespace and
    argument list: ``void rrt::f<rrt::A>(float*)`` -> ``f<A>``."""
    name = re.sub(r"^void ", "", name.split("(")[0])
    return name.replace("rrt::", "")


# Profiler windows device_ms takes before it reports the last one's, when the
# tracer lost launches (see device_ms); three empty windows in a row have
# happened on the H100 (row 2 at config 7), so it waits a little and warms up
# again before each further window.
PROFILE_TRIES = 8


def device_ms(fn, reps=20, warmup=3):
    """Device time of ``fn`` by kernel over ``reps`` calls after ``warmup``:
    ``{"kernels": {name: {"launches": per call, "events": launches traced,
    "ms": median ms of one launch}}, "ms": the kernels' device time per call,
    "launches": per call}``. A window in which the profiler recorded no
    device activity at all, or no more launches of a kernel than half the
    calls (both have happened on the H100: 0 and 10 of 20; half rounds to 0
    launches a call), is profiled again, up to `PROFILE_TRIES` windows;
    ``kernels`` is empty if none recorded any."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        if attempt:
            time.sleep(0.05 * attempt)
            for _ in range(warmup):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name.setdefault(kernel_name(e.name), []).append(
                    e.time_range.elapsed_us() / 1e3)
        if by_name and all(2 * len(ts) > reps for ts in by_name.values()):
            break
    # the tracer may miss a launch at the edge of its window (up to 3 in 20
    # on the H100): launches per call are the events over the calls,
    # rounded; "events" counts them all
    kernels = {name: {"launches": round(len(ts) / reps), "events": len(ts),
                      "ms": statistics.median(ts)} for name, ts in by_name.items()}
    return {"kernels": kernels, "ms": sum(k["launches"] * k["ms"] for k in kernels.values()),
            "launches": sum(k["launches"] for k in kernels.values())}
