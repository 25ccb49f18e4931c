"""The device trace of a window: ``torch.profiler`` with CUDA activity
(CUPTI), read back from its Chrome trace.

Device activity is every kernel, copy and set on the card; a ``nccl``
kernel is communication, every other kernel compute.  What is read (all in
seconds, on the trace's own clock, inside the window's marker):

- ``busy_s``: the length of the union of device activity;
- ``window_s``: the marker's length;
- ``nccl_exposed_s``: the NCCL kernels' time that no compute kernel covers;
- ``device_ops``: the ten kernels with most time, summed by name;
- ``idle_gaps``: the ten longest holes in device activity, each named by
  the innermost host event on the window's thread at the hole's middle.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import torch

from portbench import intervals

MARK = "portbench.window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


class DeviceTrace:
    def __init__(self):
        self.prof = None
        self.mark = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.mark = torch.profiler.record_function(MARK)
        self.mark.__enter__()

    def stop(self) -> None:
        self.mark.__exit__(None, None, None)
        self.prof.stop()

    def summarise(self) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        return summarise(events)


def summarise(events: list[dict]) -> dict:
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in xs if e.get("name") == MARK and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("the trace holds no window marker")
    mark = marks[0]
    lo, hi = mark["ts"] * 1e-6, (mark["ts"] + mark["dur"]) * 1e-6
    device = [e for e in xs if e.get("cat") in DEVICE_CATS]
    spans = intervals.clip([(e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6) for e in device], lo, hi)
    kernels = [e for e in device if e.get("cat") == "kernel"]
    nccl = [(e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6) for e in kernels
            if "nccl" in e["name"].lower()]
    compute = [(e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6) for e in kernels
               if "nccl" not in e["name"].lower()]
    by_name: dict[str, float] = defaultdict(float)
    for e in device:
        a, b = max(e["ts"] * 1e-6, lo), min((e["ts"] + e["dur"]) * 1e-6, hi)
        if b > a:
            by_name[e["name"]] += b - a
    host = sorted(((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6, e["name"],
                    e.get("tid") == mark.get("tid")) for e in xs
                   if e.get("pid") == mark.get("pid") and e.get("cat") not in DEVICE_CATS
                   and e is not mark), key=lambda t: t[0])
    holes = sorted(intervals.gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:10]
    return {
        "window_s": hi - lo,
        "busy_s": intervals.covered(spans),
        "nccl_s": intervals.covered(intervals.clip(nccl, lo, hi)),
        "nccl_exposed_s": intervals.covered(
            intervals.subtract(intervals.clip(nccl, lo, hi), intervals.clip(compute, lo, hi))),
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": [[_host_at(host, (a + b) / 2), b - a] for a, b in holes],
        "kernels": len(kernels),
    }


def _host_at(host: list[tuple[float, float, str, bool]], t: float) -> str:
    """The innermost host event covering ``t``, on the window's thread if
    one is there, else on another thread (named ``thread: <event>``), else
    ``"host: no event"``."""
    best: dict[bool, tuple] = {}
    for a, b, name, main in host:
        if a > t:
            break
        if b >= t and (main not in best or b - a < best[main][1] - best[main][0]):
            best[main] = (a, b, name)
    if True in best:
        return best[True][2]
    if False in best:
        return "thread: " + best[False][2]
    return "host: no event"
