"""The traced window: ``torch.profiler`` over it, and what the per-layer
readers take from the trace.

The harness marks the window and every step with ``record_function``
(``portbench.window``, ``portbench.step``), so its spans share the
profiler's clock with the device's operations.  :func:`summarize` reads the
exported Chrome trace: the device intervals (kernels, copies, memsets)
inside the window, their union (busy time), the kernels' own time, each
step's host time (its span less the device-busy time inside it), the device
operations that took most time, the host operations that took most time
(by name, nested ones counted in each), and the longest idle gaps, each
named by the innermost host operation that was running at its middle.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "portbench.window"
STEP = "portbench.step"


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: float
    kernels: Dict[str, float]  # kernel name -> seconds in the window
    step_host_s: List[float]
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    host_ops: List[Tuple[str, float]] = field(default_factory=list)


@contextlib.contextmanager
def profiled():
    """Profiles the block; once it ends, leaves the trace's path in the
    yielded dict under ``path``: a file in the process's temporary
    directory, which :func:`summarize` deletes."""
    import torch

    holder: dict = {}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield holder
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    prof.export_chrome_trace(path)
    holder["path"] = path


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _covered(merged: List[Tuple[float, float]], s: float, e: float, starts: List[float]) -> float:
    """Length of [s, e] that the merged intervals cover."""
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    total = 0.0
    while i < len(merged) and merged[i][0] < e:
        a, b = max(merged[i][0], s), min(merged[i][1], e)
        if b > a:
            total += b - a
        i += 1
    return total


def summarize(path: str, top: int = 10) -> Optional[TraceSummary]:
    """Read and delete the exported trace; None when it holds no window."""
    try:
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        os.unlink(path)
    window = None
    steps: List[Tuple[float, float]] = []
    dev: List[Tuple[float, float, str, bool]] = []  # start, end, label, is a kernel
    host: List[Tuple[float, float, str]] = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev.get("ts", 0.0))
        e = s + float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((s, e, name if cat == "kernel" else cat + ":" + name, cat == "kernel"))
        elif cat in HOST_CATS:
            if cat == "user_annotation" and name == WINDOW:
                window = (s, e)
            elif cat == "user_annotation" and name == STEP:
                steps.append((s, e))
            else:
                host.append((s, e, name))
    if window is None:
        return None
    w0, w1 = window
    inside = [(max(s, w0), min(e, w1), n, k) for s, e, n, k in dev if e > w0 and s < w1]
    merged = _union([(s, e) for s, e, _n, _k in inside])
    starts = [s for s, _ in merged]
    busy = sum(e - s for s, e in merged)
    per_op: Dict[str, float] = {}
    kernels: Dict[str, float] = {}
    for s, e, n, is_kernel in inside:
        per_op[n] = per_op.get(n, 0.0) + (e - s)
        if is_kernel:
            kernels[n] = kernels.get(n, 0.0) + (e - s)
    step_host = [((e - s) - _covered(merged, s, e, starts)) / 1e6 for s, e in steps if s >= w0 and e <= w1]
    gaps = []
    prev = w0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        around = [(e - s, n) for s, e, n in host if s <= mid <= e]
        named.append(("host:" + (min(around)[1] if around else "python"), (b - a) / 1e6))
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    per_host: Dict[str, float] = {}
    for s, e, n in host:
        if e > w0 and s < w1:
            per_host[n] = per_host.get(n, 0.0) + min(e, w1) - max(s, w0)
    return TraceSummary(
        window_s=(w1 - w0) / 1e6,
        busy_s=busy / 1e6,
        kernel_s=sum(kernels.values()) / 1e6,
        kernels={k: v / 1e6 for k, v in kernels.items()},
        step_host_s=step_host,
        device_ops=[(n, v / 1e6) for n, v in ops],
        idle_gaps=named,
        host_ops=[(n, v / 1e6) for n, v in sorted(per_host.items(), key=lambda kv: -kv[1])[:top]],
    )
