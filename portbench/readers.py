"""What each metric file reads from a finished run (:class:`portbench.run.Run`).

A reader returns a number or None; None leaves the metric out of the line
(nothing to read: no trace, no device operation in it, no step)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import roofline


def ops_per_s(run) -> Optional[float]:
    """Operations of every step completed in the window, over its seconds."""
    if not run.step_s or run.window_s <= 0:
        return None
    return run.ops_done / run.window_s


def step_p95_ms(run) -> Optional[float]:
    """95th percentile of every step's wall time in the window."""
    if not run.step_s:
        return None
    return float(np.percentile(np.asarray(run.step_s), 95)) * 1e3


def setup_s(run) -> Optional[float]:
    return run.setup_s


def kernels_roofline(run) -> Optional[float]:
    """Percent: the traced steps' least kernel time over the kernels' time."""
    t = run.trace
    if t is None or t.kernel_s <= 0 or not run.traced_work:
        return None
    least = sum(roofline.least_seconds(*w) for w in run.traced_work)
    return 100.0 * least / t.kernel_s


def device_idle_pct(run) -> Optional[float]:
    """Percent of the traced window in which no device operation ran."""
    t = run.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def step_host_ms(run) -> Optional[float]:
    """Mean over the traced steps of the step's span less the device-busy
    time inside it."""
    t = run.trace
    if t is None or t.busy_s <= 0 or not t.step_host_s:
        return None
    return 1e3 * float(np.mean(t.step_host_s))
