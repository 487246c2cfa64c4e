"""The program's step spans inside the harness's traced window, on one clock.

A traced run of the tiny cell keeps its exported trace (a wrapper around
:func:`portbench.trace.summarize`) and checks that the window holds one
``mochi.quorum_step`` span for each ``portbench.step`` span, each inside
its own.  The card case runs with
``python3 -m pytest -m cuda portbench/tests/test_portbench_spans.py``.
"""

import json

import pytest
import torch

from portbench import run as R
from portbench import trace as T

from .test_portbench_run import check_schema, tiny_cell


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-2


@pytest.fixture(params=["cpu", pytest.param("cuda:0", marks=pytest.mark.cuda)])
def device(request):
    if request.param != "cpu" and not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels have no CPU mode")
    return request.param


def test_step_spans_lie_inside_the_harness_steps(device, monkeypatch):
    kept = {}
    summarize = T.summarize

    def keep(path, *a, **k):
        with open(path) as fh:
            kept["events"] = json.load(fh)["traceEvents"]
        return summarize(path, *a, **k)

    monkeypatch.setattr(T, "summarize", keep)
    result = R.run_cell(tiny_cell(), 2**31 + 24, 0.5, True, device)
    check_schema(result, 1)
    assert result["correct"] is True
    events = [e for e in kept["events"] if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    [window] = [e for e in events if e["name"] == T.WINDOW]
    harness = [e for e in events if e["name"] == T.STEP and _inside(e, window)]
    steps = [e for e in events if e["name"] == "mochi.quorum_step" and _inside(e, window)]
    assert harness and len(steps) == len(harness)
    for outer in harness:
        assert len([e for e in steps if _inside(e, outer)]) == 1
