"""The trace reader and the per-layer readers on a hand-built trace."""

import json

from portbench import readers, roofline
from portbench.run import Run
from portbench.trace import summarize


def write_trace(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


EVENTS = [  # microseconds: a 100 us window of two steps
    {"ph": "X", "cat": "user_annotation", "name": "portbench.window", "ts": 0, "dur": 100},
    {"ph": "X", "cat": "user_annotation", "name": "portbench.step", "ts": 0, "dur": 50},
    {"ph": "X", "cat": "user_annotation", "name": "portbench.step", "ts": 50, "dur": 50},
    {"ph": "X", "cat": "kernel", "name": "void at::native::k<int>(int)", "ts": 10, "dur": 20},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 25, "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "mochi_k", "ts": 60, "dur": 30},
    {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 36, "dur": 20},
    {"ph": "X", "cat": "cpu_op", "name": "aten::pin_memory", "ts": 30, "dur": 40},
    {"ph": "X", "cat": "kernel", "name": "outside", "ts": 200, "dur": 30},
]


def test_summary_of_a_hand_built_trace(tmp_path):
    path = write_trace(tmp_path, EVENTS)
    t = summarize(path)
    assert not (tmp_path / "trace.json").exists()  # read once, then deleted
    assert abs(t.window_s - 100e-6) < 1e-12
    assert abs(t.busy_s - 55e-6) < 1e-12  # [10, 35] and [60, 90]
    assert abs(t.kernel_s - 50e-6) < 1e-12  # kernels only, a name with "::" included
    assert [round(x * 1e6) for x in t.step_host_s] == [25, 20]
    # the longest gap, [35, 60], named by the innermost host op at its middle
    assert t.idle_gaps[0][0] == "host:aten::copy_" and round(t.idle_gaps[0][1] * 1e6) == 25
    assert [round(v * 1e6) for _, v in t.idle_gaps] == [25, 10, 10]
    assert t.device_ops[0] == ("mochi_k", 30e-6)
    # host operations by name, each cut to the window, nested ones counted in each
    assert [(n, round(v * 1e6)) for n, v in t.host_ops] == [("aten::pin_memory", 40), ("aten::copy_", 20)]


def test_readers_of_a_run(tmp_path):
    t = summarize(write_trace(tmp_path, EVENTS))
    run = Run(setup_s=3.0, window_s=2.0, step_s=[0.01] * 19 + [0.03], ops_done=40, trace=t,
              traced_work=[(1000, 1024, 16), (1000, 1024, 16)])
    assert readers.ops_per_s(run) == 20.0
    assert 0.01 < readers.step_p95_ms(run) / 1e3 < 0.03
    assert readers.setup_s(run) == 3.0
    assert abs(readers.device_idle_pct(run) - 45.0) < 1e-9
    assert abs(readers.step_host_ms(run) - 0.0225) < 1e-9
    least = 2 * roofline.least_seconds(1000, 1024, 16)
    assert abs(readers.kernels_roofline(run) - 100 * least / 50e-6) < 1e-9
    assert readers.kernels_roofline(Run(1.0, 1.0, [], 0)) is None  # nothing traced: nothing read
    assert readers.ops_per_s(Run(1.0, 1.0, [], 0)) is None
