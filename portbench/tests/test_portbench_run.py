"""The harness end to end on the CPU: a tiny cell through the program's plain
versions (``make_mesh(["cpu"])``), the faults and the control that must come
out not correct, the result line's schema, the benchmark's files, and the
import boundary."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import run as R
from portbench.generate import make_pool

from .test_portbench_generate import tiny_config

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "mochi_tpu"}
THE_PORT = "mochi_tpu_torch"


def tiny_cell(pool_batches=2):
    cell = R.load_cell("n16_f5.ycsb_a_flush")
    cell.config = tiny_config(4, 1)
    cell.traffic = dict(cell.traffic, ops_per_step=8, pool_batches=pool_batches)
    return cell


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions at 16 lanes gain nothing from threads, and the
    tests may share the host's cores with other work."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def check_schema(result, trace):
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert set(keys) <= {"correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"}
    json.loads(json.dumps(result))  # plain JSON
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
    for name, m in result["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    for name, c in result["checks"].items():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_runs_correct_on_the_plain_versions(trace):
    cell = tiny_cell()
    result = R.run_cell(cell, 2**31 + 3, 0.5, bool(trace), "cpu")
    check_schema(result, trace)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 8 and result["attempted"] % 8 == 0
    if not trace:
        assert set(result["metrics"]) == {"ops_per_s", "step_p95_ms", "setup_s"}
    else:
        # no device operation on the CPU: the device readers find nothing
        assert result["metrics"] == {}
        assert result["device"]["busy_s"] == 0.0


def _stale(step):
    """The step returns the previous call's outputs: its state unchanged."""
    last = []

    def wrapped(*args):
        out = step(*args)
        if not last:
            last.append(out)
            return out
        prev, last[0] = last[0], out
        return prev
    return wrapped


def _half(step):
    """Half of the batch left out: the step sees the first half of the lanes."""
    def wrapped(*args):
        *arrays, threshold = args
        n = len(arrays[-1])
        bitmap, counts, committed = step(*(a[: n // 2] for a in arrays), threshold)
        return torch.cat([bitmap, torch.zeros(n - n // 2, dtype=torch.bool)]), counts, committed
    return wrapped


def _flip_verdict(step):
    """An answer altered where it is produced: the first lane's verdict."""
    def wrapped(*args):
        bitmap, counts, committed = step(*args)
        bitmap = bitmap.clone()
        bitmap[0] = ~bitmap[0]
        return bitmap, counts, committed
    return wrapped


def _flip_commit(step):
    """An answer altered where it is produced: the first slot's commit."""
    def wrapped(*args):
        bitmap, counts, committed = step(*args)
        committed = committed.clone()
        committed[0] = ~committed[0]
        return bitmap, counts, committed
    return wrapped


@pytest.mark.parametrize("fault", [_stale, _half, _flip_verdict, _flip_commit])
def test_a_broken_step_is_not_correct(fault):
    result = R.run_cell(tiny_cell(), 77, 0.2, False, "cpu", fault=fault)
    assert result["correct"] is False
    assert result["failed"] > 0
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_the_control_is_not_correct():
    """The reference without S < L, in the program's place: the malleated
    lanes verify, so verdicts and counts differ from the reference's."""
    from portbench.control import readings

    from portbench import ed25519 as E

    cell = tiny_cell()
    got = readings(cell, 6, "cpu")
    malleated = [(k, b.group_ids[i]) for k, b in enumerate(make_pool(cell.config, cell.traffic, 6))
                 for i, (p, m, s) in enumerate(zip(b.pubs, b.msgs, b.sigs))
                 if int.from_bytes(s[32:], "little") >= E.L and E.verify(p, m, s, check_s=False)]
    assert got["correct"] is False
    assert got["checks"]["lanes_wrong"] == len(malleated) > 0
    assert got["checks"]["counts_wrong"] == len(set(malleated))


def test_judge_counts_wrong_lanes_counts_and_commits():
    cell = tiny_cell()
    pool = make_pool(cell.config, cell.traffic, 4)
    want = R.expected_outputs(pool, 3, "cpu")
    v, c, m = (x.copy() for x in want[0])
    v[:2] = ~v[:2]
    c[0] += 1
    steps = [(0, 0.0, 0.0, (torch.from_numpy(v), torch.from_numpy(c), torch.from_numpy(m))),
             (1, 0.0, 0.0, tuple(torch.from_numpy(x) for x in want[1])),
             (1, 0.0, 0.0, (torch.zeros(3, dtype=torch.bool),) + tuple(torch.from_numpy(x) for x in want[1][1:]))]
    checks, failed = R.judge(steps, want, pool)
    assert {k: x["value"] for k, x in checks.items()} == {
        "lanes_wrong": 2 + pool[1].lanes, "counts_wrong": 1 + 8, "commits_wrong": 8}
    assert failed >= 1 + 8


def test_main_without_a_card_exits_nonzero_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    rc = R.main(["--workload", "n64_f21.ycsb_a_bulk", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_every_cell_metric_and_config_has_its_files():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for wl in spec["workloads"]:
        cell = R.load_cell(wl["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
        assert cell.config["name"] == wl["config"] and cell.traffic["name"] == wl["traffic"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(R.reader(m["name"]))
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_file_of_the_benchmark_imports_the_jax_stack():
    for path in (ROOT / "portbench").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


@pytest.mark.parametrize("module", ["reference", "ed25519", "generate", "roofline", "readers", "trace"])
def test_the_yardstick_imports_nothing_of_the_port(module):
    tops = {name.split(".")[0] for name in _imports(ROOT / "portbench" / f"{module}.py")}
    assert THE_PORT not in tops


def test_a_run_loads_nothing_of_the_jax_stack():
    """In a fresh process, a tiny run on the CPU with the program's modules
    loaded: no module of the JAX stack, by top-level name compared whole."""
    code = (
        "import sys, torch; torch.set_num_threads(1)\n"
        "from portbench.tests.test_portbench_run import tiny_cell\n"
        "from portbench import run as R\n"
        "r = R.run_cell(tiny_cell(), 1, 0.1, False, 'cpu')\n"
        "assert r['correct'], r\n"
        "assert any(m.startswith('mochi_tpu_torch.') for m in sys.modules)\n"
        "print(R.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_and_the_program_agree_on_counts_of_a_tiny_pool():
    """A second witness: the program's plain path and the reference give
    the same verdicts on a pool with forged and non-canonical lanes."""
    from mochi_tpu_torch.crypto.batch_verify import prepare_packed
    from mochi_tpu_torch.parallel.sharded import make_mesh, make_quorum_step
    from mochi_tpu_torch.verifier.spi import VerifyItem

    cell = tiny_cell()
    pool = make_pool(cell.config, cell.traffic, 31)
    step = make_quorum_step(make_mesh(["cpu"]), 8)
    want = R.expected_outputs(pool, 3, "cpu")
    for b, (v, c, m) in zip(pool, want):
        arrays = prepare_packed([VerifyItem(p, x, s) for p, x, s in zip(b.pubs, b.msgs, b.sigs)])
        bitmap, counts, committed = step(*arrays, b.group_ids, 3)
        assert bitmap.numpy().tolist() == v.tolist()
        assert counts.numpy().tolist() == c.tolist()
        assert committed.numpy().tolist() == m.tolist()
        assert 0 < v.sum() < len(v) and not m.all()
    assert np.isfinite(want[0][1]).all()
