"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the cluster and the YCSB workload) and a traffic mix (``traffic/<name>.json``:
operations a step, the pool of distinct batches).  The harness makes
the raw lanes from the seed (:mod:`portbench.generate`), hands them to the
system under test, ``mochi_tpu_torch.parallel.sharded.make_quorum_step`` on
one card, and in set-up packs every batch of the pool with the program's
``prepare_packed`` and steps each twice.  Then one caller, the replica's
verifier thread, runs a closed loop for ``--seconds``: the next batch of the
pool as soon as its step returns.  The process runs as the configuration's
deployment states: its verifier's intra-op threads (``assumed``), and the
collector policy of the program's server (``tune_gc_for_server``).
Every step's verdict bitmap, counts and commits are kept and, once the window
has closed and the program's state is freed, judged against the plain
reference (:mod:`portbench.reference`), which works them out again from the
raw lanes.  Each metric is read by ``metrics/<name>.py``: with ``--trace 0``
the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones, from a
``torch.profiler`` trace of a window of ``TRACE_SECONDS`` at most
(:mod:`portbench.trace`).

The last line of standard output is one JSON object; the last lines of
standard error give each number compared beside its limit.  The run exits
non-zero, printing no result, without enough cards, or when ``jax``,
``jaxlib``, ``flax`` or the JAX package is loaded once the window has closed.
"""

import time

_T0 = time.perf_counter()  # the process's start, as near as Python sees it

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, List, Optional, Tuple  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mochi_tpu")
# The longest window that a traced run profiles (the profiler's stop and
# export cost grow with its events).
TRACE_SECONDS = 5.0
# Each number compared and its limit: the comparison is exact.
LIMITS = {"lanes_wrong": 0, "counts_wrong": 0, "commits_wrong": 0}


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


@dataclass
class Run:
    """What the metric readers see of a finished run."""

    setup_s: float
    window_s: float
    step_s: List[float]
    ops_done: int
    traced_work: List[Tuple[int, int, int]] = field(default_factory=list)  # (passing lanes, lanes, slots)
    trace: Optional[object] = None


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, its files found by name."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    wl = cells[name]
    cfg_file = next(c["file"] for c in spec["configs"] if c["name"] == wl["config"])
    config = json.loads((root / cfg_file).read_text())
    traffic = json.loads((HERE / "traffic" / f"{wl['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(name, config, traffic, int(wl["chips"]), e2e, layer)


def reader(metric: str) -> Callable:
    """``metrics/<metric>.py``'s ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def power_limit_w() -> Optional[float]:
    """The card's power limit by ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _window(step, inputs, threshold: int, seconds: float, traced: bool):
    """One caller steps through the pool in turn until the window's seconds
    have passed, the next batch as soon as the step returns.  Returns
    (records: (batch, start, end, outputs), window start, window end)."""
    import torch

    from . import trace as T

    records = []
    start = time.perf_counter()
    deadline = start + seconds
    i = 0
    while True:
        k = i % len(inputs)
        with torch.profiler.record_function(T.STEP) if traced else contextlib.nullcontext():
            a = time.perf_counter()
            out = step(*inputs[k], threshold)
            b = time.perf_counter()
        records.append((k, a, b, out))
        i += 1
        if b >= deadline:
            return records, start, b


def _host_sample() -> Tuple[float, int, int, int]:
    """This process's CPU seconds, minor page faults and voluntary and
    involuntary context switches so far."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime, ru.ru_minflt, ru.ru_nvcsw, ru.ru_nivcsw


def judge(steps, expected, pool) -> Tuple[dict, int]:
    """Every step's outputs against the reference's for its batch: counts
    of wrong lanes, counts and commits (the checks), and the operations of
    slots with anything wrong."""
    wrong = dict.fromkeys(LIMITS, 0)
    failed = 0
    for k, _a, _b, out in steps:
        want_v, want_c, want_m = expected[k]
        got = [np.asarray(o) for o in out]
        if [g.shape for g in got] != [want_v.shape, want_c.shape, want_m.shape]:
            wrong["lanes_wrong"] += len(want_v)
            wrong["counts_wrong"] += len(want_c)
            wrong["commits_wrong"] += len(want_m)
            failed += pool[k].n_ops
            continue
        lw = got[0].astype(bool) != want_v
        cw = got[1].astype(np.int64) != want_c
        mw = got[2].astype(bool) != want_m
        wrong["lanes_wrong"] += int(lw.sum())
        wrong["counts_wrong"] += int(cw.sum())
        wrong["commits_wrong"] += int(mw.sum())
        bad = np.zeros(len(want_c), dtype=bool)
        bad[pool[k].group_ids[lw]] = True
        failed += int((bad | cw | mw).sum())
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in wrong.items()}, failed


def expected_outputs(pool, threshold: int, device, check_s: bool = True) -> list:
    """The reference's (verdicts, counts, commits) of each batch of the pool."""
    from .reference import Reference, tally

    every = Reference(device).verdicts([p for b in pool for p in b.pubs], [m for b in pool for m in b.msgs],
                                       [s for b in pool for s in b.sigs], check_s=check_s)
    out = []
    lo = 0
    for b in pool:
        v = every[lo: lo + b.lanes]
        lo += b.lanes
        counts, committed = tally(v, b.group_ids, b.n_ops, threshold)
        out.append((v, counts, committed))
    return out


def _log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda:0",
             t0: Optional[float] = None, fault: Optional[Callable] = None) -> dict:
    """One run of ``cell`` on ``device`` (``"cpu"`` runs the program's plain
    versions); returns the result object.  ``fault`` wraps the program's
    step (the tests break the timed path with it)."""
    import torch

    from . import trace as T
    from .generate import make_pool

    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    cuda = device.type == "cuda"
    threshold = int(cell.config["quorum"])

    marks = [("start", t0)]
    threads = cell.config.get("assumed", {}).get("verifier_intra_op_threads")
    if threads:
        torch.set_num_threads(int(threads))
    if cuda:
        torch.empty(1, device=device)  # the context and the allocator, before its peak is reset
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(("torch", time.perf_counter()))
    pool = make_pool(cell.config, cell.traffic, seed)
    marks.append(("traffic", time.perf_counter()))
    from mochi_tpu_torch.crypto.batch_verify import prepare_packed
    from mochi_tpu_torch.parallel.sharded import make_mesh, make_quorum_step
    from mochi_tpu_torch.utils.runtime import tune_gc_for_server
    from mochi_tpu_torch.verifier.spi import VerifyItem

    step = make_quorum_step(make_mesh([device]), pool[0].n_ops)
    if fault is not None:
        step = fault(step)
    marks.append(("program", time.perf_counter()))
    inputs = [(*prepare_packed([VerifyItem(p, m, s) for p, m, s in zip(b.pubs, b.msgs, b.sigs)]), b.group_ids)
              for b in pool]
    marks.append(("prepare", time.perf_counter()))
    for _ in range(2):
        for args in inputs:
            step(*args, threshold)
    if cuda:
        torch.cuda.synchronize(device)
    marks.append(("warm-up", time.perf_counter()))
    gc_before = gc.get_threshold()
    tune_gc_for_server()  # the collector policy the program's server and verifier service set
    marks.append(("gc", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    _log(f"set-up {setup_s:.3f} s (" + ", ".join(f"{n} {b - a:.3f}" for (_, a), (n, b) in zip(marks, marks[1:]))
        + f"): {len(pool)} batches of {pool[0].lanes} lanes, {pool[0].n_ops} slots; "
        f"{torch.get_num_threads()} intra-op threads, {len(os.sched_getaffinity(0))} cores")

    host0 = _host_sample()
    try:
        if trace:
            with T.profiled() as holder:
                with torch.profiler.record_function(T.WINDOW):
                    steps, w0, w1 = _window(step, inputs, threshold, min(seconds, TRACE_SECONDS), True)
                if cuda:
                    torch.cuda.synchronize(device)
        else:
            steps, w0, w1 = _window(step, inputs, threshold, seconds, False)
            if cuda:
                torch.cuda.synchronize(device)
    finally:
        gc.set_threshold(*gc_before)
        gc.unfreeze()
    host1 = _host_sample()
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    ends = np.asarray([b for _k, _a, b, _o in steps]) - w0
    per_s = np.bincount(ends.astype(np.int64), weights=[pool[k].n_ops for k, *_ in steps])
    q = np.percentile([b - a for _k, a, b, _o in steps], [5, 50, 95, 100]) * 1e3
    cpu_s, faults, vcs, ivcs = (b - a for a, b in zip(host0, host1))
    _log(f"window {w1 - w0:.3f} s, {len(steps)} steps; step ms p5 {q[0]:.3f} p50 {q[1]:.3f} p95 {q[2]:.3f} "
        f"max {q[3]:.3f}; ops each second {per_s.astype(int).tolist()}; host: {cpu_s / (w1 - w0):.2f} cores busy, "
        f"a step {faults / len(steps):.1f} minor faults, {vcs / len(steps):.1f} / {ivcs / len(steps):.2f} "
        f"voluntary / involuntary switches")
    run = Run(setup_s=setup_s, window_s=w1 - w0, step_s=[b - a for _k, a, b, _o in steps],
              ops_done=sum(pool[k].n_ops for k, *_ in steps))
    if trace:
        run.traced_work = [(pool[k].n_canonical, pool[k].lanes, pool[k].n_ops) for k, *_ in steps]
        t_sum = time.perf_counter()
        run.trace = T.summarize(holder["path"])
        _log(f"trace read in {time.perf_counter() - t_sum:.3f} s")
    del step, inputs
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    expected = expected_outputs(pool, threshold, device)
    checks, failed = judge(steps, expected, pool)
    _log(f"reference {time.perf_counter() - t_ref:.3f} s over {sum(b.lanes for b in pool)} lanes; "
        f"{len(steps)} steps judged")

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": bool(steps) and all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": run.ops_done, "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        t = run.trace
        dev["busy_s"] = t.busy_s if t else 0.0
        dev["window_s"] = t.window_s if t else run.window_s
        if cuda:
            dev["power_limit_w"] = power_limit_w()
        if t:
            result["breakdown"] = {"device_ops": [list(x) for x in t.device_ops],
                                   "idle_gaps": [list(x) for x in t.idle_gaps]}
            _log(f"trace: busy {t.busy_s:.6f} s of {t.window_s:.6f} s; kernels {t.kernel_s:.6f} s "
                f"{ {k: round(v, 6) for k, v in t.kernels.items()} }; power limit {dev.get('power_limit_w')} W; "
                f"host ms a step {[(n, round(1e3 * v / len(steps), 3)) for n, v in t.host_ops]}")
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", t0=_T0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of the JAX stack are loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
