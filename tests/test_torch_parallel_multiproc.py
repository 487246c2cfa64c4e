"""The port's multi-process quorum step: two OS processes, one gloo group.

Runs ``mochi_tpu_torch.parallel.multihost._demo_main`` in two subprocesses
with ``--backend gloo`` (the plain versions on the CPU; on cards the same
code runs with ``--backend nccl``, one process per card, as
``chip_smoke.py`` runs it), and asserts what
``tests/test_parallel_multiproc.py`` asserts of the reference's two-process
mesh: both processes join one group, the quorum slots are summed across the
process boundary, and both hold the same closed-form tally.  The
reference's version of this test skips on this host (its CPU backend has no
multiprocess collectives); this one runs.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_quorum_step():
    port = _free_port()
    lanes = 8  # per process; lanes i % 4 == 3 corrupted, group = i % 3
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "mochi_tpu_torch.parallel.multihost", "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(pid), "--lanes-per-process", str(lanes),
             "--backend", "gloo"],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in (0, 1)
    ]
    try:
        results = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for p, (out, err) in zip(procs, results):
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))

    # Closed form, as tests/test_parallel_multiproc.py computes it: per
    # process lanes 0..7 vote for groups i % 3, lanes {3, 7} are corrupted.
    valid_per_group = [0, 0, 0]
    for i in range(lanes):
        if i % 4 != 3:
            valid_per_group[i % 3] += 1
    expected = [2 * v for v in valid_per_group]  # two identical processes
    assert expected == [4, 4, 4]

    assert sorted(rec["process_id"] for rec in outs) == [0, 1]
    for rec in outs:
        assert rec["process_count"] == 2 and rec["backend"] == "gloo"
        assert rec["local_devices"] == 1 and rec["global_devices"] == 2
        assert rec["counts"] == expected, rec
        assert rec["committed"] == [c >= 3 for c in expected]
        assert rec["local_valid"] == sum(valid_per_group)
        assert rec["comb_local_valid"] == sum(valid_per_group)
