"""The port's process entry points: ``python -m mochi_tpu_torch.tools.gen_cluster``
and ``python -m mochi_tpu_torch.server``.

``--verifier cpu`` boots a replica that prints ``READY`` and drains on
SIGTERM; the default, ``--verifier cuda``, refuses to start where there is
no CUDA device instead of verifying on the CPU.
"""

import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env.update(extra)
    return env


def _gen(tmp_path):
    out = tmp_path / "cluster"
    subprocess.run(
        [sys.executable, "-m", "mochi_tpu_torch.tools.gen_cluster", "--out-dir", str(out),
         "--servers", "4", "--rf", "4", "--base-port", "0"],
        cwd=tmp_path, env=_env(), check=True, capture_output=True, timeout=120,
    )
    # server-0 listens on port 0: an ephemeral port, so runs never collide
    assert json.loads((out / "cluster_config.json").read_text())
    assert sorted(p.name for p in out.glob("*.seed")) == [f"server-{i}.seed" for i in range(4)]
    return out


def test_cpu_replica_prints_ready_and_drains(tmp_path):
    out = _gen(tmp_path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "mochi_tpu_torch.server", "--config", str(out / "cluster_config.json"),
         "--server-id", "server-0", "--seed-file", str(out / "server-0.seed"), "--verifier", "cpu"],
        cwd=tmp_path, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.time() + 120
        line = ""
        while time.time() < deadline and not line.startswith("READY"):
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                break
        assert line.startswith("READY server-0 "), proc.stderr.read() if proc.poll() is not None else line
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_cuda_verifier_without_a_card_exits_and_says_so(tmp_path):
    out = _gen(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "mochi_tpu_torch.server", "--config", str(out / "cluster_config.json"),
         "--server-id", "server-0", "--seed-file", str(out / "server-0.seed")],
        cwd=tmp_path, env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "READY" not in proc.stdout
    assert "no CUDA device" in proc.stderr
