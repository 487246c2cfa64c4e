"""The port's deployment surface in real OS processes, on the CPU.

Ported from the JAX package's ``tests/test_multiproc_cluster.py``:
``python -m mochi_tpu_torch.tools.gen_cluster`` → ``python -m
mochi_tpu_torch.server`` × N beside one ``python -m
mochi_tpu_torch.verifier.service`` (``--backend cpu``) → the client SDK in
this process; and a supervisor's SIGTERM runs the graceful close path, whose
final snapshot a fresh store loads.  Ports are picked free at run time, so
these never collide with the JAX package's copies.  Added: the admin shells
(``--admin-port``) of a replica and of the service answer over loopback.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

from chip_smoke import free_port_range

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _gen(out: str, servers: int, base: int, env) -> str:
    subprocess.run(
        [sys.executable, "-m", "mochi_tpu_torch.tools.gen_cluster", "--out-dir", out,
         "--servers", str(servers), "--rf", "4", "--base-port", str(base)],
        check=True, env=env, capture_output=True, timeout=120,
    )
    return os.path.join(out, "cluster_config.json")


def _wait_listening(config, seconds: float) -> None:
    deadline = time.time() + seconds
    for info in config.servers.values():
        while time.time() < deadline:
            try:
                with socket.create_connection((info.host, info.port), 0.5):
                    break
            except OSError:
                time.sleep(0.2)
        else:
            raise AssertionError(f"cluster did not come up in {seconds}s")


def _get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
        return json.loads(resp.read().decode())


def test_multiprocess_cluster_end_to_end():
    env = _env()
    base = free_port_range(5 + 1 + 5 + 1)
    vport, admin, service_admin = base + 5, base + 6, base + 11
    procs = []
    with tempfile.TemporaryDirectory(prefix="mochi-torch-mp-") as out:
        cfg = _gen(out, 5, base, env)
        try:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "mochi_tpu_torch.verifier.service", "--port", str(vport),
                 "--backend", "cpu", "--admin-port", str(service_admin)],
                env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            ))
            for i in range(5):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "mochi_tpu_torch.server", "--config", cfg,
                     "--server-id", f"server-{i}", "--seed-file", os.path.join(out, f"server-{i}.seed"),
                     "--verifier", f"remote:127.0.0.1:{vport}", "--admin-port", str(admin + i)],
                    env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                ))
            from mochi_tpu_torch.server.__main__ import load_config

            config = load_config(cfg)
            _wait_listening(config, 60)

            async def drive():
                from mochi_tpu_torch.client.client import MochiDBClient
                from mochi_tpu_torch.client.txn import TransactionBuilder

                c = MochiDBClient(config, timeout_s=8.0)
                try:
                    await c.execute_write_transaction(TransactionBuilder().write("mp-k", b"mp-v").build())
                    res = await c.execute_read_transaction(TransactionBuilder().read("mp-k").build())
                    assert res.operations[0].value == b"mp-v"
                    cert = res.operations[0].current_certificate
                    assert cert is not None and len(cert.grants) >= config.quorum
                    await c.execute_write_transaction(TransactionBuilder().delete("mp-k").build())
                    res = await c.execute_read_transaction(TransactionBuilder().read("mp-k").build())
                    assert not res.operations[0].existed
                finally:
                    await c.close()

            asyncio.run(drive())
            # each replica process serves its shell on its own port (loopback)
            for i in range(5):
                st = _get(admin + i, "/status")
                assert st["server_id"] == f"server-{i}"
                assert st["verifier"]["inner"]["type"] == "RemoteVerifier"
            svc = _get(service_admin, "/status")
            assert svc["requests"] > 0 and svc["items"] > 0
        finally:
            for p in procs:
                p.send_signal(signal.SIGTERM)
            for p in procs:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()


def test_sigterm_flushes_final_snapshot():
    """Durability-on-TERM: a supervisor's SIGTERM runs the graceful close
    path, so the final snapshot lands on disk and a fresh store loads the
    committed key from it."""
    env = _env()
    with tempfile.TemporaryDirectory(prefix="mochi-torch-st-") as out:
        cfg = _gen(out, 4, free_port_range(4), env)
        data = os.path.join(out, "data")
        os.makedirs(data)
        procs = []
        try:
            for i in range(4):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "mochi_tpu_torch.server", "--config", cfg,
                     "--server-id", f"server-{i}", "--seed-file", os.path.join(out, f"server-{i}.seed"),
                     "--verifier", "cpu", "--data-dir", data,
                     # long interval: only the final-close snapshot can
                     # explain the file appearing after SIGTERM
                     "--snapshot-interval", "3600"],
                    env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                ))
            from mochi_tpu_torch.client.client import MochiDBClient
            from mochi_tpu_torch.client.txn import TransactionBuilder
            from mochi_tpu_torch.cluster.config import ClusterConfig

            with open(cfg) as fh:
                config = ClusterConfig.from_json(fh.read())
            _wait_listening(config, 30)

            async def drive():
                c = MochiDBClient(config, timeout_s=8.0)
                try:
                    await c.execute_write_transaction(TransactionBuilder().write("st-k", b"st-v").build())
                finally:
                    await c.close()

            asyncio.run(drive())
            for p in procs:
                p.send_signal(signal.SIGTERM)
            for p in procs:
                assert p.wait(timeout=15) == 0
            snaps = [f for f in os.listdir(data) if f.endswith(".snapshot")]
            assert len(snaps) == 4, snaps
            from mochi_tpu_torch.server.persistence import load_snapshot
            from mochi_tpu_torch.server.store import DataStore

            found = 0
            for i in range(4):
                st = DataStore(f"server-{i}", config)
                n = load_snapshot(st, os.path.join(data, f"server-{i}.snapshot"))
                sv = st._get("st-k") if n else None
                if sv is not None and sv.exists and sv.value == b"st-v":
                    found += 1
            assert found >= config.quorum, found
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
