"""The port's ``ProcessCluster``: replicas in real ``python -m
mochi_tpu_torch.server`` processes, on the CPU.

Ported from the JAX package's ``tests/test_process_cluster.py``: a
transaction spanning two shards commits atomically over two processes;
it still commits with one owning replica SIGKILLed between grant assembly
and the Write2 dispatch; and it aborts on both shards when one shard has
lost its quorum.  Added: the same seeded writes through a process cluster
of each package read back the same map; ``byzantine=`` is refused until the
Byzantine harnesses land; and the default ``verifier="cuda"`` fails at boot
where there is no card, with the child's own words, instead of verifying on
the CPU.  Every child here runs ``--verifier cpu``, which imports no torch.
"""

from __future__ import annotations

import asyncio
from typing import Tuple

import numpy as np
import pytest

from mochi_tpu.client.txn import TransactionBuilder as JTransactionBuilder
from mochi_tpu.crypto.keys import keypair_from_seed as jkeypair_from_seed
from mochi_tpu.testing import process_cluster as jprocess_cluster
from mochi_tpu_torch.client.client import MochiDBClient
from mochi_tpu_torch.client.errors import RequestRefused
from mochi_tpu_torch.client.txn import TransactionBuilder
from mochi_tpu_torch.crypto.keys import keypair_from_seed
from mochi_tpu_torch.testing import ProcessCluster
from mochi_tpu_torch.testing import process_cluster


def _cross_shard_keys(config, prefix: str = "ps") -> Tuple[str, str, str]:
    """Two keys with different replica sets, plus a replica that owns the
    first key but NOT the second (the f=1 kill victim: its loss leaves the
    second shard's set whole and the first with exactly a quorum)."""
    for i in range(4096):
        k1 = f"{prefix}-a-{i}"
        s1 = set(config.replica_set_for_key(k1))
        for j in range(4096):
            k2 = f"{prefix}-b-{j}"
            s2 = set(config.replica_set_for_key(k2))
            if s2 != s1 and (s1 - s2):
                return k1, k2, sorted(s1 - s2)[0]
    raise AssertionError("no cross-shard key pair found (ring degenerate?)")


def test_cross_shard_transaction_two_processes():
    """2 replica processes, one cross-shard commit, both shards serve reads;
    the SIGTERM teardown is a graceful drain (every child exits 0)."""

    async def body():
        async with ProcessCluster(n_servers=6, rf=4, n_processes=2, verifier="cpu") as pc:
            k1, k2, _ = _cross_shard_keys(pc.config)
            client = pc.client(timeout_s=8.0)
            await client.execute_write_transaction(
                TransactionBuilder().write(k1, b"v1").write(k2, b"v2").build()
            )
            # separate reads, so each is answered by its own replica set
            r1 = await client.execute_read_transaction(TransactionBuilder().read(k1).build())
            r2 = await client.execute_read_transaction(TransactionBuilder().read(k2).build())
            assert r1.operations[0].value == b"v1"
            assert r2.operations[0].value == b"v2"
            pc.check_alive()
        assert set(pc.returncodes.values()) == {0}, pc.returncodes

    asyncio.run(asyncio.wait_for(body(), timeout=120))


def test_cross_shard_commit_survives_replica_kill_mid_write2():
    """f=1 within one shard's replica set: an owning replica SIGKILLed
    after grants are assembled but before Write2 dispatches — the
    transaction still commits on BOTH shards (quorum 2f+1 survives)."""

    async def body():
        # process-per-replica so the SIGKILL takes down exactly one replica
        async with ProcessCluster(n_servers=6, rf=4, n_processes=6, verifier="cpu") as pc:
            k1, k2, victim = _cross_shard_keys(pc.config)
            client = pc.client(timeout_s=8.0)
            # warm sessions/connections off the fault path
            await client.execute_write_transaction(
                TransactionBuilder().write(k1, b"w").write(k2, b"w").build()
            )
            orig_write2 = MochiDBClient._write2
            killed = []

            async def kill_then_write2(self, transaction, certificate, tt=None):
                if not killed:
                    killed.append(pc.kill_replica(victim))
                    await asyncio.sleep(0.05)  # let the SIGKILL land
                return await orig_write2(self, transaction, certificate, tt)

            client._write2 = kill_then_write2.__get__(client)
            await client.execute_write_transaction(
                TransactionBuilder().write(k1, b"v1").write(k2, b"v2").build()
            )
            assert killed, "fault injection never fired"
            client._write2 = orig_write2.__get__(client)
            r1 = await client.execute_read_transaction(TransactionBuilder().read(k1).build())
            r2 = await client.execute_read_transaction(TransactionBuilder().read(k2).build())
            assert r1.operations[0].value == b"v1"
            assert r2.operations[0].value == b"v2"

    asyncio.run(asyncio.wait_for(body(), timeout=180))


def test_cross_shard_abort_when_one_shard_lost_quorum():
    """Beyond f within one shard: the cross-shard transaction aborts on
    BOTH shards — the client never dispatches Write2 without per-key
    quorum grants, so the healthy shard stays unwritten."""

    async def body():
        async with ProcessCluster(n_servers=6, rf=4, n_processes=6, verifier="cpu") as pc:
            k1, k2, _ = _cross_shard_keys(pc.config)
            s1 = set(pc.config.replica_set_for_key(k1))
            s2 = set(pc.config.replica_set_for_key(k2))
            client = pc.client(timeout_s=4.0, write_attempts=3, refusal_retries=1)
            # two k1-owning victims, preferring replicas OUTSIDE k2's set
            victims = (sorted(s1 - s2) + sorted(s1 & s2))[:2]
            assert len(s2 - set(victims)) >= pc.config.quorum
            for v in victims:
                pc.kill_replica(v)
            await asyncio.sleep(0.1)
            with pytest.raises(RequestRefused):
                await client.execute_write_transaction(
                    TransactionBuilder().write(k1, b"v1").write(k2, b"v2").build()
                )
            r2 = await client.execute_read_transaction(TransactionBuilder().read(k2).build())
            assert not r2.operations[0].existed

    asyncio.run(asyncio.wait_for(body(), timeout=180))


def _seeded_keypairs(monkeypatch, module, from_seed, n: int):
    """Make ``module``'s cluster identities the keypairs of seeds 0..n-1."""
    seeds = iter(bytes([i]) * 32 for i in range(n))
    monkeypatch.setattr(module, "generate_keypair", lambda: from_seed(next(seeds)))


def _write_script(seed: int, n: int):
    """A seeded sequence of transactions over a few keys: writes, two-key
    writes, overwrites and deletes, as (kind, key, second key, value), then
    a delete of the first key; the keys to read back include one never
    written."""
    rng = np.random.default_rng(seed)
    keys = [f"diff-{i}" for i in range(6)]
    script = []
    for step in range(n):
        a, b = (keys[i] for i in rng.choice(len(keys), 2, replace=False))
        kind = ("write", "pair", "delete")[int(rng.integers(0, 3))]
        script.append((kind, a, b, b"v%d-%d" % (step, int(rng.integers(0, 1 << 20)))))
    script.append(("delete", keys[0], None, b""))
    return keys + ["diff-never"], script


async def _read_back_map(pc, tb, seed: int):
    keys, script = _write_script(seed, 12)
    client = pc.client(timeout_s=8.0)
    for kind, a, b, value in script:
        if kind == "write":
            txn = tb().write(a, value).build()
        elif kind == "pair":
            txn = tb().write(a, value).write(b, value + b"'").build()
        else:
            txn = tb().delete(a).build()
        await client.execute_write_transaction(txn)
    out = {}
    for key in keys:
        op = (await client.execute_read_transaction(tb().read(key).build())).operations[0]
        grants = len(op.current_certificate.grants) if op.current_certificate is not None else 0
        out[key] = (op.existed, bytes(op.value) if op.value is not None else None, grants)
    return out


@pytest.mark.parametrize("seed", [3, 11])
def test_same_seeded_writes_read_back_the_same_map_in_both_packages(monkeypatch, seed):
    """The same identity seeds and the same seeded writes through a
    ``ProcessCluster(4, rf=4, n_processes=2)`` of each package (the
    reference's children on its own CPU posture) read back the same map:
    existence, value and certificate size of every key."""
    _seeded_keypairs(monkeypatch, process_cluster, keypair_from_seed, 4)
    _seeded_keypairs(monkeypatch, jprocess_cluster, jkeypair_from_seed, 4)

    async def body():
        async with ProcessCluster(4, rf=4, n_processes=2, verifier="cpu") as pc:
            mine = await _read_back_map(pc, TransactionBuilder, seed)
        async with jprocess_cluster.ProcessCluster(4, rf=4, n_processes=2) as jpc:
            assert jpc.config.public_keys == pc.config.public_keys
            ref = await _read_back_map(jpc, JTransactionBuilder, seed)
        return mine, ref

    mine, ref = asyncio.run(asyncio.wait_for(body(), timeout=180))
    assert mine == ref
    assert any(existed for existed, _, _ in mine.values())
    assert any(not existed for existed, _, _ in mine.values())


@pytest.mark.parametrize("how", ["constructor", "client"])
def test_byzantine_postures_are_refused(how):
    """``byzantine=`` and ``byzantine_client()`` raise until the Byzantine
    harnesses are ported; the constructor refuses before any process starts."""
    if how == "constructor":
        with pytest.raises(NotImplementedError, match="not ported"):
            ProcessCluster(4, rf=4, verifier="cpu", byzantine={"server-1": "silent"})
    else:
        with pytest.raises(NotImplementedError, match="not ported"):
            ProcessCluster(4, rf=4, verifier="cpu").byzantine_client("withhold")


def test_cuda_children_fail_at_boot_without_a_card():
    """The default posture puts the card in every child; without one the
    child exits before READY and ``start()`` raises with its log tail,
    which carries the server's own "no CUDA device" message."""

    async def body():
        pc = ProcessCluster(4, rf=4, n_processes=2, env={"CUDA_VISIBLE_DEVICES": ""}, ready_timeout_s=120)
        assert pc.verifier == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device") as err:
            await pc.start()
        assert "died before READY" in str(err.value)
        assert pc.processes == [] and all(rc != 0 for rc in pc.returncodes.values())

    asyncio.run(asyncio.wait_for(body(), timeout=180))


def test_sidecar_posture_routes_every_replica_through_the_service():
    """``verifier="service"``: one sidecar (here ``--backend cpu``) with
    the replica identities as its known signers; every replica's admin
    shell shows a ``RemoteVerifier`` under the coalescer with no fallback,
    the service's shell counts the requests, and ``cpu_seconds`` names
    every child."""
    import json
    import urllib.request

    from chip_smoke import free_port_range

    def status(port):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/status", timeout=10) as resp:
            return json.loads(resp.read().decode())

    async def body():
        base = free_port_range(4 * 2 + 1)
        async with ProcessCluster(4, rf=4, n_processes=2, verifier="service", service_backend="cpu",
                                  admin_base_port=base) as pc:
            assert pc.service_admin_port == base + 8
            client = pc.client(timeout_s=8.0)
            await client.execute_write_transaction(TransactionBuilder().write("sc", b"v").build())
            loop = asyncio.get_running_loop()
            for sid in pc.config.servers:
                st = await loop.run_in_executor(None, status, pc.admin_port(sid))
                assert st["server_id"] == sid
                assert st["verifier"]["type"] == "CoalescingVerifier"
                assert st["verifier"]["inner"]["type"] == "RemoteVerifier"
                assert st["verifier"]["inner"]["fallback_batches"] == 0
            svc = await loop.run_in_executor(None, status, pc.service_admin_port)
            assert svc["service_id"] == "verifier-service" and svc["requests"] > 0
            assert svc["verifier"]["type"] == "CachingVerifier"
            assert sorted(pc.cpu_seconds()) == ["proc-0", "proc-1", "verifier-service"]
            assert sorted(pc.ready_seconds) == ["proc-0", "proc-1", "verifier-service"]
        assert set(pc.returncodes.values()) == {0}, pc.returncodes

    asyncio.run(asyncio.wait_for(body(), timeout=120))


def test_unknown_service_backend_is_refused():
    with pytest.raises(ValueError, match="service_backend"):
        ProcessCluster(4, rf=4, verifier="service", service_backend="tpu")
