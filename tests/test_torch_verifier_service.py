"""Verifier RPC service on the port: the shared-card sidecar boundary.

A real multi-process cluster has one TPU owner; these tests prove the
service + RemoteVerifier pair end to end — in-process for speed (the
transport is the same real asyncio TCP the cluster uses), and via a full
``VirtualCluster`` whose replicas all route certificate checks through one
shared service.
"""

import asyncio

import pytest

from mochi_tpu_torch.client import TransactionBuilder
from mochi_tpu_torch.crypto.keys import generate_keypair
from mochi_tpu_torch.testing import VirtualCluster
from mochi_tpu_torch.verifier.service import RemoteVerifier, VerifierService
from mochi_tpu_torch.verifier.spi import CpuVerifier, VerifyItem


def run(coro):
    asyncio.run(asyncio.wait_for(coro, timeout=120))


def make_items(n, forge=()):
    kp = generate_keypair()
    items = []
    for i in range(n):
        msg = b"svc message %d" % i
        sig = kp.sign(msg)
        if i in forge:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        items.append(VerifyItem(kp.public_key, msg, sig))
    return items


def test_remote_verify_mixed_batch():
    async def main():
        service = VerifierService(port=0, verifier=CpuVerifier())
        await service.start()
        rv = RemoteVerifier("127.0.0.1", service.bound_port)
        try:
            bitmap = await rv.verify_batch(make_items(8, forge={2, 5}))
            assert bitmap == [True, True, False, True, True, False, True, True]
            assert rv.remote_batches == 1 and rv.fallback_batches == 0
            assert service.requests == 1 and service.items == 8
        finally:
            await rv.close()
            await service.close()

    run(main())


def test_remote_verifier_falls_back_when_service_down():
    async def main():
        # nothing listening on this port
        rv = RemoteVerifier("127.0.0.1", 1, timeout_s=2.0)
        try:
            bitmap = await rv.verify_batch(make_items(4, forge={1}))
            # fallback still verifies (never skips): forged item rejected
            assert bitmap == [True, False, True, True]
            assert rv.fallback_batches == 1
        finally:
            await rv.close()

    run(main())


def test_shared_secret_authenticates_both_directions():
    async def main():
        secret = bytes(range(32))
        service = VerifierService(port=0, verifier=CpuVerifier(), secret=secret)
        await service.start()
        try:
            # matching secret: verdicts flow
            rv = RemoteVerifier("127.0.0.1", service.bound_port, secret=secret)
            bitmap = await rv.verify_batch(make_items(4, forge={1}))
            assert bitmap == [True, False, True, True]
            assert rv.remote_batches == 1 and rv.fallback_batches == 0
            await rv.close()

            # client without the secret: request rejected fast, local
            # fallback still verifies correctly (never trusts the network)
            rv2 = RemoteVerifier("127.0.0.1", service.bound_port, timeout_s=5.0)
            bitmap = await rv2.verify_batch(make_items(4, forge={2}))
            assert bitmap == [True, True, False, True]
            assert rv2.fallback_batches == 1
            await rv2.close()

            # client with a WRONG secret: its own MAC check rejects the
            # response path symmetrically -> fallback
            rv3 = RemoteVerifier(
                "127.0.0.1", service.bound_port, timeout_s=5.0, secret=bytes(32)
            )
            bitmap = await rv3.verify_batch(make_items(3))
            assert bitmap == [True, True, True]
            assert rv3.fallback_batches == 1
            await rv3.close()
        finally:
            await service.close()

    run(main())


def test_cluster_routes_cert_checks_through_shared_service():
    async def main():
        service = VerifierService(port=0, verifier=CpuVerifier())
        await service.start()
        port = service.bound_port
        try:
            async with VirtualCluster(
                4, rf=4,
                verifier_factory=lambda: RemoteVerifier("127.0.0.1", port),
            ) as vc:
                client = vc.client()
                await client.execute_write_transaction(
                    TransactionBuilder().write("svc-key", b"v").build()
                )
                res = await client.execute_read_transaction(
                    TransactionBuilder().read("svc-key").build()
                )
                assert res.operations[0].value == b"v"
                # every replica's envelope/cert checks went through the one
                # service process-equivalent
                assert service.requests >= 4
                for r in vc.replicas:
                    assert isinstance(r.verifier, RemoteVerifier)
                    assert r.verifier.fallback_batches == 0
        finally:
            await service.close()

    run(main())


def test_cluster_survives_service_death_and_recovery():
    """Kill the shared verifier service mid-traffic: replicas must fall
    back to local CPU verification (availability degrades, safety holds),
    and when a service returns on the same port they must resume routing
    through it — each RemoteVerifier retries the remote path per batch."""

    async def main():
        service = VerifierService(port=0, verifier=CpuVerifier())
        await service.start()
        port = service.bound_port
        async with VirtualCluster(
            4, rf=4,
            verifier_factory=lambda: RemoteVerifier("127.0.0.1", port),
        ) as vc:
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("sd-1", b"a").build()
            )
            assert service.requests > 0

            # service dies mid-run
            await service.close()
            await client.execute_write_transaction(
                TransactionBuilder().write("sd-2", b"b").build()
            )
            res = await client.execute_read_transaction(
                TransactionBuilder().read("sd-2").build()
            )
            assert res.operations[0].value == b"b"
            assert any(
                r.verifier.fallback_batches > 0 for r in vc.replicas
            ), "no replica fell back while the service was down"

            # a new service on the SAME port: replicas resume using it
            service2 = VerifierService(port=port, verifier=CpuVerifier())
            await service2.start()
            try:
                await client.execute_write_transaction(
                    TransactionBuilder().write("sd-3", b"c").build()
                )
                res = await client.execute_read_transaction(
                    TransactionBuilder().read("sd-3").build()
                )
                assert res.operations[0].value == b"c"
                assert service2.requests > 0, "replicas never returned to the service"
            finally:
                await service2.close()

    run(main())


def test_service_status_counters_and_admin_endpoint():
    """status() reports request/item/cache counters, and the standalone
    CLI's --admin-port serves them as JSON over loopback HTTP."""
    import json
    import urllib.request

    from mochi_tpu_torch.crypto import keys
    from mochi_tpu_torch.verifier.service import ServiceAdminServer, VerifierService
    from mochi_tpu_torch.verifier.spi import VerifyItem

    async def main():
        svc = VerifierService(port=0, verifier=CpuVerifier())
        await svc.start()
        admin = ServiceAdminServer(svc, port=0)
        await admin.start()
        try:
            rv = RemoteVerifier("127.0.0.1", svc.bound_port)
            kp = keys.generate_keypair()
            items = [VerifyItem(kp.public_key, b"s", kp.sign(b"s"))] * 6
            assert await rv.verify_batch(items) == [True] * 6
            await rv.close()

            st = svc.status()
            assert st["requests"] == 1 and st["items"] == 6
            vs = st["verifier"]
            assert vs["type"] == "CachingVerifier"
            assert vs["hits"] == 5 and vs["misses"] == 1
            assert vs["inner"]["type"] == "CpuVerifier"
            assert st["authenticated"] is False

            port = admin.bound_port
            raw = await asyncio.to_thread(
                lambda: urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/status", timeout=5
                ).read()
            )
            assert json.loads(raw) == st

            prom = (
                await asyncio.to_thread(
                    lambda: urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics.prom", timeout=5
                    ).read()
                )
            ).decode()
            assert 'mochi_verifier_service{name="requests"} 1' in prom
            assert 'mochi_verifier_service{name="items"} 6' in prom
            assert 'mochi_verifier_service{name="verifier_hits"} 5' in prom
        finally:
            await admin.close()
            await svc.close()

    run(main())


@pytest.mark.slow
def test_sharded_backend_over_cpu_mesh():
    """ShardedCudaBatchVerifier splits a mixed batch over a mesh of 8
    slices on the CPU (the plain versions) and returns the same bitmap the
    CPU verifier would — the production multi-card path, not just the
    benchmark one."""
    import asyncio

    from mochi_tpu_torch.crypto import keys
    from mochi_tpu_torch.verifier.spi import VerifyItem
    from mochi_tpu_torch.verifier.cuda import ShardedCudaBatchVerifier

    kp = keys.generate_keypair()
    items = []
    expect = []
    for i in range(50):
        msg = b"sh%d" % i
        sig = kp.sign(msg)
        if i % 6 == 2:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
            expect.append(False)
        else:
            expect.append(True)
        items.append(VerifyItem(kp.public_key, msg, sig))

    async def main():
        # min_device_items=0: force the mesh path (a CPU crossover would
        # otherwise route this small batch to the host verify and the test
        # would never exercise the slices)
        v = ShardedCudaBatchVerifier(devices=["cpu"] * 8, max_delay_s=0.001, min_device_items=0)
        try:
            assert v.backend.n_devices == 8
            out = await v.verify_batch(items)
            assert out == expect
        finally:
            await v.close()

    asyncio.run(main())


def test_service_speaks_the_reference_wire_both_ways():
    """The port's RemoteVerifier against the reference's VerifierService,
    and the reference's RemoteVerifier against the port's, each with a
    shared secret: the bitmaps equal the local verdicts and nothing falls
    back to local verification."""
    from mochi_tpu.verifier.service import RemoteVerifier as RefRemote
    from mochi_tpu.verifier.service import VerifierService as RefService
    from mochi_tpu.verifier.spi import CpuVerifier as RefCpu
    from mochi_tpu.verifier.spi import VerifyItem as RefItem

    secret = b"\x42" * 32
    items = make_items(12, forge={3, 7})
    want = [i not in (3, 7) for i in range(12)]

    async def main():
        for service_cls, cpu_cls, remote_cls, item_cls in ((RefService, RefCpu, RemoteVerifier, VerifyItem),
                                                           (VerifierService, CpuVerifier, RefRemote, RefItem)):
            service = service_cls(port=0, verifier=cpu_cls(), secret=secret)
            await service.start()
            rv = remote_cls("127.0.0.1", service.bound_port, secret=secret)
            try:
                got = await rv.verify_batch([item_cls(i.public_key, i.message, i.signature) for i in items])
                assert got == want and rv.remote_batches == 1 and rv.fallback_batches == 0
            finally:
                await rv.close()
                await service.close()

    run(main())
