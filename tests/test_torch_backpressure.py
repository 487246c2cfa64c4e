"""Admission control (overload shedding) mechanics.

The policy under test (``server/replica.py`` + ``server/admission.py``): a
DETERMINISTIC load signal (dispatch pressure, verify occupancy, send-queue
pressure — all event-counted, never wall-clock) drives a proportional shed
probability; Write1s are shed by a deterministic draw keyed on (client_id,
seed) so every replica sheds the same transactions (independent coin flips
would collapse the 2f+1 grant quorum); shed responses carry a typed
``OVERLOADED`` + retry-after hint the client's backoff honors; Write2 and
reads are never shed (admitted work drains); admin ops are never shed; the
client surfaces hard overload as a typed failure in bounded time.  The
reference has no admission control (``MochiServer.java:36-54`` just
queues).  Unlike the retired wall-clock loop-lag signal (OFF since the first
because harness stalls tripped it), admission defaults ON everywhere —
``test_default_admission_never_sheds_light_load`` pins the no-flake claim.
"""

from __future__ import annotations

import asyncio

import pytest

from mochi_tpu_torch.client.client import MAX_ALL_SHED_ROUNDS
from mochi_tpu_torch.client.errors import RequestRefused
from mochi_tpu_torch.client.txn import TransactionBuilder
from mochi_tpu_torch.protocol.messages import FailType, RequestFailedFromServer
from mochi_tpu_torch.testing.virtual_cluster import VirtualCluster


def _pin_shed(vc, p: float, retry_after_ms: int = 0) -> None:
    """Freeze every replica's controller at shed probability ``p`` (the
    property setter pins it) and, when given, at a fixed retry-after hint
    (update() is stubbed out so the hint survives the next Write1 batch)."""
    for r in vc.replicas:
        r._shed_p = p
        if retry_after_ms:
            r._admission.retry_after_ms = retry_after_ms
            r._admission.update = lambda: None


def test_forced_shed_bounces_writes_and_client_fails_fast():
    """With every replica's shed probability pinned to 1.0, writes must be
    shed cluster-wide and the client must fail with a typed RequestRefused
    quickly (MAX_ALL_SHED_ROUNDS all-shed rounds), not burn its whole
    retry budget."""

    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            client = vc.client(timeout_s=5.0)
            # establish sessions + working baseline
            await client.execute_write_transaction(
                TransactionBuilder().write("k", b"v").build()
            )
            _pin_shed(vc, 1.0)
            t0 = asyncio.get_event_loop().time()
            with pytest.raises(RequestRefused, match="overloaded"):
                await client.execute_write_transaction(
                    TransactionBuilder().write("k2", b"v").build()
                )
            elapsed = asyncio.get_event_loop().time() - t0
            assert elapsed < 4.0, f"give-up took {elapsed:.1f}s — not bounded"
            sheds = sum(
                r.metrics.counters.get("replica.write1-shed", 0) for r in vc.replicas
            )
            assert sheds >= 5 * 4  # >= 5 rounds x replica-set fan-out
            # reads are never shed: admitted work still completes
            res = await client.execute_read_transaction(
                TransactionBuilder().read("k").build()
            )
            assert res.operations[0].value == b"v"

    asyncio.run(main())


def test_full_overload_arc_shed_backoff_retry_after_refused():
    """The whole client arc under hard overload, end to end: Write1s shed
    with typed OVERLOADED carrying a retry-after hint -> the client's
    jittered backoff honors the hint (the inter-round wait is at least
    0.75x the hint, so total elapsed has a hard floor) -> after
    MAX_ALL_SHED_ROUNDS consecutive fully-shed rounds the client surfaces
    a typed RequestRefused."""

    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            client = vc.client(timeout_s=5.0)
            await client.execute_write_transaction(
                TransactionBuilder().write("warm", b"v").build()
            )
            hint_ms = 150
            _pin_shed(vc, 1.0, retry_after_ms=hint_ms)
            t0 = asyncio.get_event_loop().time()
            with pytest.raises(RequestRefused, match="overloaded"):
                await client.execute_write_transaction(
                    TransactionBuilder().write("k", b"v").build()
                )
            elapsed = asyncio.get_event_loop().time() - t0
            # the raise lands on round MAX_ALL_SHED_ROUNDS, after
            # (MAX_ALL_SHED_ROUNDS - 1) backoffs of >= 0.75 * hint each
            floor_s = (MAX_ALL_SHED_ROUNDS - 1) * hint_ms / 1e3 * 0.75
            assert elapsed >= floor_s, (
                f"client retried after {elapsed:.3f}s; retry-after hint of "
                f"{hint_ms}ms demands >= {floor_s:.3f}s — hint not honored"
            )
            assert elapsed < 6.0, f"give-up took {elapsed:.1f}s — not bounded"
            # the shed rounds were counted on the client (flow control, not
            # refusal budget)
            assert client.metrics.counters.get("client.write1-shed", 0) >= (
                MAX_ALL_SHED_ROUNDS
            )
            # shed responses really carried the hint on the wire
            shed_hints = [
                r._admission.retry_after_ms for r in vc.replicas
            ]
            assert all(h == hint_ms for h in shed_hints)

    asyncio.run(main())


def test_default_admission_never_sheds_light_load():
    """Admission control now defaults ON (the deterministic signal).  A
    light in-process workload — the exact posture that flaked the old
    wall-clock lag signal into shedding — must never shed: queued work
    stays far under every high-water mark."""

    async def main():
        async with VirtualCluster(5, rf=4) as vc:  # no admission override
            assert all(r._admission.enabled for r in vc.replicas)
            client = vc.client(timeout_s=5.0)
            for i in range(8):
                await client.execute_write_transaction(
                    TransactionBuilder().write(f"k{i}", b"v").build()
                )
            assert all(
                r.metrics.counters.get("replica.write1-shed", 0) == 0
                for r in vc.replicas
            )
            assert all(r._admission.shed_p == 0.0 for r in vc.replicas)

    asyncio.run(main())


def test_partial_shed_retries_through():
    """At a moderate shed probability the client's keyed-draw retries (fresh
    seed = fresh draw) must get the write through without an error."""

    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            client = vc.client(timeout_s=5.0)
            await client.execute_write_transaction(
                TransactionBuilder().write("k", b"v").build()
            )
            _pin_shed(vc, 0.3)
            for i in range(6):
                await client.execute_write_transaction(
                    TransactionBuilder().write(f"p{i}", b"x").build()
                )
            res = await client.execute_read_transaction(
                TransactionBuilder().read("p5").build()
            )
            assert res.operations[0].value == b"x"

    asyncio.run(main())


def test_shed_draw_is_identical_across_replicas():
    """The admission draw is a pure function of (client_id, seed): replicas
    agree exactly, which is what keeps quorums alive under shedding."""
    from mochi_tpu_torch.server.replica import MochiReplica

    class P:
        client_id = "client-abc"
        seed = 123456

    d = MochiReplica._shed_draw(P())
    assert 0.0 <= d < 1.0
    assert d == MochiReplica._shed_draw(P())
    P.seed = 123457
    assert d != MochiReplica._shed_draw(P())


def test_admin_ops_never_shed():
    """An operator reconfiguring an overloaded cluster must get through:
    admin-gated writes bypass admission control."""

    async def main():
        from mochi_tpu_torch.crypto.keys import generate_keypair

        admin_kp = generate_keypair()
        async with VirtualCluster(5, rf=4) as vc:
            for r in vc.replicas:
                r.config.admin_keys.append(admin_kp.public_key)
            _pin_shed(vc, 1.0)
            client = vc.client(keypair=admin_kp)
            # _CONFIG_ keyspace write = admin op; must commit despite p=1.0
            from mochi_tpu_torch.cluster.config import CONFIG_CLIENT_PREFIX

            await client.execute_write_transaction(
                TransactionBuilder()
                .write(CONFIG_CLIENT_PREFIX + "ops-client", b"\x01" * 32)
                .build()
            )

    asyncio.run(main())


def test_overloaded_responses_carry_retry_after_on_real_signal():
    """Un-pinned controller: when the real load signal crosses its
    high-water mark, shed responses carry a non-zero retry-after hint
    (the hint is computed from the measured load factor, not a constant)."""

    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            client = vc.client(timeout_s=5.0)
            await client.execute_write_transaction(
                TransactionBuilder().write("k", b"v").build()
            )
            r0 = vc.replicas[0]
            # drive the signal, not the knob: report verify backlog past
            # the high-water mark, as a flood of in-flight Write2s would
            r0._admission.verify_inflight = int(
                r0._admission.verify_hw * 3
            )
            r0._admission.update()
            assert r0._admission.overloaded
            assert r0._admission.retry_after_ms > 0
            assert r0._admission.shed_p > 0.0
            # and the typed response path forwards it
            from mochi_tpu_torch.protocol.messages import Write1ToServer
            from mochi_tpu_torch.protocol import transaction_hash

            txn = TransactionBuilder().write("shedme", b"x").build()
            blind = client._write1_transaction(txn)
            # pin the draw under shed_p by flooding attempts: with p ~> 0.5
            # a handful of seeds guarantees at least one shed
            r0._shed_p = 1.0
            env = client._envelope(
                Write1ToServer(client.client_id, blind, 7, transaction_hash(txn)),
                "probe-w1",
                r0.server_id,
            )
            resp = await r0.handle_envelope(env)
            payload = resp.payload
            assert isinstance(payload, RequestFailedFromServer)
            assert payload.fail_type == FailType.OVERLOADED
            assert payload.retry_after_ms > 0

    asyncio.run(main())


def test_shed_draws_equal_the_reference():
    """The admission draw of seeded (client id, seed) pairs is the same in
    the port's replica and the reference's: mixed clusters shed the same
    transactions."""
    import random

    from mochi_tpu.server.replica import MochiReplica as RefReplica
    from mochi_tpu_torch.server.replica import MochiReplica

    class P:
        pass

    rng = random.Random(17)
    for _ in range(200):
        P.client_id, P.seed = f"client-{rng.getrandbits(40):x}", rng.randrange(1 << 30)
        assert MochiReplica._shed_draw(P()) == RefReplica._shed_draw(P())
