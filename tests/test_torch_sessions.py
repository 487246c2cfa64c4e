"""Session-MAC transport auth (``crypto/session.py``): handshake, speed
path, and the adversarial/recovery cases that keep it as safe as the
signature scheme it replaces on the envelope hop.
"""

import asyncio
from dataclasses import replace

from mochi_tpu_torch.client import TransactionBuilder
from mochi_tpu_torch.crypto import session as session_crypto
from mochi_tpu_torch.protocol import (
    Envelope,
    FailType,
    HelloToServer,
    RequestFailedFromServer,
)
from mochi_tpu_torch.testing import VirtualCluster


def run(coro):
    asyncio.run(asyncio.wait_for(coro, timeout=60))


def test_sessions_established_and_used_for_traffic():
    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("sk", b"v").build()
            )
            # handshakes happened with every contacted replica
            assert len(client._sessions) == 4
            for r in vc.replicas:
                assert client.client_id in r._sessions
                # both sides derived the SAME key
                assert r._sessions[client.client_id] == client._sessions[r.server_id]
            # traffic after handshake is MAC'd, not signed: check by sending
            # a MAC'd hello directly
            sid = "server-0"
            env = client._envelope(HelloToServer("hi"), "m-mac", sid)
            assert env.mac is not None and env.signature is None

    run(main())


def test_forged_mac_rejected():
    async def main():
        async with VirtualCluster(4, rf=4, require_client_auth=True) as vc:
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("sk", b"v").build()
            )
            sid = "server-0"
            env = client._envelope(HelloToServer("hi"), "m-bad", sid)
            bad = replace(env, mac=bytes(32))
            resp = await client.pool.send_and_receive(vc.config.servers[sid], bad)
            assert isinstance(resp.payload, RequestFailedFromServer)
            assert resp.payload.fail_type == FailType.BAD_SIGNATURE

    run(main())


def test_mac_without_session_rejected_even_in_open_mode():
    """A MAC'd envelope from a sender with no established session must NOT
    ride the open-mode (unknown-sender) acceptance path."""

    async def main():
        async with VirtualCluster(4, rf=4) as vc:  # require_client_auth=False
            client = vc.client()
            sid = "server-0"
            env = Envelope(HelloToServer("hi"), "m-x", "client-nobody")
            env = env.with_mac(bytes(32))
            resp = await client.pool.send_and_receive(vc.config.servers[sid], env)
            assert isinstance(resp.payload, RequestFailedFromServer)
            assert resp.payload.fail_type == FailType.BAD_SIGNATURE

    run(main())


def test_client_recovers_after_replica_restart_loses_session():
    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("rk", b"v1").build()
            )
            assert len(client._sessions) == 4
            # replica restarts -> its session table is gone
            await vc.restart_replica("server-1", resync=True)
            # client's next write bounces on server-1 (BAD_SIGNATURE), drops
            # the stale session, re-handshakes, and still commits
            await client.execute_write_transaction(
                TransactionBuilder().write("rk", b"v2").build()
            )
            r = await client.execute_read_transaction(
                TransactionBuilder().read("rk").build()
            )
            assert r.operations[0].value == b"v2"
            assert client.client_id in vc.replica("server-1")._sessions

    run(main())


def test_key_derivation_is_directional_and_nonce_bound():
    a = session_crypto.new_handshake()
    b = session_crypto.new_handshake()
    k_ab = session_crypto.derive_key(a, b.public_bytes, b.nonce, "c", "s", True)
    k_ba = session_crypto.derive_key(b, a.public_bytes, a.nonce, "c", "s", False)
    assert k_ab == k_ba  # both sides agree
    # different nonce -> different key
    k2 = session_crypto.derive_key(a, b.public_bytes, b"\x00" * 16, "c", "s", True)
    assert k2 != k_ab
    # identity binding
    k3 = session_crypto.derive_key(a, b.public_bytes, b.nonce, "c2", "s", True)
    assert k3 != k_ab
    # MAC round trip
    tag = session_crypto.mac(k_ab, b"payload")
    assert session_crypto.mac_ok(k_ba, b"payload", tag)
    assert not session_crypto.mac_ok(k_ba, b"payload2", tag)


def test_evict_client_bans_rehandshake_but_keeps_signed_path():
    """The policy-eviction hook (replica.evict_client, the ROADMAP item-4
    disconnect-policy seam): the MAC session drops, re-handshakes are
    refused with a TYPED signed failure, and the client transparently
    stays on signed envelopes — eviction bounds the MAC discount, it does
    not (yet) refuse service."""

    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("ek", b"v1").build()
            )
            r0 = vc.replica("server-0")
            assert client.client_id in r0._sessions
            out = r0.evict_client(client.client_id)
            assert out["session"] == "evicted" and out["banned"] is True
            assert out["outstanding_grants"] == 0  # committed write: no debt
            assert client.client_id not in r0._sessions
            assert r0.client_grant_stats()["banned_clients"] == 1
            # drop the client's own half so the next fan-out re-knocks
            client._sessions.pop("server-0", None)
            # next write: server-0 refuses the handshake (typed, signed,
            # BAD_REQUEST — must NOT trip the lost-session teardown) and the
            # fan-out still commits over signed envelopes
            await client.execute_write_transaction(
                TransactionBuilder().write("ek", b"v2").build()
            )
            assert client.client_id not in r0._sessions  # ban held
            assert r0.metrics.counters.get("replica.handshake-banned", 0) >= 1
            r = await client.execute_read_transaction(
                TransactionBuilder().read("ek").build()
            )
            assert r.operations[0].value == b"v2"
            # idempotent re-evict: session already gone, ban already booked
            assert r0.evict_client(client.client_id)["session"] == "absent"

    run(main())


def test_session_keys_and_macs_equal_the_reference():
    """A handshake between the port and the reference package: each side
    derives the same directional key from the other's public bytes and
    nonce, and the MACs of the two packages agree on it."""
    from mochi_tpu.crypto import session as ref_session

    mine, theirs = session_crypto.new_handshake(), ref_session.new_handshake()
    k_mine = session_crypto.derive_key(mine, theirs.public_bytes, theirs.nonce, "c", "s", True)
    k_theirs = ref_session.derive_key(theirs, mine.public_bytes, mine.nonce, "c", "s", False)
    assert k_mine == k_theirs
    tag = session_crypto.mac(k_mine, b"payload")
    assert tag == ref_session.mac(k_theirs, b"payload")
    assert ref_session.mac_ok(k_theirs, b"payload", tag) and session_crypto.mac_ok(k_mine, b"payload", tag)
    assert session_crypto.window_digest(b"signing bytes") == ref_session.window_digest(b"signing bytes")
