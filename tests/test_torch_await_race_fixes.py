"""Regression pins for the true positives the await-races checker found.

The await-races static pass (docs/ANALYSIS.md §await-races) flagged these
sites before their fixes; each test here drives the actual interleaving the checker
predicted and would fail against the pre-fix code:

* ``RpcClientPool.close`` blanket-``clear()``ed the straggler set after an
  await — a straggler registered DURING the shutdown gather was orphaned
  un-cancelled (and untracked, so "Task was destroyed but it is pending").
* ``RpcClientPool.close`` iterated the live ``_connections`` dict with an
  await in the body — a connection registered mid-close raised
  ``RuntimeError: dictionary changed size during iteration``.
* ``MochiDBClient._ensure_session`` captured the server's public key BEFORE
  the handshake round trip — a reconfiguration rotating the key mid-flight
  left the ack verifying against the rotated-OUT identity.
"""

import asyncio

from mochi_tpu_torch.net.transport import RpcClientPool


def test_pool_close_drains_straggler_registered_mid_close():
    async def main():
        pool = RpcClientPool()
        spawned = {}

        async def late():
            await asyncio.sleep(30)

        async def early():
            try:
                await asyncio.sleep(30)
            except asyncio.CancelledError:
                # a concurrent fan-out registering its drain task exactly
                # while close() awaits the first cancellation round
                t2 = asyncio.get_running_loop().create_task(late())
                pool._track_straggler(t2)
                spawned["t2"] = t2
                raise

        t1 = asyncio.get_running_loop().create_task(early())
        pool._track_straggler(t1)
        await asyncio.sleep(0)  # let t1 reach its await
        await pool.close()
        assert not pool._straggler_tasks, "close() must drain to quiescence"
        assert spawned["t2"].cancelled(), (
            "the mid-close straggler was orphaned (the old clear() bug)"
        )

    asyncio.run(main())


def test_pool_close_closes_connection_registered_mid_close():
    class FakeConn:
        def __init__(self, pool=None):
            self.closed = False
            self._pool = pool

        async def close(self):
            await asyncio.sleep(0)
            self.closed = True
            if self._pool is not None:
                # a request racing shutdown registers one more connection
                # while close() is suspended inside OUR close()
                self._pool._connections.setdefault("late", FakeConn())
                self._pool = None

    async def main():
        pool = RpcClientPool()
        first = FakeConn(pool)
        pool._connections["first"] = first
        await pool.close()  # pre-fix: RuntimeError (dict changed size)
        assert first.closed
        assert not pool._connections, "the late connection must be closed too"

    asyncio.run(main())


def test_pool_close_drains_straggler_registered_during_conn_close():
    class FakeConn:
        def __init__(self, pool):
            self.closed = False
            self._pool = pool

        async def close(self):
            await asyncio.sleep(0)
            self.closed = True
            # a fan-out's pending futures fail as this connection tears
            # down, and its drain task registers while close() is already
            # past the straggler phase
            t = asyncio.get_running_loop().create_task(asyncio.sleep(30))
            self._pool._track_straggler(t)
            self._pool.spawned = t

    async def main():
        pool = RpcClientPool()
        pool._connections["only"] = FakeConn(pool)
        await pool.close()
        assert not pool._straggler_tasks, "close() must drain to quiescence"
        assert pool.spawned.cancelled(), (
            "a straggler registered during the connection-close phase was "
            "orphaned un-cancelled"
        )

    asyncio.run(main())


def test_ensure_session_rereads_rotated_key_after_handshake():
    from mochi_tpu_torch.client.client import MochiDBClient
    from mochi_tpu_torch.cluster.config import ClusterConfig
    from mochi_tpu_torch.crypto import session as session_crypto
    from mochi_tpu_torch.crypto.keys import generate_keypair
    from mochi_tpu_torch.net.transport import new_msg_id
    from mochi_tpu_torch.protocol import Envelope, SessionAckFromServer

    old_kp, new_kp = generate_keypair(), generate_keypair()

    peers = {f"server-{i}": generate_keypair() for i in range(1, 4)}

    def build_cfg(kp):
        return ClusterConfig.build(
            {f"server-{i}": f"127.0.0.1:{i + 1}" for i in range(4)}, rf=4,
            public_keys={"server-0": kp.public_key}
            | {sid: p.public_key for sid, p in peers.items()},
        )

    def fake_server(rotate_to=None):
        """send_and_receive double: optionally rotates the client's config
        mid-flight, always acks signed with the ORIGINAL key."""

        async def send_and_receive(info, env, timeout_s=None):
            if rotate_to is not None:
                client.config = rotate_to
            hs = session_crypto.new_handshake()
            ack = Envelope(
                payload=SessionAckFromServer(hs.public_bytes, hs.nonce),
                msg_id=new_msg_id(),
                sender_id="server-0",
                timestamp_ms=0,
            )
            return ack.with_signature(old_kp.sign(ack.signing_bytes()))

        return send_and_receive

    async def main():
        global client
        # control: no rotation -> the handshake establishes a session
        client = MochiDBClient(config=build_cfg(old_kp))
        client.pool.send_and_receive = fake_server()
        await client._ensure_session("server-0", client.config.servers["server-0"])
        assert "server-0" in client._sessions, "control handshake must succeed"
        await client.close()

        # rotation mid-flight: the ack is signed by the rotated-OUT key and
        # must be rejected against the key the CURRENT config trusts
        client = MochiDBClient(config=build_cfg(old_kp))
        client.pool.send_and_receive = fake_server(rotate_to=build_cfg(new_kp))
        await client._ensure_session("server-0", client.config.servers["server-0"])
        assert "server-0" not in client._sessions, (
            "session sealed against a rotated-out server identity "
            "(the old stale server_key)"
        )
        await client.close()

        # rotation that REMOVES the key entirely: no crash, no session
        removed = ClusterConfig.build(
            {f"server-{i}": f"127.0.0.1:{i + 1}" for i in range(4)}, rf=4,
            public_keys={sid: p.public_key for sid, p in peers.items()},
        )
        client = MochiDBClient(config=build_cfg(old_kp))
        client.pool.send_and_receive = fake_server(rotate_to=removed)
        await client._ensure_session("server-0", client.config.servers["server-0"])
        assert "server-0" not in client._sessions
        await client.close()

    asyncio.run(main())


def test_pool_close_ends_as_the_reference_ends():
    """The mid-close straggler interleaving against the port's pool and the
    reference's: each drains to quiescence and cancels the late task, and
    a second close of each is a no-op."""
    from mochi_tpu.net.transport import RpcClientPool as RefPool

    async def drive(pool_cls):
        pool = pool_cls()
        spawned = {}

        async def late():
            await asyncio.sleep(30)

        async def early():
            try:
                await asyncio.sleep(30)
            except asyncio.CancelledError:
                t2 = asyncio.get_running_loop().create_task(late())
                pool._track_straggler(t2)
                spawned["t2"] = t2
                raise

        t1 = asyncio.get_running_loop().create_task(early())
        pool._track_straggler(t1)
        await asyncio.sleep(0)
        await pool.close()
        await pool.close()
        return len(pool._straggler_tasks), t1.cancelled(), spawned["t2"].cancelled(), len(pool._connections)

    async def main():
        assert await drive(RpcClientPool) == await drive(RefPool) == (0, True, True, 0)

    asyncio.run(main())
