"""Bounded-state + backpressure + wakeup-coalescing mechanics
(docs/OPERATIONS.md §4g).

What must hold at front-end scale (thousands of concurrent client
sessions): the replica's session table is LRU+TTL bounded and NEVER evicts
a session whose request is mid-batch; the client's per-connection msg-id
correlation map is bounded by refusing NEW work (typed), never by evicting
an in-flight entry; a slow reader trips the transport's send-queue
watermarks into pausing that connection's reads; request timeouts and
backoff sleeps coalesce onto one coarse timer wheel.
"""

from __future__ import annotations

import asyncio

import pytest

from mochi_tpu_torch.net import transport as tp
from mochi_tpu_torch.net.transport import PendingLimitExceeded, _Connection
from mochi_tpu_torch.cluster.config import ServerInfo
from mochi_tpu_torch.server.admission import AdmissionController, SessionTable, TokenBucket
from mochi_tpu_torch.utils.wakeup import TimerWheel


# ------------------------------------------------------------ session table


def test_session_table_lru_eviction_and_bounds():
    t = SessionTable(max_entries=3, ttl_s=0)
    t["a"] = b"ka"
    t["b"] = b"kb"
    t["c"] = b"kc"
    assert t.get("a") == b"ka"  # refreshes recency: b is now LRU-oldest
    t["d"] = b"kd"
    assert len(t) == 3 and t.evictions == 1
    assert "b" not in t and "a" in t and "d" in t


def test_session_table_never_evicts_pinned_entry():
    """The regression the batch pipeline depends on: a sender pinned for an
    in-flight batch survives capacity eviction; the unpinned LRU entry goes
    instead — and a fully-pinned table admits over cap rather than corrupt
    a batch."""
    t = SessionTable(max_entries=2, ttl_s=0)
    t["inflight"] = b"k1"
    t["idle"] = b"k2"
    t.pin("inflight")
    t["new"] = b"k3"  # capacity eviction must skip the pinned entry
    assert "inflight" in t and "new" in t and "idle" not in t
    t.pin("new")
    t["another"] = b"k4"  # everything pinned: admit over cap, evict nothing
    assert len(t) == 3 and "inflight" in t and "new" in t
    t.unpin("inflight")
    t.unpin("new")
    # TTL sweep honors pins the same way
    t2 = SessionTable(max_entries=8, ttl_s=1e-9)
    t2["busy"] = b"k"
    t2["stale"] = b"k"
    t2.pin("busy")
    import time

    time.sleep(0.002)
    t2.sweep()
    assert "busy" in t2 and "stale" not in t2


def test_session_table_policy_evict_defers_on_pinned():
    """The safe eviction hook (replica.evict_client seam): an unpinned
    sender drops immediately; a pinned (mid-batch) one is deferred to its
    final unpin so in-flight responses still seal; a fresh handshake
    supersedes a pending deferred drop (the ban book, not eviction timing,
    keeps an evicted client out)."""
    t = SessionTable(max_entries=4, ttl_s=0)
    t["idle"] = b"k1"
    assert t.evict("idle") == "evicted" and "idle" not in t
    assert t.evict("idle") == "absent"
    t["busy"] = b"k2"
    t.pin("busy")
    t.pin("busy")  # nested pin: two envelopes of one drain
    assert t.evict("busy") == "deferred"
    assert t.get("busy") == b"k2"  # still live mid-batch
    t.unpin("busy")
    assert "busy" in t  # first unpin: still one pin outstanding
    t.unpin("busy")
    assert "busy" not in t and t.evictions == 2  # dropped at FINAL unpin
    t["back"] = b"k3"
    t.pin("back")
    assert t.evict("back") == "deferred"
    t["back"] = b"k4"  # re-handshake while pinned clears the deferral
    t.unpin("back")
    assert t.get("back") == b"k4"


def test_replica_session_pinned_across_batch_await():
    """End-to-end pin: a MAC'd request mid-batch must keep its session
    alive even when a same-batch handshake lands in a full table — the
    response must seal under the surviving session, not bounce."""
    from mochi_tpu_torch.cluster.config import ClusterConfig
    from mochi_tpu_torch.crypto import session as session_crypto
    from mochi_tpu_torch.crypto.keys import generate_keypair
    from mochi_tpu_torch.protocol import (
        Envelope,
        NudgeSyncToServer,
        SessionInitToServer,
        SyncAckFromServer,
    )
    from mochi_tpu_torch.net.transport import new_msg_id
    from mochi_tpu_torch.server.replica import MochiReplica

    async def main():
        kps = {f"server-{i}": generate_keypair() for i in range(4)}
        kp = kps["server-0"]
        config = ClusterConfig.build(
            {sid: f"127.0.0.1:{i + 1}" for i, sid in enumerate(kps)},
            rf=4,
            public_keys={sid: k.public_key for sid, k in kps.items()},
        )
        replica = MochiReplica("server-0", config, kp, admission=False)
        replica._sessions = SessionTable(max_entries=1, ttl_s=0)
        session_key = b"\x07" * 32
        replica._sessions["client-A"] = session_key

        macd = session_crypto.seal(
            Envelope(
                payload=NudgeSyncToServer(("k",)),
                msg_id=new_msg_id(),
                sender_id="client-A",
                timestamp_ms=0,
            ),
            session_key,
        )
        hs = session_crypto.new_handshake()
        init_kp = generate_keypair()
        init_env = Envelope(
            payload=SessionInitToServer(hs.public_bytes, hs.nonce),
            msg_id=new_msg_id(),
            sender_id="client-B",
            timestamp_ms=0,
        )
        init_env = init_env.with_signature(init_kp.sign(init_env.signing_bytes()))

        # one batch: the MAC'd request pins client-A; client-B's handshake
        # insert hits a FULL table and must not evict the pinned session
        responses = await replica.handle_batch([macd, init_env])
        assert isinstance(responses[0].payload, SyncAckFromServer)
        assert responses[0].mac is not None  # sealed under the LIVE session
        assert replica._sessions.get("client-A") == session_key
        await replica.close()

    asyncio.run(main())


# --------------------------------------------------------- pending-map bound


def test_pending_map_full_refuses_new_never_evicts_inflight():
    """msg-id correlation map at the cap: the NEW request fails typed;
    every in-flight future survives untouched (evicting one would orphan
    its response into a spurious timeout)."""

    async def main():
        conn = _Connection(
            ServerInfo("s0", "127.0.0.1", 1), pending_max=4
        )
        loop = asyncio.get_running_loop()
        futs = {f"m{i}": loop.create_future() for i in range(4)}
        for mid, fut in futs.items():
            conn.register_pending(mid, fut)
        with pytest.raises(PendingLimitExceeded):
            conn.register_pending("m-overflow", loop.create_future())
        assert set(conn.pending) == set(futs)  # nothing in-flight evicted
        # resolved leftovers ARE swept to make room
        futs["m0"].set_result(None)
        conn.register_pending("m-next", loop.create_future())
        assert "m0" not in conn.pending and "m-next" in conn.pending
        assert all(not f.done() or mid == "m0" for mid, f in futs.items())

    asyncio.run(main())


# ------------------------------------------------------ send-queue watermarks


def test_sendq_accounting_and_flow_pause_bookkeeping():
    """Transport-side bookkeeping behind the admission signal: buffered
    response bytes are counted in and out, pause_writing marks the
    connection (and the server tally), and a connection lost while paused
    does not leak the count."""

    class _FakeTransport:
        def __init__(self):
            self.paused = False
            self.written = b""

        def is_closing(self):
            return False

        def pause_reading(self):
            self.paused = True

        def resume_reading(self):
            self.paused = False

        def write(self, data):
            self.written += data

        def get_write_buffer_size(self):
            return 0

        def set_write_buffer_limits(self, high=None, low=None):
            self.limits = (high, low)

    async def main():
        server = tp.RpcServer("127.0.0.1", 0, handler=None)
        proto = tp._RpcServerProtocol(server)
        t = _FakeTransport()
        proto.connection_made(t)
        assert t.limits == (server.sendq_high, server.sendq_low)

        touched = []
        proto.queue_frame(b"x" * 100, touched)
        assert server._sendq_out_bytes == 104  # payload + length prefix
        proto.flush_now()
        assert server._sendq_out_bytes == 0 and len(t.written) == 104

        proto.pause_writing()
        assert t.paused and server._paused_conns == 1
        assert server.load_stats()["paused_conns"] == 1
        proto.resume_writing()
        assert not t.paused and server._paused_conns == 0

        # lost-while-paused: the tally and byte count must not leak
        proto.queue_frame(b"y" * 10, touched)
        proto.pause_writing()
        proto.connection_lost(None)
        assert server._paused_conns == 0 and server._sendq_out_bytes == 0

    asyncio.run(main())


def test_admission_controller_excess_demand_curve():
    """shed_p tracks the excess-demand fraction 1 - 1/L of the WORST load
    component, smoothed per update; below every high-water mark it decays
    to exactly 0."""

    class _FakeRpc:
        def __init__(self):
            self.stats = {
                "batch_ewma": 0.0, "inflight_envs": 0,
                "sendq_out_bytes": 0, "paused_conns": 0,
                "ingress_depth": 0, "connections": 0,
            }

        def load_stats(self):
            return self.stats

    rpc = _FakeRpc()
    ac = AdmissionController(rpc, enabled=True, inflight_hw=100)
    ac.update()
    assert ac.shed_p == 0.0 and not ac.overloaded and ac.retry_after_ms == 0
    rpc.stats["inflight_envs"] = 200  # L = 2: steady-state target 0.5
    for _ in range(12):
        ac.update()
    assert ac.overloaded and abs(ac.shed_p - 0.5) < 0.01
    assert ac.retry_after_ms == 50  # 25 ms per unit load
    rpc.stats["inflight_envs"] = 0
    for _ in range(20):
        ac.update()
    assert ac.shed_p == 0.0 and not ac.overloaded
    # pin wins over the signal (test seam)
    ac.pin(1.0)
    rpc.stats["inflight_envs"] = 0
    ac.update()
    assert ac.shed_p == 1.0


# ------------------------------------------------------- handshake rate limit


def test_handshake_rate_limit_client_falls_back_to_signatures():
    """A replica out of handshake tokens refuses typed OVERLOADED with a
    retry-after; the client caches the refusal (no re-knock per request)
    and the write still commits on signed envelopes — the valve costs the
    MAC discount, never liveness."""
    from mochi_tpu_torch.client.txn import TransactionBuilder
    from mochi_tpu_torch.testing.virtual_cluster import VirtualCluster

    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            for r in vc.replicas:
                r._handshakes = TokenBucket(rate_per_s=0.001, burst=0)
            client = vc.client(timeout_s=5.0)
            await client.execute_write_transaction(
                TransactionBuilder().write("k", b"v").build()
            )
            assert not client._sessions  # every handshake was refused
            assert client._session_refused  # ...and cached, not re-knocked
            limited = sum(
                n
                for name, n in client.metrics.counters.items()
                if name.startswith("client.handshake-limited.")
            )
            assert limited >= 1
            refused = sum(r._handshakes.refused for r in vc.replicas)
            assert refused >= 1
            res = await client.execute_read_transaction(
                TransactionBuilder().read("k").build()
            )
            assert res.operations[0].value == b"v"

    asyncio.run(main())


# ------------------------------------------------------------ wakeup wheel


def test_timer_wheel_coalesces_and_never_fires_early():
    async def main():
        wheel = TimerWheel(quantum_s=0.02)
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        # many sleeps landing in the same quantum share buckets
        await asyncio.gather(*(wheel.sleep(0.03) for _ in range(50)))
        elapsed = loop.time() - t0
        assert elapsed >= 0.03, f"wheel fired early ({elapsed:.4f}s)"
        assert elapsed < 0.5
        st = wheel.stats()
        assert st["scheduled"] == 50 and st["fired"] == 50
        # cancellation is lazy and cheap: a cancelled entry never fires
        fired = []
        entry = wheel.call_later(0.03, lambda: fired.append(1))
        entry.cancel()
        await asyncio.sleep(0.08)
        assert not fired and wheel.stats()["lapsed"] >= 1
        wheel.close()

    asyncio.run(main())


def test_send_and_receive_timeout_rides_the_wheel():
    """A server that never answers: the wheel-based timeout raises
    asyncio.TimeoutError within timeout + one quantum, and the pending
    map entry is reclaimed."""
    from mochi_tpu_torch.protocol import Envelope, HelloToServer
    from mochi_tpu_torch.net.transport import RpcServer, RpcClientPool, new_msg_id

    async def main():
        async def blackhole(env):
            await asyncio.sleep(30)

        server = RpcServer("127.0.0.1", 0, blackhole)
        await server.start()
        pool = RpcClientPool(default_timeout_s=0.2)
        info = ServerInfo("s0", "127.0.0.1", server.bound_port)
        env = Envelope(
            payload=HelloToServer("hi"), msg_id=new_msg_id(),
            sender_id="c", timestamp_ms=0,
        )
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        with pytest.raises(asyncio.TimeoutError):
            await pool.send_and_receive(info, env, timeout_s=0.2)
        elapsed = loop.time() - t0
        assert 0.2 <= elapsed < 0.5
        conn = pool._conn(info)
        assert not conn.pending  # reclaimed on timeout
        await pool.close()
        await server.close()

    asyncio.run(main())


# ------------------------------------------- suspicion-steered trim_write1


def test_trim_write1_first_attempt_avoids_suspect_peer():
    """The per-peer suspicion scores steer the
    quorum-trimmed FIRST Write1 attempt exactly as they steer trimmed
    reads — both ride ``_quorum_targets``.  With one in-set peer past the
    suspicion threshold, a trim_write1 client's first attempt must not
    send it a Write1 at all (rf=4, quorum=3: coverage without the suspect
    is always possible)."""
    import time as _time

    from mochi_tpu_torch.client.client import SUSPICION_THRESHOLD
    from mochi_tpu_torch.client.txn import TransactionBuilder
    from mochi_tpu_torch.testing.virtual_cluster import VirtualCluster

    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            client = vc.client(timeout_s=5.0, trim_write1=True)
            # warm sessions so per-replica counters start clean-ish
            await client.execute_write_transaction(
                TransactionBuilder().write("warm", b"v").build()
            )
            key = "trimtest"
            in_set = client.config.replica_set_for_key(key)
            suspect = in_set[0]
            events = client._suspicion_events.setdefault(
                suspect, __import__("collections").deque(maxlen=4096)
            )
            now = _time.monotonic()
            events.extend([now] * (SUSPICION_THRESHOLD + 3))

            before = {
                sid: vc.replica(sid).metrics.timers["replica.write1"].count
                for sid in in_set
            }
            await client.execute_write_transaction(
                TransactionBuilder().write(key, b"x").build()
            )
            after = {
                sid: vc.replica(sid).metrics.timers["replica.write1"].count
                for sid in in_set
            }
            served = {sid for sid in in_set if after[sid] > before[sid]}
            assert suspect not in served, (
                f"suspect {suspect} still got the trimmed first Write1"
            )
            # the quorum still covered: at least quorum peers served it
            assert len(served) >= client.config.quorum

    asyncio.run(main())


# -------------------------------------------- invariant in-doubt semantics


def test_invariant_checker_in_doubt_write_is_not_loss_but_real_loss_is():
    """The invariant checker's semantics: a write that FAILED at the client after
    dispatch may still have committed (frame loss ate the answers) — if
    the re-read returns such an in-doubt value, durability held and the
    checker must not cry loss.  A value the cluster never saw acked OR
    attempted remains a hard violation (the check stays non-vacuous)."""
    from mochi_tpu_torch.client.txn import TransactionBuilder
    from mochi_tpu_torch.testing.invariants import InvariantChecker
    from mochi_tpu_torch.testing.virtual_cluster import VirtualCluster

    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            client = vc.client(timeout_s=5.0)
            checker = InvariantChecker(vc.replicas)
            await client.execute_write_transaction(
                TransactionBuilder().write("k", b"v1").build()
            )
            checker.record_ack("k", b"v1")
            # the "failed at client, committed at cluster" shape: the write
            # really lands, but the workload only records an attempt
            await client.execute_write_transaction(
                TransactionBuilder().write("k", b"v2").build()
            )
            checker.record_attempt("k", b"v2")
            await checker.final_check(client)
            assert checker.ok, checker.violations
            assert checker.in_doubt_accepted == 1
            # real loss still fires: claim an ack the cluster never served
            checker2 = InvariantChecker(vc.replicas)
            checker2.record_ack("k", b"v3-never-written")
            await checker2.final_check(client)
            assert not checker2.ok
            assert "lost" in checker2.violations[0]
            # and a LATER ack clears older in-doubt values: a stale
            # in-doubt value re-surfacing after a newer ack is loss
            checker3 = InvariantChecker(vc.replicas)
            checker3.record_attempt("q", b"old")
            checker3.record_ack("q", b"new")
            assert checker3._in_doubt.get("q") is None

    asyncio.run(main())


def test_batch_ewma_resets_after_idle_gap():
    """The congestion EWMA is only folded when frames arrive — without the
    idle-gap reset, a storm's EWMA would freeze across hours of silence
    and shed the first writes of the next burst from an IDLE replica."""
    from mochi_tpu_torch.protocol import Envelope, HelloToServer
    from mochi_tpu_torch.net.transport import new_msg_id

    async def main():
        async def handler(env):
            return None

        server = tp.RpcServer("127.0.0.1", 0, handler)
        proto = tp._RpcServerProtocol(server)
        env = Envelope(
            payload=HelloToServer("hi"), msg_id=new_msg_id(),
            sender_id="c", timestamp_ms=0,
        )
        import time as _time

        # a storm parked the EWMA high, then the replica went idle
        server._batch_ewma = 640.0
        server._last_drain_t = _time.perf_counter() - 5.0
        server._ingress.append((proto, env))
        server._drain()
        await asyncio.sleep(0)  # let the spawned handler task run
        assert server._batch_ewma < 1.0, server._batch_ewma
        # back-to-back drains (no idle gap) keep folding normally
        server._ingress.append((proto, env))
        server._drain()
        await asyncio.sleep(0)
        assert 0 < server._batch_ewma < 2.0

    asyncio.run(main())


def test_admission_and_token_bucket_curves_equal_the_reference(monkeypatch):
    """A seeded load sequence through the port's AdmissionController and
    the reference's gives the same shed probability, overload flag and
    retry-after at every update; token buckets on one fake clock grant the
    same takes."""
    import random

    from mochi_tpu.server.admission import AdmissionController as RefController
    from mochi_tpu.server.admission import TokenBucket as RefBucket

    class _Rpc:
        def __init__(self):
            self.stats = {"batch_ewma": 0.0, "inflight_envs": 0, "sendq_out_bytes": 0, "paused_conns": 0,
                          "ingress_depth": 0, "connections": 0}

        def load_stats(self):
            return self.stats

    rpc = _Rpc()
    mine = AdmissionController(rpc, enabled=True, inflight_hw=100)
    theirs = RefController(rpc, enabled=True, inflight_hw=100)
    rng = random.Random(4242)
    for _ in range(120):
        rpc.stats["inflight_envs"] = rng.choice([0, 50, 150, 300, 1000])
        rpc.stats["batch_ewma"] = rng.random() * 64
        mine.update()
        theirs.update()
        assert (mine.shed_p, mine.overloaded, mine.retry_after_ms) == (
            theirs.shed_p, theirs.overloaded, theirs.retry_after_ms)

    import time

    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    a, b = TokenBucket(5.0, 10.0), RefBucket(5.0, 10.0)
    for _ in range(200):
        now[0] += rng.random() * 0.3
        assert a.admit() == b.admit() and a.retry_after_ms() == b.retry_after_ms()
    assert a.refused == b.refused > 0
