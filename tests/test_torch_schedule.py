"""The port's deterministic schedule explorer (``testing/schedule.py``).

Ported from the JAX package's ``tests/test_schedule.py``: the replayability
property (same seed, byte-identical event order, three runs in a row), a
planted async-TOCTOU race found and replayed exactly, and the two hottest
windows driven through the port's real replica and store code with no
sockets — handle_batch→session-eviction and Write1→reclaim→Write2 (single
seeds in tier-1; the multi-seed ``explore_*`` legs are slow-marked, and
``MOCHI_SCHED_SEEDS`` widens them).  Added: the ExplorerLoop traces of the
socket-free workload and of the session-eviction window equal the
reference's for the same seeds.
"""

import asyncio

import pytest

from mochi_tpu_torch.testing import schedule


# ------------------------------------------------------------ replayability


class _Workload:
    """Deterministic-but-schedule-sensitive: tasks contend on a shared dict
    with yields between check and act, all via tolerant operations (no
    crash) — the TRACE is what varies across seeds."""

    def __init__(self):
        self.table = {}
        self.log = []

    async def worker(self, wid):
        for i in range(5):
            self.table[wid] = i
            await asyncio.sleep(0)
            self.log.append((wid, self.table.get(wid)))
            self.table.pop(wid, None)
            await asyncio.sleep(0)


def _workload_case():
    async def case():
        w = _Workload()
        await asyncio.gather(*(w.worker(i) for i in range(4)))

    return case()


def test_same_seed_three_runs_byte_identical():
    runs = [schedule.run_case(_workload_case, seed=5) for _ in range(3)]
    assert all(r.ok for r in runs), [r.error for r in runs]
    traces = {r.trace_bytes() for r in runs}
    assert len(traces) == 1, "same seed must replay byte-identically"
    assert len(runs[0].trace) > 10  # non-vacuous: the loop really traced


def test_distinct_seeds_explore_distinct_orders():
    results = [schedule.run_case(_workload_case, seed=s) for s in range(8)]
    assert all(r.ok for r in results)
    assert len({r.trace_bytes() for r in results}) > 1, (
        "the seed must actually perturb wake order"
    )


# ------------------------------------------------------------- planted race


class _Evictable:
    """The SessionTable-eviction bug shape, distilled: victim checks, then
    acts one await later; a concurrent evictor may have removed the entry
    in between.  FIFO wake order happens to run the victim first — only a
    perturbed schedule exposes the KeyError."""

    def __init__(self):
        self.table = {"k": 1}

    async def victim(self):
        if "k" in self.table:
            await asyncio.sleep(0)
            del self.table["k"]  # mochi-lint: disable=await-races -- the PLANTED bug this test exists to catch dynamically

    async def evictor(self):
        await asyncio.sleep(0)
        self.table.pop("k", None)


def _planted_case():
    async def case():
        s = _Evictable()
        await asyncio.gather(s.victim(), s.evictor())

    return case()


def test_planted_race_found_and_replayed_exactly():
    report = schedule.explore(_planted_case, seeds=range(24))
    assert report.failures, "explorer must find the planted interleaving"
    assert any(r.ok for r in report.results), (
        "some schedules must pass — the bug is schedule-dependent, "
        "not deterministic"
    )
    bad = report.failures[0]
    assert bad.error.startswith("KeyError")
    # replay twice: identical verdict AND identical schedule, byte for byte
    again = schedule.run_case(_planted_case, seed=bad.seed)
    third = schedule.run_case(_planted_case, seed=bad.seed)
    assert again.error == third.error == bad.error
    assert again.trace_bytes() == third.trace_bytes() == bad.trace_bytes()


# ----------------------------------- window 1: handle_batch session eviction


def _session_case(n_writers: int = 3, n_handshakes: int = 3, pkg: str = "mochi_tpu_torch"):
    """Real MochiReplica.handle_batch under a 1-entry SessionTable: MAC'd
    batches pin client-A while concurrent handshakes force capacity
    evictions.  The invariant (the session pin): a batch that AUTHENTICATED
    a MAC'd sender must seal its response under that session — an ack with
    no MAC means the session vanished between auth and response-seal.
    ``pkg`` names the package whose replica runs it."""
    import importlib

    ClusterConfig = importlib.import_module(f"{pkg}.cluster.config").ClusterConfig
    session_crypto = importlib.import_module(f"{pkg}.crypto.session")
    generate_keypair = importlib.import_module(f"{pkg}.crypto.keys").generate_keypair
    new_msg_id = importlib.import_module(f"{pkg}.net.transport").new_msg_id
    P = importlib.import_module(f"{pkg}.protocol")
    Envelope, NudgeSyncToServer = P.Envelope, P.NudgeSyncToServer
    SessionInitToServer, SyncAckFromServer = P.SessionInitToServer, P.SyncAckFromServer
    SessionTable = importlib.import_module(f"{pkg}.server.admission").SessionTable
    MochiReplica = importlib.import_module(f"{pkg}.server.replica").MochiReplica

    async def case():
        kps = {f"server-{i}": generate_keypair() for i in range(4)}
        config = ClusterConfig.build(
            {sid: f"127.0.0.1:{i + 1}" for i, sid in enumerate(kps)},
            rf=4,
            public_keys={sid: k.public_key for sid, k in kps.items()},
        )
        replica = MochiReplica("server-0", config, kps["server-0"], admission=False)
        replica._sessions = SessionTable(max_entries=1, ttl_s=0)
        session_key = b"\x07" * 32
        replica._sessions["client-A"] = session_key
        acked = []

        def macd_env():
            return session_crypto.seal(
                Envelope(
                    payload=NudgeSyncToServer(("k",)),
                    msg_id=new_msg_id(),
                    sender_id="client-A",
                    timestamp_ms=0,
                ),
                session_key,
            )

        def handshake_env(i):
            hs = session_crypto.new_handshake()
            env = Envelope(
                payload=SessionInitToServer(hs.public_bytes, hs.nonce),
                msg_id=new_msg_id(),
                sender_id=f"client-B{i}",
                timestamp_ms=0,
            )
            kp = generate_keypair()
            return env.with_signature(kp.sign(env.signing_bytes()))

        async def macd_batch(i):
            # every other writer rides in a MIXED batch with a handshake —
            # the exact one-batch window test_overload pins, here explored
            # under perturbed wake order with other batches in flight
            batch = [macd_env()]
            if i % 2:
                batch.append(handshake_env(100 + i))
            responses = await replica.handle_batch(batch)
            if isinstance(responses[0].payload, SyncAckFromServer):
                acked.append(i)
                assert responses[0].mac is not None, (
                    "session evicted between auth and response-seal "
                    "(the session-pin bug)"
                )

        async def handshake_batch(i):
            await replica.handle_batch([handshake_env(i)])

        try:
            # sequential warm-up batch: guarantees ≥1 authenticated window
            # regardless of how later schedules evict the unpinned session
            await macd_batch(0)
            assert acked, "warm-up batch must authenticate"
            await asyncio.gather(
                *(macd_batch(1 + i) for i in range(n_writers)),
                *(handshake_batch(i) for i in range(n_handshakes)),
            )
        finally:
            await replica.close()

    return case


def test_session_eviction_window_single_seed():
    result = schedule.run_case(_session_case(), seed=3, timeout_s=60)
    assert result.ok, result.error


@pytest.mark.slow
def test_explore_session_eviction_window():
    report = schedule.explore(
        _session_case(), seeds=schedule.exploration_seeds(), timeout_s=120
    )
    assert report.ok, report.summary() + "\n" + "\n".join(
        f"seed {r.seed}: {r.error}" for r in report.failures
    )


# ------------------------------------ window 2: Write1 → reclaim → Write2


def _reclaim_case():
    """The grant-TTL window over real DataStores (no sockets): a slow
    writer assembles a full certificate, stalls past the TTL mid-Write2
    while a contender's conflicting Write1 reclaims the aged slots on every
    store, then commits.  Invariants: the self-certifying certificate still
    applies everywhere, the reclaim ledger pins the ORIGINAL grantee's
    hash, and the contender's replacement grants sit strictly above the
    reclaimed slot."""
    from mochi_tpu_torch.cluster import ClusterConfig
    from mochi_tpu_torch.protocol import (
        Action,
        Operation,
        Transaction,
        Write1OkFromServer,
        Write1ToServer,
        Write2AnsFromServer,
        Write2ToServer,
        WriteCertificate,
        transaction_hash,
    )
    from mochi_tpu_torch.server.store import DataStore

    async def case():
        cfg = ClusterConfig.build(
            {f"server-{i}": f"127.0.0.1:{8001 + i}" for i in range(4)}, rf=4
        )
        stores = [DataStore(f"server-{i}", cfg) for i in range(4)]
        key, seed_ts = "hotk", 41
        txn = Transaction((Operation(Action.WRITE, key, b"slow-v"),))
        blind = Transaction((Operation(Action.WRITE, key, None),))
        slow_hash = transaction_hash(txn)
        w1 = Write1ToServer("client-slow", blind, seed_ts, slow_hash)
        grants = {}
        for s in stores:
            r = s.process_write1(w1)
            assert isinstance(r, Write1OkFromServer)
            grants[r.multi_grant.server_id] = r.multi_grant
            await asyncio.sleep(0)  # yield: let schedules interleave
        wc = WriteCertificate(grants)
        granted_ts = next(iter(grants.values())).grants[key].timestamp

        async def contender():
            # stalls past the TTL, then collides with the aged slots
            await asyncio.sleep(0.22)
            c_txn = Transaction((Operation(Action.WRITE, key, b"contend"),))
            c_blind = Transaction((Operation(Action.WRITE, key, None),))
            c_w1 = Write1ToServer(
                "client-b", c_blind, seed_ts, transaction_hash(c_txn)
            )
            for s in stores:
                r = s.process_write1(c_w1)
                if isinstance(r, Write1OkFromServer):
                    # replacement grant strictly above the reclaimed slot
                    assert r.multi_grant.grants[key].timestamp > granted_ts
                await asyncio.sleep(0)

        async def slow_write2():
            await asyncio.sleep(0.45)  # mid-Write2 stall past the TTL
            for s in stores:
                ans = s.process_write2(Write2ToServer(wc, txn))
                assert isinstance(ans, Write2AnsFromServer), ans
                assert ans.result.operations[0].status.name == "OK"
                await asyncio.sleep(0)

        await asyncio.gather(contender(), slow_write2())
        reclaims = sum(s.reclaims for s in stores)
        assert reclaims > 0, "the race never happened — nothing was reclaimed"
        for s in stores:
            # acked write survives reclamation on every store...
            assert s.data[key].value == b"slow-v"
            # ...and every reclaimed slot remembers the ORIGINAL grantee
            for (k, ts), h in s.reclaimed.items():
                if k == key and ts == granted_ts:
                    assert h == slow_hash

    return case


def test_grant_reclaim_window_single_seed(grant_ttl_200ms):
    result = schedule.run_case(_reclaim_case(), seed=7, timeout_s=60)
    assert result.ok, result.error


@pytest.mark.slow
def test_explore_grant_reclaim_window(grant_ttl_200ms):
    report = schedule.explore(
        _reclaim_case(), seeds=schedule.exploration_seeds(), timeout_s=120
    )
    assert report.ok, report.summary() + "\n" + "\n".join(
        f"seed {r.seed}: {r.error}" for r in report.failures
    )


@pytest.fixture
def grant_ttl_200ms():
    from mochi_tpu_torch.server import store as store_mod

    saved = store_mod.GRANT_TTL_MS
    store_mod.GRANT_TTL_MS = 200.0
    try:
        yield
    finally:
        store_mod.GRANT_TTL_MS = saved


# ------------------------------------------------ against the JAX package


def _labels(trace):
    return [t.replace("mochi_tpu_torch", "mochi_tpu") for t in trace]


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_explorer_traces_equal_the_reference(seed):
    """The same socket-free workloads on each package's ExplorerLoop give
    the same traces, label for label (package prefix mapped), and the same
    verdicts: the planted race fails or passes at the same seeds, and the
    session-eviction window runs each package's own replica."""
    from mochi_tpu.testing import schedule as ref_schedule

    ours = schedule.run_case(_workload_case, seed=seed)
    theirs = ref_schedule.run_case(_workload_case, seed=seed)
    assert ours.ok and theirs.ok
    assert _labels(ours.trace) == theirs.trace and len(ours.trace) > 10
    ours = schedule.run_case(_planted_case, seed=seed)
    theirs = ref_schedule.run_case(_planted_case, seed=seed)
    assert ours.error == theirs.error
    assert _labels(ours.trace) == theirs.trace
    ours = schedule.run_case(_session_case(), seed=seed)
    theirs = ref_schedule.run_case(_session_case(pkg="mochi_tpu"), seed=seed)
    assert ours.ok and theirs.ok, (ours.error, theirs.error)
    assert _labels(ours.trace) == theirs.trace
