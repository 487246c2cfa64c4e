"""Live adversaries in the port's serving path (``testing/byzantine.py``) on
the CPU.

Ported from the JAX package's ``tests/test_byzantine_live.py``: a
ByzantineReplica SERVING inside a cluster (silent, equivocate, forge-cert,
stale-replay, storm under a partition, colluding replicas at rf = 7), the
invariant checker held while it misbehaves and shown non-vacuous past the
fault bound, the cross-process posture through ``ProcessCluster(byzantine=)``
and the server's ``--byzantine``, and the session-attack probes.  Every
cluster runs the CPU verifier; the admin shells are the port's.
"""

import asyncio

import pytest

from mochi_tpu_torch.client import TransactionBuilder
from mochi_tpu_torch.protocol import (
    FailType,
    RequestFailedFromServer,
    Write1OkFromServer,
    Write1ToServer,
    Write2ToServer,
    WriteCertificate,
    transaction_hash,
)
from mochi_tpu_torch.testing import InvariantChecker, VirtualCluster


def run(coro):
    asyncio.run(asyncio.wait_for(coro, timeout=120))


async def _workload(vc, checker, client, keys=4, sweeps=2, prefix="lk"):
    """Writes + read-backs with every ack recorded into the checker."""
    for s in range(sweeps):
        for k in range(keys):
            key = f"{prefix}-{k}"
            val = b"v%d" % s
            await client.execute_write_transaction(
                TransactionBuilder().write(key, val).build()
            )
            checker.record_ack(key, val)


def test_silent_replica_straggler_observability():
    """Satellite: under the silent attack every commit rides the
    early-quorum straggler path — fanout.straggler-timeout.<sid> counters
    must accrue on the client, and the ClientAdminServer fan-out table
    must carry a per-peer suspicion row for the silent replica."""

    async def main():
        async with VirtualCluster(5, rf=4, byzantine={"server-1": "silent"}) as vc:
            checker = InvariantChecker(vc.honest_replicas(), ["server-1"])
            checker.start(0.02)
            client = vc.client(timeout_s=1.0)
            await _workload(vc, checker, client, keys=4, sweeps=2)
            await checker.final_check(client)
            await checker.stop()
            assert checker.ok, checker.report()["violations"]
            # the straggler drain convicted the silent replica
            timeouts = client.metrics.counters.get(
                "fanout.straggler-timeout.server-1", 0
            )
            assert timeouts > 0, dict(client.metrics.counters)
            # ... and the client admin shell surfaces it as a per-peer row
            from mochi_tpu_torch.admin import ClientAdminServer

            shell = ClientAdminServer(client)
            await shell.start()
            try:
                status, _, body = shell._route("/status")
                assert status == 200
                import json

                doc = json.loads(body)
                peer = doc["fanout"]["peers"]["server-1"]
                assert peer["straggler_timeout"] == timeouts
                _, _, page = shell._route("/")
                assert "server-1" in page and "straggler_timeout" in page
            finally:
                await shell.close()

    run(main())


def test_silent_replica_suspicion_redirects_trimmed_reads():
    """After the silent replica's suspicion score crosses the threshold,
    the trimmed read fan-out stops choosing it — reads no longer pay a
    timeout + full-union retry per trim that includes the mute peer."""

    async def main():
        async with VirtualCluster(5, rf=4, byzantine={"server-1": "silent"}) as vc:
            client = vc.client(timeout_s=0.5)
            for k in range(3):
                await client.execute_write_transaction(
                    TransactionBuilder().write(f"sr-{k}", b"v").build()
                )
            # force the suspicion score past the threshold (the drain's
            # timeout marks land ~timeout_s after each early return)
            await asyncio.sleep(0.8)
            assert client._suspicion_score("server-1") > 2
            for k in range(3):
                targets = client._quorum_targets(
                    TransactionBuilder().read(f"sr-{k}").build()
                )
                assert "server-1" not in [sid for sid, _ in targets], targets

    run(main())


def test_equivocation_detected_on_honest_replicas():
    """A live equivocator (refusal flipped to a conflicting OK grant at
    the same timestamp) is CONVICTED once both validly-signed sides are
    presented: the grant ledger counts it, /status carries it, and the
    prom exposition grows a mochi_byzantine sample."""

    async def main():
        async with VirtualCluster(4, rf=4, byzantine={"server-1": "equivocate"}) as vc:
            client = vc.client()
            txn_a = TransactionBuilder().write("eq", b"A").build()
            txn_b = TransactionBuilder().write("eq", b"B").build()
            byz = vc.config.servers["server-1"]
            grants = []
            for i, txn in enumerate((txn_a, txn_b)):
                blind = client._write1_transaction(txn)
                env = client._envelope(
                    Write1ToServer(
                        client.client_id, blind, 77, transaction_hash(txn)
                    ),
                    f"w1-{i}",
                )
                resp = await client.pool.send_and_receive(byz, env)
                # honest behavior would REFUSE the second; the equivocator
                # grants both at the same timestamp
                assert isinstance(resp.payload, Write1OkFromServer), resp.payload
                grants.append(resp.payload.multi_grant)
            ts = [next(iter(mg.grants.values())).timestamp for mg in grants]
            assert ts[0] == ts[1], ts

            honest = vc.config.servers["server-0"]
            for i, (txn, mg) in enumerate(zip((txn_a, txn_b), grants)):
                env = client._envelope(
                    Write2ToServer(WriteCertificate({"server-1": mg}), txn),
                    f"w2-{i}",
                )
                await client.pool.send_and_receive(honest, env)
            replica = vc.replica("server-0")
            assert replica.byzantine_stats()["equivocations"].get("server-1", 0) >= 1

            from mochi_tpu_torch.admin import AdminServer

            shell = AdminServer(replica)
            await shell.start()
            try:
                import json

                _, _, body = shell._route("/status")
                assert json.loads(body)["byzantine"]["equivocations"]["server-1"] >= 1
                _, _, prom = shell._route("/metrics.prom")
                assert 'mochi_byzantine{peer="server-1",stat="equivocations"' in prom
            finally:
                await shell.close()

    run(main())


def test_forged_grants_filtered_and_writes_survive():
    """forge-cert: garbage grant signatures + wrong hashes from one in-set
    replica.  Client-side grant validation must keep them out of every
    certificate (writes succeed without a BAD_CERTIFICATE round trip) and
    attribute the suspicion; read tallies outvote the forged values."""

    async def main():
        async with VirtualCluster(5, rf=4, byzantine={"server-1": "forge-cert"}) as vc:
            checker = InvariantChecker(vc.honest_replicas(), ["server-1"])
            checker.start(0.02)
            client = vc.client(timeout_s=2.0)
            await _workload(vc, checker, client, keys=4, sweeps=2, prefix="fg")
            for k in range(4):
                res = await client.execute_read_transaction(
                    TransactionBuilder().read(f"fg-{k}").build()
                )
                assert res.operations[0].value == b"v1"
            await checker.final_check(client)
            await checker.stop()
            assert checker.ok, checker.report()["violations"]
            sus = client.suspicion_stats().get("server-1", {})
            assert sus.get("bad-grant", 0) > 0, sus

    run(main())


def test_stale_replay_live_invariants_hold():
    """stale-replay: epoch-reset grants + stale read answers from a live
    replica.  The grant subset drops the stale timestamps (suspicion:
    grant-conflict), quorum reads outvote the stale values, and epochs on
    HONEST replicas never regress."""

    async def main():
        async with VirtualCluster(5, rf=4, byzantine={"server-1": "stale-replay"}) as vc:
            checker = InvariantChecker(vc.honest_replicas(), ["server-1"])
            checker.start(0.02)
            client = vc.client(timeout_s=2.0)
            await _workload(vc, checker, client, keys=4, sweeps=3, prefix="st")
            await checker.final_check(client)
            await checker.stop()
            assert checker.ok, checker.report()["violations"]
            sus = client.suspicion_stats().get("server-1", {})
            assert sus.get("grant-conflict", 0) > 0, sus

    run(main())


@pytest.mark.slow
def test_storm_under_partition_invariants_hold():
    """storm + netsim partition of an honest replica: adversarial Write1
    refusals, nudge floods, and a transient quorum dip — every ack taken
    during the churn must survive it."""

    async def main():
        from mochi_tpu_torch.netsim import NetSim

        sim = NetSim.mesh(seed=8, rtt_ms=4.0, jitter_ms=0.5)
        async with VirtualCluster(
            5, rf=4, netsim=sim, byzantine={"server-1": "storm"}
        ) as vc:
            checker = InvariantChecker(vc.honest_replicas(), ["server-1"])
            checker.start(0.02)
            client = vc.client(timeout_s=2.0)

            async def churn():
                await asyncio.sleep(0.15)
                for ev in NetSim.partition("server-3", 0.0):
                    sim.apply_event(ev)
                await asyncio.sleep(0.5)
                for ev in NetSim.heal("server-3"):
                    sim.apply_event(ev)

            task = asyncio.ensure_future(churn())
            await _workload(vc, checker, client, keys=3, sweeps=4, prefix="sp")
            await task
            await checker.final_check(client)
            await checker.stop()
            assert checker.ok, checker.report()["violations"]

    run(main())


def test_invariant_checker_is_not_vacuous():
    """The checker must actually catch violations: regress an honest
    replica's store by hand (epoch rollback + conflicting commit at an
    already-committed timestamp) and demand both invariants fire."""

    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            checker = InvariantChecker(vc.replicas)
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("nv", b"v0").build()
            )
            checker.check_now()
            assert checker.ok
            replica = vc.replicas[0]
            sv = replica.store._get("nv")
            assert sv is not None and sv.current_certificate is not None
            # epoch regression
            sv.current_epoch = 0
            checker.check_now()
            # conflicting commit: same certificate timestamps, different txn
            sv.last_transaction = TransactionBuilder().write("nv", b"evil").build()
            checker.check_now()
            report = checker.report()
            assert not report["ok"]
            kinds = " ".join(report["violations"])
            assert "regression" in kinds and "conflicting commits" in kinds

    run(main())


def test_colluding_replicas_rf7_f2_invariants_hold():
    """Colluding adversaries WITHIN the fault bound at larger rf: rf=7 →
    f=2, quorum=5, with two coordinated attackers (an equivocator and a
    cert-forger) serving live traffic.  Writes must converge through the
    5 honest replicas, forged grants must be filtered client-side, and
    every safety invariant must hold at f=2."""

    async def main():
        async with VirtualCluster(
            7,
            rf=7,
            byzantine={"server-1": "equivocate", "server-2": "forge-cert"},
        ) as vc:
            assert vc.config.f == 2 and vc.config.quorum == 5
            checker = InvariantChecker(
                vc.honest_replicas(), ["server-1", "server-2"]
            )
            checker.start(0.02)
            client = vc.client(timeout_s=2.0)
            await _workload(vc, checker, client, keys=4, sweeps=2, prefix="f2")
            for k in range(4):
                res = await client.execute_read_transaction(
                    TransactionBuilder().read(f"f2-{k}").build()
                )
                assert res.operations[0].value == b"v1"
            await checker.final_check(client)
            await checker.stop()
            assert checker.ok, checker.report()["violations"]
            # the forger's garbage grants were filtered and attributed
            sus = client.suspicion_stats().get("server-2", {})
            assert sus.get("bad-grant", 0) > 0, client.suspicion_stats()

    run(main())


def test_checker_convicts_when_fault_bound_exceeded_f3():
    """Checker non-vacuity AT SCALE: with f+1=3 colluding equivocators in
    an rf=7 (f=2) cluster, two conflicting transactions can each assemble
    a legitimate-looking 5-grant certificate for the SAME (key, ts) slot
    — 2 honest grants + 3 equivocated each — and commit on disjoint
    honest replicas.  Safety is genuinely violated, and the
    InvariantChecker must say so (a checker that stays green past the
    fault bound proves nothing within it)."""

    async def main():
        byz_ids = ["server-1", "server-2", "server-6"]
        async with VirtualCluster(
            7, rf=7, byzantine={sid: "equivocate" for sid in byz_ids}
        ) as vc:
            client = vc.client(timeout_s=2.0)
            txn_a = TransactionBuilder().write("ovr", b"A").build()
            txn_b = TransactionBuilder().write("ovr", b"B").build()
            halves = {id(txn_a): ["server-0", "server-3"],
                      id(txn_b): ["server-4", "server-5"]}
            certs = {}
            for txn in (txn_a, txn_b):
                blind = client._write1_transaction(txn)
                grants = []
                for sid in halves[id(txn)] + byz_ids:
                    env = client._envelope(
                        Write1ToServer(
                            client.client_id, blind, 77, transaction_hash(txn)
                        ),
                        f"f3-w1-{sid}-{id(txn)}",
                    )
                    resp = await client.pool.send_and_receive(
                        vc.config.servers[sid], env
                    )
                    # honest replicas that never saw the other txn grant
                    # genuinely; the equivocators flip their refusals
                    assert isinstance(resp.payload, Write1OkFromServer), (
                        sid, resp.payload
                    )
                    grants.append(resp.payload.multi_grant)
                ts = {
                    mg.grants["ovr"].timestamp for mg in grants
                }
                assert len(ts) == 1, ts  # one slot, both transactions
                certs[id(txn)] = WriteCertificate(
                    {mg.server_id: mg for mg in grants}
                )
            checker = InvariantChecker(vc.honest_replicas(), byz_ids)
            # commit A on one honest pair, B on the other: disjoint honest
            # replicas now hold conflicting certificates for one slot
            for txn in (txn_a, txn_b):
                for sid in halves[id(txn)]:
                    env = client._envelope(
                        Write2ToServer(certs[id(txn)], txn),
                        f"f3-w2-{sid}-{id(txn)}",
                    )
                    await client.pool.send_and_receive(
                        vc.config.servers[sid], env
                    )
            checker.check_now()
            report = checker.report()
            assert not report["ok"], "checker vacuous past the fault bound"
            assert any("conflicting commits" in v for v in report["violations"])
            # presenting BOTH certificates to one honest replica also
            # convicts the equivocators cryptographically (grant ledger)
            for txn in (txn_a, txn_b):
                env = client._envelope(
                    Write2ToServer(certs[id(txn)], txn),
                    f"f3-ev-{id(txn)}",
                )
                await client.pool.send_and_receive(
                    vc.config.servers["server-0"], env
                )
            eq = vc.replica("server-0").byzantine_stats()["equivocations"]
            assert any(eq.get(sid, 0) >= 1 for sid in byz_ids), eq

    run(main())


def test_process_cluster_byzantine_silent_commits_cross_process():
    """ByzantineReplica across a REAL process boundary: ProcessCluster
    forwards --byzantine to the hosting child, the silent child answers
    nothing, and commits still land through the early-quorum path."""

    async def main():
        from mochi_tpu_torch.testing import ProcessCluster

        async with ProcessCluster(
            4, rf=4, n_processes=2, verifier="cpu", byzantine={"server-1": "silent"}
        ) as pc:
            client = pc.client(timeout_s=0.8)
            await client.execute_write_transaction(
                TransactionBuilder().write("pb", b"v").build()
            )
            res = await client.execute_read_transaction(
                TransactionBuilder().read("pb").build()
            )
            assert res.operations[0].value == b"v"
            # the straggler drain's timeout verdicts land ~timeout_s after
            # each early return — wait them out before asserting
            await asyncio.sleep(1.2)
            assert (
                client.metrics.counters.get("fanout.straggler-timeout.server-1", 0)
                + client.metrics.counters.get("suspect.no-response.server-1", 0)
                > 0
            ), dict(client.metrics.counters)

    run(main())


# ------------------------------------------------------- session fast path
# Fast-path downgrade/tamper probes (session-attack strategy): every attack
# on the MAC session machinery must end in a TYPED refusal or a conviction
# with flight-recorder evidence — never a silent fallback.


def test_session_attack_mac_tamper_typed_refusal_and_conviction(tmp_path):
    """MAC-window mutation: a sealed envelope whose payload was swapped
    after sealing gets a typed BAD_SIGNATURE, a mac-tamper conviction mark,
    and a flight-recorder dump naming the evidence."""

    async def main():
        async with VirtualCluster(
            4, rf=4, byzantine={"server-1": "session-attack"}
        ) as vc:
            victim = vc.replica("server-0")
            victim.tracer.flight_dir = str(tmp_path)
            strat = vc.replica("server-1").strategy
            res = await strat.tamper_mac_window("server-0")
            assert isinstance(res.payload, RequestFailedFromServer), res.payload
            assert res.payload.fail_type == FailType.BAD_SIGNATURE
            assert victim.metrics.counters.get("replica.mac-tamper", 0) >= 1
            dumps = list(tmp_path.glob("flight-*.json"))
            assert dumps, "conviction must leave flight-recorder evidence"
            assert any("mac-tamper" in p.read_text() for p in dumps)

    run(main())


def test_session_attack_replay_across_window_convicted(tmp_path):
    """Cross-checkpoint replay: one sealed envelope delivered twice but
    signed for once.  Both deliveries authenticate (the MAC is genuine);
    the signed transcript then under-covers the victim's ledger — a
    checkpoint-mismatch conviction, flight evidence, and the session
    drops on BOTH sides."""

    async def main():
        async with VirtualCluster(
            4, rf=4, byzantine={"server-1": "session-attack"}
        ) as vc:
            victim = vc.replica("server-0")
            victim.tracer.flight_dir = str(tmp_path)
            byz = vc.replica("server-1")
            first, second = await byz.strategy.replay_across_window("server-0")
            assert not isinstance(first.payload, RequestFailedFromServer)
            assert not isinstance(second.payload, RequestFailedFromServer)
            assert victim.metrics.counters.get(
                "replica.checkpoint-mismatch", 0
            ) >= 1
            # the refusal was typed back to the (Byzantine) sender, which
            # dropped its side of the session per the honest-sender contract
            assert byz.metrics.counters.get(
                "replica.peer-checkpoint-refused", 0
            ) >= 1
            assert "server-1" not in victim._sessions
            assert "server-0" not in byz._peer_sessions
            dumps = list(tmp_path.glob("flight-*.json"))
            assert any("checkpoint-mismatch" in p.read_text() for p in dumps)

    run(main())


def test_session_attack_downgrade_checkpoint_refused_typed(tmp_path):
    """Forced signature→MAC downgrade: a transcript declaration arriving
    under session MAC (forgeable by whoever holds the session key) must be
    refused typed (BAD_REQUEST, named detail) and convicted — the silent
    acceptance would void the whole retroactive-conviction design."""

    async def main():
        async with VirtualCluster(
            4, rf=4, byzantine={"server-1": "session-attack"}
        ) as vc:
            victim = vc.replica("server-0")
            victim.tracer.flight_dir = str(tmp_path)
            strat = vc.replica("server-1").strategy
            res = await strat.downgrade_checkpoint("server-0")
            assert isinstance(res.payload, RequestFailedFromServer), res.payload
            assert res.payload.fail_type == FailType.BAD_REQUEST
            assert "Ed25519-signed" in res.payload.detail
            assert victim.metrics.counters.get(
                "replica.checkpoint-downgrade", 0
            ) >= 1
            dumps = list(tmp_path.glob("flight-*.json"))
            assert any("checkpoint-downgrade" in p.read_text() for p in dumps)

    run(main())


def test_session_attack_overdue_flood_typed_policy_refusal(monkeypatch):
    """Riding the MAC discount without ever signing a declaration: past
    OVERDUE_FACTOR checkpoint windows the victim refuses typed
    (BAD_REQUEST policy refusal, not BAD_SIGNATURE — there is no forgery)
    and drops the session so the sender must re-handshake."""
    from mochi_tpu_torch.crypto import session as session_crypto

    monkeypatch.setattr(session_crypto, "CHECKPOINT_MSGS", 2)

    async def main():
        async with VirtualCluster(
            4, rf=4, byzantine={"server-1": "session-attack"}
        ) as vc:
            victim = vc.replica("server-0")
            strat = vc.replica("server-1").strategy
            # cap = OVERDUE_FACTOR (4) * CHECKPOINT_MSGS (2) = 8 accepted
            # MAC'd envelopes; the 9th is the policy refusal
            last = await strat.overdue_flood("server-0", n=9)
            assert isinstance(last.payload, RequestFailedFromServer), last.payload
            assert last.payload.fail_type == FailType.BAD_REQUEST
            assert "overdue" in last.payload.detail
            assert victim.metrics.counters.get(
                "replica.checkpoint-overdue", 0
            ) >= 1
            assert "server-1" not in victim._sessions

    run(main())
