"""The port's wire-level Byzantine cases (``mochi_tpu_torch``) on the CPU.

Ported from the JAX package's ``tests/test_byzantine.py``: forged,
tampered and replayed grants and certificates, tampered client envelopes,
unknown clients, response impersonation, the durable client registry, an
equivocating server that cannot flip a commit, and a restart storm under
load, every cluster on the CPU verifier.  Added: the port's strategy
catalogs and ``make_strategy``'s refusals equal the reference's, and every
strategy's ``mutate`` output for a seed, encoded by each package's codec, is
byte-equal between the packages.
"""

import asyncio
import importlib
from dataclasses import replace

import pytest

from mochi_tpu_torch.client import TransactionBuilder
from mochi_tpu_torch.crypto import generate_keypair
from mochi_tpu_torch.protocol import (
    Envelope,
    FailType,
    HelloToServer,
    MultiGrant,
    RequestFailedFromServer,
    Write1OkFromServer,
    Write1ToServer,
    Write2AnsFromServer,
    Write2ToServer,
    WriteCertificate,
    transaction_hash,
)
from mochi_tpu_torch.testing import VirtualCluster


def run(coro):
    asyncio.run(asyncio.wait_for(coro, timeout=60))


async def write1_via_wire(vc, client, txn, seed=77):
    """Collect signed MultiGrants from every replica over the wire."""
    blind = client._write1_transaction(txn)
    grants = {}
    for sid, info in sorted(vc.config.servers.items()):
        env = client._envelope(
            Write1ToServer(client.client_id, blind, seed, transaction_hash(txn)), f"w1-{sid}"
        )
        resp = await client.pool.send_and_receive(info, env)
        assert isinstance(resp.payload, Write1OkFromServer)
        grants[sid] = resp.payload.multi_grant
    return grants


def test_forged_multigrant_dropped_but_honest_quorum_commits():
    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            txn = TransactionBuilder().write("k", b"honest").build()
            grants = await write1_via_wire(vc, client, txn)

            # Attacker replaces one server's grant with a forgery "signed" by
            # a key the attacker controls.
            attacker = generate_keypair()
            victim = "server-1"
            forged = replace(grants[victim], signature=None)
            forged = forged.with_signature(attacker.sign(forged.signing_bytes()))
            wc = WriteCertificate({**grants, victim: forged})

            env = client._envelope(Write2ToServer(wc, txn), "w2-forged")
            resp = await client.pool.send_and_receive(
                vc.config.servers["server-0"], env
            )
            # 3 honest grants remain = quorum for rf=4 → commit succeeds
            assert isinstance(resp.payload, Write2AnsFromServer)
            assert resp.payload.result.operations[0].value == b"honest"
            # and the forged grant was detected and dropped
            assert vc.replicas[0].metrics.counters.get("replica.dropped-grants", 0) == 1

    run(main())


def test_certificate_below_quorum_after_forgeries_rejected():
    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            txn = TransactionBuilder().write("k", b"v").build()
            grants = await write1_via_wire(vc, client, txn)

            attacker = generate_keypair()
            wc_grants = dict(grants)
            for victim in ("server-1", "server-2"):  # forge 2 of 4 → only 2 honest < quorum 3
                forged = replace(wc_grants[victim], signature=None)
                wc_grants[victim] = forged.with_signature(
                    attacker.sign(forged.signing_bytes())
                )
            env = client._envelope(
                Write2ToServer(WriteCertificate(wc_grants), txn), "w2-thin"
            )
            resp = await client.pool.send_and_receive(vc.config.servers["server-0"], env)
            assert isinstance(resp.payload, RequestFailedFromServer)
            assert resp.payload.fail_type == FailType.BAD_CERTIFICATE

    run(main())


def test_tampered_multigrant_content_rejected():
    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            txn = TransactionBuilder().write("k", b"v").build()
            grants = await write1_via_wire(vc, client, txn)
            # Tamper with a signed grant's timestamp without re-signing: the
            # signature no longer covers the content.
            victim = "server-2"
            mg = grants[victim]
            bad = MultiGrant(
                grants={
                    k: replace(g, timestamp=g.timestamp + 5) for k, g in mg.grants.items()
                },
                client_id=mg.client_id,
                server_id=mg.server_id,
                signature=mg.signature,
            )
            wc = WriteCertificate({**grants, victim: bad})
            env = client._envelope(Write2ToServer(wc, txn), "w2-tamper")
            resp = await client.pool.send_and_receive(vc.config.servers["server-0"], env)
            # Tampered grant dropped; remaining 3 honest grants still commit.
            assert isinstance(resp.payload, Write2AnsFromServer)

    run(main())


def test_client_envelope_tampering_rejected_when_auth_required():
    async def main():
        async with VirtualCluster(4, rf=4, require_client_auth=True) as vc:
            client = vc.client()
            # Legitimate signed request works.
            ok = await client.execute_write_transaction(
                TransactionBuilder().write("k", b"v").build()
            )
            assert ok.operations[0].value == b"v"

            # Tampered envelope: signature is over different content.
            env = client._envelope(HelloToServer("legit"), "m-legit")
            tampered = replace(env, payload=HelloToServer("evil"))
            resp = await client.pool.send_and_receive(
                vc.config.servers["server-0"], tampered
            )
            assert isinstance(resp.payload, RequestFailedFromServer)
            assert resp.payload.fail_type == FailType.BAD_SIGNATURE

    run(main())


def test_unknown_client_rejected_when_auth_required():
    async def main():
        async with VirtualCluster(4, rf=4, require_client_auth=True) as vc:
            legit = vc.client()  # registers its key
            # A client whose key is NOT registered:
            rogue = legit.__class__(config=vc.config)
            try:
                env = rogue._envelope(HelloToServer("hi"), "m-rogue")
                resp = await rogue.pool.send_and_receive(
                    vc.config.servers["server-0"], env
                )
                assert isinstance(resp.payload, RequestFailedFromServer)
                assert resp.payload.fail_type == FailType.BAD_SIGNATURE
            finally:
                await rogue.close()

    run(main())


def test_response_impersonation_dropped_by_client():
    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            # A response claiming to be server-0 but signed by an attacker key
            # must not count toward quorums.
            attacker = generate_keypair()
            env = Envelope(HelloToServer("x"), "m1", "server-0", reply_to="m0")
            env = env.with_signature(attacker.sign(env.signing_bytes()))
            assert not client._authentic("server-0", env)

    run(main())


def test_durable_client_registry_enables_auth():
    """An unregistered client is rejected under require_client_auth; after
    an admin commits its key to _CONFIG_CLIENT_<id>, it can transact (the
    deployable path for the secure posture)."""

    async def main():
        async with VirtualCluster(4, rf=4, require_client_auth=True) as vc:
            admin = vc.client()  # registered via the in-memory test registry
            from mochi_tpu_torch.client.client import MochiDBClient

            outsider = MochiDBClient(config=vc.config)
            try:
                try:
                    await outsider.execute_write_transaction(
                        TransactionBuilder().write("ok", b"v").build()
                    )
                    raise AssertionError("unregistered client should fail")
                except AssertionError:
                    raise
                except Exception:
                    pass

                await admin.register_client_key(
                    outsider.client_id, outsider.keypair.public_key
                )
                await outsider.execute_write_transaction(
                    TransactionBuilder().write("ok", b"v").build()
                )
                res = await outsider.execute_read_transaction(
                    TransactionBuilder().read("ok").build()
                )
                assert res.operations[0].value == b"v"
            finally:
                await outsider.close()

    run(main())


def test_certificate_replay_against_different_transaction():
    """A committed certificate replayed with a
    DIFFERENT transaction must fail the per-grant transaction-hash check
    (the reference's check at ``InMemoryDataStore.java:580,591``)."""

    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            txn1 = TransactionBuilder().write("rk", b"legit").build()
            grants = await write1_via_wire(vc, client, txn1)
            wc = WriteCertificate(grants)
            for sid, info in sorted(vc.config.servers.items()):
                env = client._envelope(Write2ToServer(wc, txn1), f"w2-legit-{sid}")
                resp = await client.pool.send_and_receive(info, env)
                assert isinstance(resp.payload, Write2AnsFromServer)

            # Replay the SAME (validly signed) certificate with another txn.
            txn2 = TransactionBuilder().write("rk", b"evil").build()
            env = client._envelope(Write2ToServer(wc, txn2), "w2-replay")
            resp = await client.pool.send_and_receive(vc.config.servers["server-0"], env)
            assert isinstance(resp.payload, RequestFailedFromServer)
            assert resp.payload.fail_type == FailType.BAD_CERTIFICATE
            # and the value is untouched
            r = await client.execute_read_transaction(
                TransactionBuilder().read("rk").build()
            )
            assert r.operations[0].value == b"legit"

    run(main())


def test_equivocating_server_cannot_flip_a_commit():
    """One in-set server (<= f) signs a CONFLICTING
    grant — same key, same timestamp, different transaction — for a second
    client.  The equivocation is validly signed, but a single equivocator
    can never assemble 2f+1 grants for the conflicting transaction, so the
    honest commit stands."""

    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            txn1 = TransactionBuilder().write("eq", b"honest").build()
            grants = await write1_via_wire(vc, client, txn1, seed=123)
            ts = next(iter(grants["server-1"].grants.values())).timestamp

            # commit txn1 with the full honest certificate on every replica
            for sid, info in sorted(vc.config.servers.items()):
                env = client._envelope(
                    Write2ToServer(WriteCertificate(grants), txn1), f"w2-h-{sid}"
                )
                resp = await client.pool.send_and_receive(info, env)
                assert isinstance(resp.payload, Write2AnsFromServer)

            # server-1 equivocates: signs a grant for txn2 at the SAME ts
            # (we have its real key — VirtualCluster exposes keypairs)
            txn2 = TransactionBuilder().write("eq", b"evil").build()
            from mochi_tpu_torch.protocol import Grant, Status

            evil_grant = Grant("eq", ts, vc.config.configstamp, transaction_hash(txn2), Status.OK)
            evil_mg = MultiGrant({"eq": evil_grant}, client.client_id, "server-1")
            evil_mg = evil_mg.with_signature(
                vc.keypairs["server-1"].sign(evil_mg.signing_bytes())
            )
            thin_wc = WriteCertificate({"server-1": evil_mg})
            env = client._envelope(Write2ToServer(thin_wc, txn2), "w2-eq")
            resp = await client.pool.send_and_receive(vc.config.servers["server-0"], env)
            # validly signed but 1 < quorum 3 → rejected
            assert isinstance(resp.payload, RequestFailedFromServer)
            assert resp.payload.fail_type == FailType.BAD_CERTIFICATE
            r = await client.execute_read_transaction(
                TransactionBuilder().read("eq").build()
            )
            assert r.operations[0].value == b"honest"

    run(main())


def test_restart_storm_with_resync_under_load():
    """f+1 simultaneous restarts while writers keep
    running; restarted replicas resync and the cluster converges with no
    inconsistency."""

    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            client = vc.client()
            committed = {}

            async def writer(tag: str, n: int):
                c = vc.client()
                for i in range(n):
                    key = f"storm-{tag}-{i}"
                    val = b"v-" + tag.encode() + b"-%d" % i
                    try:
                        await c.execute_write_transaction(
                            TransactionBuilder().write(key, val).build()
                        )
                        committed[key] = val
                    except Exception:
                        pass  # transient quorum loss during the storm is legal
                await c.close()

            async def storm():
                await asyncio.sleep(0.05)
                # f+1 = 2 simultaneous restarts, resync on boot
                await asyncio.gather(
                    vc.restart_replica("server-1", resync=True),
                    vc.restart_replica("server-2", resync=True),
                )

            await asyncio.gather(writer("a", 15), writer("b", 15), storm())
            assert committed, "no write survived the storm"

            # everything acknowledged must read back consistently
            for key, val in committed.items():
                r = await client.execute_read_transaction(
                    TransactionBuilder().read(key).build()
                )
                assert r.operations[0].value == val, key

            # restarted replicas hold resynced state for acknowledged keys
            fresh = vc.replica("server-1")
            owned = [k for k in committed if fresh.store.owns(k)]
            have = sum(
                1
                for k in owned
                if (sv := fresh.store._get(k)) is not None and sv.current_certificate
            )
            assert owned and have >= len(owned) // 2, (have, len(owned))

    run(main())


# ------------------------------------------------ against the JAX package

_PKGS = ("mochi_tpu", "mochi_tpu_torch")


def test_strategy_catalogs_and_refusals_equal_the_reference():
    ref = importlib.import_module("mochi_tpu.testing.byzantine")
    ours = importlib.import_module("mochi_tpu_torch.testing.byzantine")
    ref_c = importlib.import_module("mochi_tpu.testing.byzantine_client")
    ours_c = importlib.import_module("mochi_tpu_torch.testing.byzantine_client")
    assert ours.STRATEGIES == ref.STRATEGIES
    assert ours_c.CLIENT_STRATEGIES == ref_c.CLIENT_STRATEGIES
    for name in ours.STRATEGIES + ("honest",):
        a, b = ref.make_strategy(name, seed=3), ours.make_strategy(name, seed=3)
        assert (type(a).__name__, a.name) == (type(b).__name__, b.name)
        assert a.rng.random() == b.rng.random()  # the same seeded stream
    inst = ours.make_strategy("silent")
    assert ours.make_strategy(inst) is inst  # an instance passes through
    for bad in ("", "Silent", "equivocate ", "nope", "withhold"):
        with pytest.raises(ValueError) as theirs_exc:
            ref.make_strategy(bad)
        with pytest.raises(ValueError) as ours_exc:
            ours.make_strategy(bad)
        assert str(ours_exc.value) == str(theirs_exc.value)
    for bad in ("equivocate", "", "wedge"):
        with pytest.raises(ValueError) as theirs_exc:
            ref_c.ByzantineClient(object(), bad)
        with pytest.raises(ValueError) as ours_exc:
            ours_c.ByzantineClient(object(), bad)
        assert str(ours_exc.value) == str(theirs_exc.value)


class _Bound:
    """What a strategy's ``mutate`` reads of its replica: the key it
    re-signs with."""

    def __init__(self, keypair):
        self.keypair = keypair


def _mutations(pkg: str, strategy: str, seed: int):
    """``wants`` and the encoded ``mutate`` output of one strategy over a
    fixed set of (request, honest answer) pairs, three passes (the seeded
    strategies draw on every pass), built with ``pkg``'s own protocol, keys
    and codec."""
    P = importlib.import_module(f"{pkg}.protocol")
    K = importlib.import_module(f"{pkg}.crypto.keys")
    B = importlib.import_module(f"{pkg}.testing.byzantine")
    kp = K.keypair_from_seed(bytes(range(32)))
    strat = B.make_strategy(strategy, seed=seed)
    strat.bind(_Bound(kp))

    def signed(grants):
        mg = P.MultiGrant(grants, "client-1", "server-1")
        return mg.with_signature(kp.sign(mg.signing_bytes()))

    txn = P.Transaction((P.Operation(P.Action.WRITE, "bk", b"value"),))
    h = P.transaction_hash(txn)
    blind = P.Transaction((P.Operation(P.Action.WRITE, "bk", None),))
    ok_mg = signed({"bk": P.Grant("bk", 5077, 1, h, P.Status.OK)})
    refused_mg = signed({"bk": P.Grant("bk", 5077, 1, b"\x11" * 64, P.Status.REFUSED)})
    cert = P.WriteCertificate({"server-1": ok_mg})
    w1 = P.Envelope(P.Write1ToServer("client-1", blind, 77, h), "m-w1", "client-1")
    read = P.Envelope(
        P.ReadToServer("client-1", P.Transaction((P.Operation(P.Action.READ, "bk"),)), "n1"),
        "m-r", "client-1",
    )
    w2 = P.Envelope(P.Write2ToServer(cert, txn), "m-w2", "client-1")
    sync = P.Envelope(P.SyncRequestToServer(("bk",)), "m-s", "server-2")

    def answer(value):
        return P.TransactionResult((P.OperationResult(value, cert, True),))

    pairs = [
        (w1, P.Write1OkFromServer(ok_mg, {})),
        (w1, P.Write1RefusedFromServer(refused_mg, {}, "client-1")),
        (read, P.ReadFromServer(answer(b"value"), "n1", "r1")),
        (read, P.ReadFromServer(answer(b"newer"), "n2", "r2")),
        (w2, P.Write2AnsFromServer(answer(b"value"), "r3")),
        (sync, P.SyncEntriesFromServer((P.SyncEntry("bk", txn, cert),))),
    ]
    out = []
    for _ in range(3):
        for env, payload in pairs:
            mutated = strat.mutate(env, payload)
            out.append((
                strat.wants(env),
                mutated is payload,
                None if mutated is None else P.encode_envelope(
                    P.Envelope(mutated, "m-out", "server-1", reply_to=env.msg_id)
                ),
            ))
    return out


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize(
    "strategy",
    ["honest", "silent", "equivocate", "forge-cert", "stale-replay", "storm", "session-attack"],
)
def test_strategy_mutations_equal_the_reference(strategy, seed):
    """Each strategy's lie for a seed, encoded by each package's codec, is
    byte-equal between the packages (re-signed grants included: Ed25519
    signatures are deterministic)."""
    theirs, ours = (_mutations(pkg, strategy, seed) for pkg in _PKGS)
    assert ours == theirs
    changed = sum(not same for _, same, _ in ours)
    if strategy in ("honest", "silent", "session-attack"):
        assert changed == 0
    else:
        assert changed > 0, "the strategy lied about nothing"
    assert all(w is (strategy != "silent") for w, _, _ in ours)
